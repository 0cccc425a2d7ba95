"""The step functions (port of ``repro/launch/steps.py``): the client train
step (LoRA-only AdamW with gradient accumulation over microbatches), the
prefill step and the single-token serve step, with the reference's
signatures. Adapter trees are the port's nested dicts (``split_lora``);
``opt.init(lora)`` takes such a tree, as the reference's does."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core.lora import flatten, merge_lora, unflatten
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW, AdamWState
from repro_torch.serving.engine import greedy


class TreeAdamW(AdamW):
    """The port's AdamW with ``init`` over a nested adapter tree."""

    def init(self, lora: dict, num_clients: int = 0) -> AdamWState:
        return super().init(flatten(lora), num_clients)


def _split_microbatches(batch: dict, num: int) -> list:
    """The batch dim cut into ``num`` equal microbatches, in order."""
    return [{k: v.reshape((num, -1) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(num)]


def build_train_step(model: Model, lora_rank: int, *,
                     num_microbatches: int = 1,
                     weight_decay: float = 0.0) -> Tuple[Callable, TreeAdamW]:
    """((lora, opt_state, base, batch, lr) -> (lora, opt_state, metrics),
    opt). Gradients flow ONLY to the adapter leaves (factors and DoRA
    magnitudes: the paper's client step); with ``num_microbatches`` > 1
    the gradients and the loss are averaged over the microbatches, in
    f32, before one AdamW update."""
    opt = TreeAdamW(weight_decay=weight_decay)
    scale = model.lora.scaling(lora_rank) if model.lora is not None else 1.0

    def train_step(lora: dict, opt_state: AdamWState, base: dict,
                   batch: dict, lr: float):
        flat = flatten(lora)
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        grads = {p: torch.zeros(x.shape, dtype=torch.float32,
                                device=x.device) for p, x in flat.items()}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split_microbatches(batch, num_microbatches):
            leaves = {p: x.detach().requires_grad_(True)
                      for p, x in flat.items()}
            l_mb, _ = model.train_loss(merge_lora(base, unflatten(leaves)),
                                       mb, lora_rank=lora_rank,
                                       lora_scale=scale)
            for p, g in zip(leaves, torch.autograd.grad(
                    l_mb, list(leaves.values()))):
                grads[p] += g.float()
            loss = loss + l_mb.detach()
        inv = 1.0 / num_microbatches
        if num_microbatches > 1:
            grads = {p: g * inv for p, g in grads.items()}
            loss = loss * inv
        new_flat, opt_state = opt.update(grads, opt_state, flat, lr)
        return unflatten(new_flat), opt_state, {"loss": loss}

    return train_step, opt


def build_prefill_step(model: Model, lora_rank: int) -> Callable:
    """(params, batch) -> (logits, cache)."""
    def prefill_step(params: dict, batch: dict):
        return model.prefill(params, batch, lora_rank=lora_rank)
    return prefill_step


def build_serve_step(model: Model, lora_rank: int) -> Callable:
    """One decode step with the greedy next token (the serving engine's
    ``greedy``): (params, batch, cache) -> (next token (B,) int32, new
    cache)."""
    @torch.no_grad()
    def serve_step(params: dict, batch: dict, cache: dict):
        logits, new_cache = model.decode_step(params, batch, cache,
                                              lora_rank=lora_rank)
        return greedy(logits[:, -1, :]), new_cache
    return serve_step
