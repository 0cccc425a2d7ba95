"""Client-side local fine-tuning (port of ``repro/federation/client.py``):
``train`` runs one client at its own rank (the sequential engine), and
``train_group_masked`` trains every sampled client of the batched round
at once (the reference's ``_masked_run_fn``).

All clients run at rank r_max with their adapter factors zero-masked
beyond their own rank r_k and their own ``lora_scale``. This is exact:
the masked slices contribute nothing to the forward, their gradients are
identically zero (each is a product with the other, zeroed, factor), and
AdamW leaves them exactly zero -- the zero-padded stack layout the
aggregation expects. The client axis is a batch dimension written out:
shared base weights, per-client adapter leaves (C, ...), one autograd pass
over the summed per-client losses per local step.

FFA-LoRA (``freeze_a``) zeroes the gradients of the model's ``lora_a``
before the AdamW update, in both steps, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lora import flatten, merge_lora, unflatten
from repro_torch.models.transformer import Model
from repro_torch.optim import AdamW


class LocalTrainer:
    def __init__(self, model: Model, *, weight_decay: float = 0.0,
                 freeze_a: bool = False):
        self.model = model
        self.opt = AdamW(weight_decay=weight_decay)
        self.freeze_a = freeze_a   # FFA-LoRA: train only the B factors

    def _grads(self, loss: torch.Tensor, leaves: Dict[tuple, torch.Tensor]
               ) -> Dict[tuple, torch.Tensor]:
        """{path: gradient}; with ``freeze_a`` the lora_a gradients are
        zeros (AdamW then moves lora_a only by its weight decay, as in the
        reference)."""
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if self.freeze_a:
            grads = {p: torch.zeros_like(g) if p[-1] == "lora_a" else g
                     for p, g in grads.items()}
        return grads

    def train(self, base: dict, global_lora: dict, rank: int,
              batches: Iterable[dict], lr: float) -> Tuple[dict, dict]:
        """One client's local steps at its own rank r_k: the forward slices
        the r_max-sized factors to r_k (``lora_rank``), so the slices beyond
        get no gradient. Returns (trained lora tree, last metrics)."""
        model = self.model
        scale = model.lora.scaling(int(rank))
        lora = flatten(global_lora)
        opt_state = self.opt.init(lora)
        metrics: dict = {}
        for batch in batches:
            leaves = {p: t.detach().requires_grad_(True)
                      for p, t in lora.items()}
            loss, metrics = model.train_loss(
                merge_lora(base, unflatten(leaves)), batch,
                lora_rank=int(rank), lora_scale=scale)
            lora, opt_state = self.opt.update(self._grads(loss, leaves),
                                              opt_state, lora, lr)
            metrics = {k: v.detach() for k, v in metrics.items()}
        return unflatten(lora), metrics

    def _tile_mask(self, global_lora: dict, mask: torch.Tensor
                   ) -> Dict[tuple, torch.Tensor]:
        """Tile the global adapters over the client axis and zero every
        client's factors beyond its rank: lora_a (C, ..., r_max, in) masks
        rows, lora_b (C, ..., out, r_max) masks columns."""
        size, r_max = mask.shape
        out = {}
        for path, x in flatten(global_lora).items():
            t = x[None].expand((size,) + tuple(x.shape))
            lead = (1,) * (x.ndim - 2)
            if path[-1] == "lora_a":
                t = t * mask.reshape((size,) + lead + (r_max, 1)).to(t.dtype)
            elif path[-1] == "lora_b":
                t = t * mask.reshape((size,) + lead + (1, r_max)).to(t.dtype)
            out[path] = t.contiguous()
        return out

    def train_group_masked(self, base: dict, global_lora: dict,
                           ranks: Sequence[int], batch_stacks: List[dict],
                           lr: float) -> Tuple[dict, dict]:
        """Train a mixed-rank client group.

        ``batch_stacks``: over local steps, batch dicts of tensors with a
        leading client axis of length ``len(ranks)``. Returns (lora tree
        with a leading client axis, last-step metrics of (C,) tensors)."""
        model = self.model
        device = model.device
        r_max = model.lora.r_max
        mask = torch.as_tensor(
            np.arange(r_max)[None, :] < np.asarray(ranks)[:, None],
            dtype=torch.float32, device=device)
        scales = torch.as_tensor(
            [model.lora.scaling(int(r)) for r in ranks],
            dtype=torch.float32, device=device)
        lora = self._tile_mask(global_lora, mask)
        opt_state = self.opt.init(lora, num_clients=len(ranks))
        metrics: dict = {}
        for batch in batch_stacks:
            leaves = {p: t.detach().requires_grad_(True)
                      for p, t in lora.items()}
            loss, metrics = model.train_loss_clients(
                base, unflatten(leaves), batch, scales)
            lora, opt_state = self.opt.update(
                self._grads(loss.sum(), leaves), opt_state, lora, lr)
            metrics = {k: v.detach() for k, v in metrics.items()}
        return unflatten(lora), metrics
