"""Mixture-of-experts FFN with a dropless sorted dispatch (port of
``repro/models/layers/moe.py``, its default ``"tp"`` path).

The router takes a softmax over the experts in f32 and keeps each token's
top-k, renormalised; tokens are replicated k times, stably sorted by
expert, run through their experts' FFNs one product per non-empty expert
(the counterpart of the reference's ``jax.lax.ragged_dot``), weighted and
scatter-added back to their tokens; the shared experts (one MLP of width
``shared_d_ff * num_shared_experts``, no adapter) add to every token.

Over the port's client axis the router statistics are per client: x is
(C, ..., d), and the Switch aux loss ``E * sum_e f_e p_e`` of client c
comes from its own tokens only, as the reference's per-client vmapped
step computes it. The dispatch runs over all C * N tokens at once (a
token's output depends on no other token).

The expert group sizes reach the host once a call (``moe_apply.host_syncs``
counts them): the per-expert products need their row counts. The expert
weights are base leaves and carry no adapter, as in the reference.

``moe_apply_dense`` runs every token through every expert, weighted by
its routing (zero off its top-k): a plain oracle for the tests, on no
path of the model.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers.dense import dense_init
from repro_torch.models.layers.mlp import _act, is_gated, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             activation: str, *, dtype=torch.float32, device=None) -> dict:
    """Router ``w`` (d, E) in f32 whatever ``dtype``; ``w_up``, ``w_gate``
    (E, d, ff) and ``w_down`` (E, ff, d) all ~ N(0, 1/d_model); the
    shared experts as one MLP without adapters."""
    e, ff = cfg.num_experts, cfg.expert_d_ff
    scale = d_model ** -0.5

    def w(shape):
        return torch.randn(shape, generator=gen, device=device).mul_(
            scale).to(dtype)
    params = {"router": dense_init(gen, d_model, e, dtype=torch.float32,
                                   device=device),
              "w_up": w((e, d_model, ff)),
              "w_down": w((e, ff, d_model))}
    if is_gated(activation):
        params["w_gate"] = w((e, d_model, ff))
    if cfg.num_shared_experts:
        params["shared"] = mlp_init(
            gen, d_model, (cfg.shared_d_ff or ff) * cfg.num_shared_experts,
            activation, lora_ranks={}, dtype=dtype, device=device)
    return params


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., N, E) logits -> (weights (..., N, k), experts (..., N, k),
    aux (...)): the aux loss over the N tokens of each leading index."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, experts = torch.topk(probs, top_k, dim=-1)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    fraction = F.one_hot(experts, e).float().sum(-2).mean(-2)   # (..., E)
    aux = e * torch.sum(fraction * probs.mean(-2), dim=-1)
    return weights, experts, aux


def _expert_ffn_sorted(tokens: torch.Tensor, group_sizes, params: dict,
                       activation: str) -> torch.Tensor:
    """tokens (Tk, d) sorted by expert, ``group_sizes`` the E row counts
    (host ints): one product a non-empty expert and weight. The groups
    are cut by one ``split``, whose backward concatenates their
    gradients (a slice's backward would add a zero-padded (Tk, d)
    gradient per expert)."""
    dt = tokens.dtype
    outs = []
    for e, x in enumerate(tokens.split(group_sizes)):
        if not x.shape[0]:
            continue
        up = x @ params["w_up"][e].to(dt)
        if "w_gate" in params:
            h = _act(activation, x @ params["w_gate"][e].to(dt)) * up
        else:
            h = _act(activation, up)
        outs.append(h @ params["w_down"][e].to(dt))
    return torch.cat(outs)


def _route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x (C, ..., d) -> (xt (C, N, d), weights, experts (C, N, k), aux
    (C,))."""
    xt = x.reshape(x.shape[0], -1, x.shape[-1])
    logits = xt.float() @ params["router"]["w"]
    return (xt,) + router_topk(logits, cfg.top_k)


def _shared(params: dict, xt: torch.Tensor, activation: str):
    if "shared" not in params:
        return 0.0
    return mlp_apply(params["shared"], xt, activation, lora_rank=0)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x (C, ..., d) -> (out like x, aux (C,)). No adapter
    reaches it (the reference's takes the LoRA arguments and ignores
    them)."""
    xt, weights, experts, aux = _route(params, x, cfg)
    d = xt.shape[-1]
    flat_x = xt.reshape(-1, d)
    t, k = flat_x.shape[0], cfg.top_k
    flat_expert = experts.reshape(-1)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    group_sizes = torch.bincount(flat_expert,
                                 minlength=cfg.num_experts).tolist()
    moe_apply.host_syncs += 1
    out_sorted = _expert_ffn_sorted(flat_x[token_idx[order]], group_sizes,
                                    params, activation)
    contrib = out_sorted * weights.reshape(-1)[order][:, None].to(
        out_sorted.dtype)
    combined = torch.zeros((t, d), dtype=out_sorted.dtype,
                           device=x.device).index_add(0, token_idx[order],
                                                      contrib)
    out = combined.reshape(xt.shape) + _shared(params, xt, activation)
    return out.reshape(x.shape), aux


moe_apply.host_syncs = 0


def moe_apply_dense(params: dict, x: torch.Tensor, cfg: MoEConfig,
                    activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle of ``moe_apply``: every token through every expert
    ((C, N, E, ff) intermediates), combined with the routing weights
    scattered to (C, N, E)."""
    xt, weights, experts, aux = _route(params, x, cfg)
    dt = xt.dtype
    gate = torch.zeros(xt.shape[:2] + (cfg.num_experts,), dtype=dt,
                       device=x.device).scatter(-1, experts, weights.to(dt))
    up = torch.einsum("cnd,edf->cnef", xt, params["w_up"].to(dt))
    if "w_gate" in params:
        h = _act(activation, torch.einsum(
            "cnd,edf->cnef", xt, params["w_gate"].to(dt))) * up
    else:
        h = _act(activation, up)
    y = torch.einsum("cnef,efd->cned", h, params["w_down"].to(dt))
    out = torch.einsum("cne,cned->cnd", gate, y) + _shared(params, xt,
                                                           activation)
    return out.reshape(x.shape), aux
