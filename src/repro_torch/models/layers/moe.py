"""Mixture-of-experts FFN with a dropless sorted dispatch (port of
``repro/models/layers/moe.py``: its default ``"tp"`` path, and its
expert-parallel ``"ep"`` path with the capacity dispatch).

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

``moe_apply_ep`` shards the experts over the ``"model"`` axis of a
``("data", "model")`` mesh (``launch.mesh.make_host_mesh``): every rank
of the axis holds the same tokens, routes them over all E experts,
computes only its own E / model experts and one counted ``all_reduce``
(``core/collective.py``) sums the ranks' outputs, the reference's
``psum``, and trains through it at any number of ranks. Dropless, it
syncs the group sizes to the host as ``moe_apply``
does; with ``capacity_factor > 0`` it runs ``_expert_ffn_capacity``:
static shapes, group sizes kept on the device, no host sync, and the
assignments past an expert's capacity dropped.

``moe_apply_dense`` runs every token through every expert, weighted by
its routing (zero off its top-k): a plain oracle for the tests, on no
path of the model.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import collective
from repro_torch.models.layers import draw
from repro_torch.models.layers.dense import dense_init
from repro_torch.models.layers.mlp import _act, is_gated, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             activation: str, *, dtype=torch.float32, device=None,
             out: Optional[dict] = None) -> dict:
    """Router ``w`` (d, E) in f32 whatever ``dtype``; ``w_up``, ``w_gate``
    (E, d, ff) and ``w_down`` (E, ff, d) all ~ N(0, 1/d_model); the
    shared experts as one MLP without adapters."""
    e, ff = cfg.num_experts, cfg.expert_d_ff
    scale = d_model ** -0.5

    def w(key, shape):
        return draw.normal(gen, shape, scale, dtype, device,
                           draw.sub(out, key))
    params = {"router": dense_init(gen, d_model, e, dtype=torch.float32,
                                   device=device,
                                   out=draw.sub(out, "router")),
              "w_up": w("w_up", (e, d_model, ff)),
              "w_down": w("w_down", (e, ff, d_model))}
    if is_gated(activation):
        params["w_gate"] = w("w_gate", (e, d_model, ff))
    if cfg.num_shared_experts:
        params["shared"] = mlp_init(
            gen, d_model, (cfg.shared_d_ff or ff) * cfg.num_shared_experts,
            activation, lora_ranks={}, dtype=dtype, device=device,
            out=draw.sub(out, "shared"))
    return params


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., N, E) logits -> (weights (..., N, k), experts (..., N, k),
    aux (...)): the aux loss over the N tokens of each leading index.
    The top k are the first k of a stable descending sort, so tied
    probabilities keep the lower expert first, as ``jax.lax.top_k``
    does (``torch.topk`` leaves the order of ties open)."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    weights, experts = weights[..., :top_k], experts[..., :top_k]
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


def _expert_ffn_capacity(sorted_tokens: torch.Tensor,
                         group_sizes: torch.Tensor, params: dict,
                         activation: str, capacity: int) -> torch.Tensor:
    """Capacity-bounded grouped FFN (the reference's, §Perf iteration A).

    sorted_tokens (Tk, d) are sorted by group, ``group_sizes`` (E,) the
    row counts of the E experts of ``params`` on the device; rows after
    the last group (the dispatch's trailing group of other ranks'
    assignments) get no product and a zero output. Each expert's window
    is ``starts[e] + arange(capacity)``, clamped to Tk - 1, its rows past
    the group size zeroed before and after one batched (E, C, d) x (E, d,
    f) product a weight, and the outputs are added back to their rows:
    the rows past an expert's capacity are dropped (output zero). The
    reference also runs the trailing group through an expert of zero
    weights, whose output is zero; here it is not computed."""
    tk, d = sorted_tokens.shape
    dt = sorted_tokens.dtype
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    offs = torch.arange(capacity, device=sorted_tokens.device)
    valid = (offs[None, :] < group_sizes[:, None])[..., None].to(dt)
    idx = torch.clamp(starts[:, None] + offs[None, :], max=tk - 1)
    toks = sorted_tokens[idx] * valid                       # (E, C, d)
    up = torch.bmm(toks, params["w_up"].to(dt))
    if "w_gate" in params:
        h = _act(activation, torch.bmm(toks, params["w_gate"].to(dt))) * up
    else:
        h = _act(activation, up)
    out = torch.bmm(h, params["w_down"].to(dt)) * valid
    return torch.zeros((tk, d), dtype=out.dtype,
                       device=out.device).index_add(0, idx.reshape(-1),
                                                    out.reshape(-1, d))


class _ExpertSum(torch.autograd.Function):
    """The sum over the expert axis with a gradient: the forward's
    counted all-reduce, the backward the identity (every rank holds the
    whole output gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return collective.all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ToExperts(torch.autograd.Function):
    """The conjugate of ``_ExpertSum`` where the replicated tokens and
    routing weights enter this rank's experts: the identity forward, and
    one counted all-reduce backward that sums the ranks' gradients (each
    rank's experts see the same tokens and add their own terms), so the
    gradient into x and the router holds every expert's term on every
    rank. Both gradients go in one buffer."""

    @staticmethod
    def forward(ctx, x, w, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        flat = torch.cat([gx.reshape(-1).float(), gw.reshape(-1).float()])
        flat = collective.all_reduce(flat, ctx.mesh, ctx.axis)
        n = gx.numel()
        return (flat[:n].reshape(gx.shape).to(gx.dtype),
                flat[n:].reshape(gw.shape).to(gw.dtype), None, None)


def _grad_through(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _expert_sum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The reference's ``psum`` over ``axis``, one counted all-reduce,
    with its gradient (``_ExpertSum``) where one is needed."""
    if not _grad_through(x):
        return collective.all_reduce(x, mesh, axis)
    return _ExpertSum.apply(x, mesh, axis)


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


def moe_apply_ep(params: dict, x: torch.Tensor, cfg: MoEConfig,
                 activation: str, mesh, ep_axis: str = "model", *,
                 batch_axes=("data",), capacity_factor: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (DESIGN.md §5). x (C, ..., d) -> (out like x,
    aux (C,)), as ``moe_apply``.

    x is this rank's block of the batch over ``batch_axes``: ranks hold
    their own tokens, so the data axes need no collective, and every rank
    of ``ep_axis`` holds the same x. ``params`` hold all E experts; this
    rank computes experts [i * E / n, (i + 1) * E / n) of the n ranks of
    ``ep_axis``. Each assignment to another rank's expert goes to a
    trailing group with weight 0, a stable sort orders the assignments
    by local expert, and after the local products one all-reduce over
    ``ep_axis`` sums the ranks' outputs. Its gradient: the output
    gradient reaches every rank whole, and one all-reduce in the backward
    (``_ToExperts``) sums the ranks' gradients into the tokens and routing
    weights that entered their experts; the shared experts and the aux
    loss are computed whole on every rank and not summed again. An expert
    weight's gradient lies on the rank that holds the expert.
    ``capacity_factor > 0`` takes ``_expert_ffn_capacity`` at capacity
    ``int(capacity_factor * T * k / E) + 1`` (T the tokens of the call, E
    the global expert count):
    group sizes stay on the device and no host sync is made. Otherwise
    the group sizes reach the host once (``moe_apply.host_syncs``)."""
    xt, weights, experts, aux = _route(params, x, cfg)
    d = xt.shape[-1]
    flat_x = xt.reshape(-1, d)
    t, k, e = flat_x.shape[0], cfg.top_k, cfg.num_experts
    ranks = mesh.shape[mesh.mesh_dim_names.index(ep_axis)]
    if e % ranks:
        raise ValueError(f"{e} experts do not split over {ranks} ranks")
    local_e = e // ranks
    e_lo = mesh.get_local_rank(ep_axis) * local_e
    flat_expert = experts.reshape(-1)
    flat_weight = weights.reshape(-1)
    if _grad_through(flat_x, flat_weight):
        flat_x, flat_weight = _ToExperts.apply(flat_x, flat_weight, mesh,
                                               ep_axis)
    local = (flat_expert >= e_lo) & (flat_expert < e_lo + local_e)
    local_expert = torch.where(local, flat_expert - e_lo, local_e)
    w_masked = torch.where(local, flat_weight, 0.0)
    token_idx = torch.arange(t * k, device=x.device) // k
    order = torch.argsort(local_expert, stable=True)
    rows = token_idx[order]
    sorted_tokens = flat_x[rows]
    w_sorted = w_masked[order]
    p_local = {name: params[name][e_lo:e_lo + local_e]
               for name in ("w_up", "w_gate", "w_down") if name in params}
    if capacity_factor > 0:
        cap = int(capacity_factor * (t * k) / e) + 1
        group_sizes = torch.zeros(local_e + 1, dtype=torch.long,
                                  device=x.device).scatter_add_(
            0, local_expert, torch.ones_like(local_expert))
        out_sorted = _expert_ffn_capacity(sorted_tokens,
                                          group_sizes[:local_e], p_local,
                                          activation, cap)
    else:
        group_sizes = torch.bincount(local_expert,
                                     minlength=local_e + 1).tolist()
        moe_apply.host_syncs += 1
        n_local = sum(group_sizes[:local_e])
        rows, w_sorted = rows[:n_local], w_sorted[:n_local]
        out_sorted = (_expert_ffn_sorted(sorted_tokens[:n_local],
                                         group_sizes[:local_e], p_local,
                                         activation)
                      if n_local else sorted_tokens[:0])
    contrib = out_sorted * w_sorted[:, None].to(out_sorted.dtype)
    combined = torch.zeros((t, d), dtype=out_sorted.dtype,
                           device=x.device).index_add(0, rows, contrib)
    combined = _expert_sum(combined, mesh, ep_axis)
    out = combined.reshape(xt.shape) + _shared(params, xt, activation)
    return out.reshape(x.shape), aux


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
