"""Server-side aggregation of heterogeneous-rank LoRA uploads (a port of
``repro/core/aggregation.py``).

Implements the paper's method and every baseline it compares against
(Table 1), all over one stacked-factor representation, as in the
reference:

  bs    (M, ..., d, r_max)   client B factors, zero beyond r_k
  as_   (M, ..., r_max, n)   client A factors, zero beyond r_k
  ranks (M,), n_k (M,)       client ranks and sample counts

Methods
  fedavg    -- homogeneous FedAvg of factors (FedIT); requires equal ranks
  hetlora   -- zero-pad, average B and A SEPARATELY (aggregation bias)
  flora     -- stacking: dW = sum w_k B_k A_k merged into the base weights,
               adapters re-initialized (cold start)
  flexlora  -- dW = sum (n_k/N) B_k A_k, SVD realloc (rank collapse)
  raflora   -- rank-partitioned dW (Eq. 8), SVD realloc (the paper);
               ``partial_up_to`` gives Fig. 5a's partial variants
  ffa       -- FFA-LoRA: the frozen factor kept, the trained one averaged

``flexlora`` and ``raflora`` share one weighted-diagonal contraction:
omega is data, not code. ``backend="dense"`` materializes dW
(paper-faithful); ``backend="factored"`` uses the QR low-rank SVD;
``backend="kernel"`` builds the sqrt(omega)-weighted stacks and their Gram
cores with the hand-written kernels (K1, K2) and reallocates through
``svd_realloc_gram``, never forming the (d, n) update.

``Aggregator.aggregate_grouped_sharded`` is the sharded round engine's
path: each rank reduces its resident clients and one all-reduce per
reduced tensor sums the ranks (DESIGN.md §5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis import host_cost
from repro_torch.core import collective
from repro_torch.core import partitions as parts
from repro_torch.core.svd import (check_fallback_globals, dense_fallback_term,
                                  dense_from_weighted,
                                  factored_append_fallback,
                                  factored_from_weighted,
                                  factored_stack_batched, ieee_f32,
                                  svd_realloc_dense, svd_realloc_factored,
                                  svd_realloc_gram)
from repro_torch.kernels import ops as kernel_ops
# the one decoder of transport payloads: every stack build dequantizes
# before any weighting (omega rows, staleness discounts, the Eq. 8
# fallback), as the reference's ``_dq`` does (DESIGN.md §12)
from repro_torch.kernels.ops import dequantize, is_quantized

METHODS = ("fedavg", "hetlora", "flora", "flexlora", "raflora", "ffa")
_AVG_FAMILY = ("fedavg", "hetlora", "ffa")


@dataclass
class AggregationResult:
    b_g: torch.Tensor                   # (..., d, r_max)
    a_g: torch.Tensor                   # (..., r_max, n)
    sigma: Optional[torch.Tensor]       # (..., r_max) or None
    merge_delta: Optional[torch.Tensor] = None  # FLoRA: dW folded into base


def _device(x) -> torch.device:
    """The device of a factor that may be a QuantFactor."""
    return (x.q if is_quantized(x) else x).device


def _pad_rank(x: torch.Tensor, r_max: int, axis: int) -> torch.Tensor:
    pad = r_max - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - (axis % x.ndim)) + 1] = pad
    return F.pad(x, widths)


def pad_stack(factors: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              r_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(B_k (..., d, r_k), A_k (..., r_k, n))] -> zero-padded stacks
    (M, ..., d, r_max), (M, ..., r_max, n). Transport-quantized entries
    dequantize here (the sequential engine's stack build)."""
    return (torch.stack([_pad_rank(dequantize(b), r_max, -1)
                         for b, _ in factors]),
            torch.stack([_pad_rank(dequantize(a), r_max, -2)
                         for _, a in factors]))


def _weights(n_k: Sequence[float]) -> np.ndarray:
    n = np.asarray(n_k, dtype=np.float64)
    return n / n.sum()


def staleness_discount(n_k: Sequence[float],
                       staleness: Optional[Sequence[int]],
                       gamma: float = 1.0) -> np.ndarray:
    """Staleness-discounted effective sample counts n_k * gamma**s_k;
    ``staleness=None``, ``gamma=1`` or all-zero staleness are exact
    no-ops."""
    host_cost.tick("agg/weight_counts", len(n_k))
    n = np.asarray(n_k, dtype=np.float64)
    if staleness is None or gamma == 1.0:
        return n
    s = np.broadcast_to(np.asarray(staleness, dtype=np.float64), n.shape)
    if not s.any():
        return n
    assert gamma > 0.0, gamma  # gamma<=0 would zero real clients
    return n * np.power(float(gamma), s)


def cohort_weights(n_k: Sequence[float],
                   staleness: Optional[Sequence[int]],
                   present: Optional[Sequence[bool]],
                   gamma: float = 1.0) -> np.ndarray:
    """Normalized per-client weights of one cohort: discounted counts,
    absent and ghost (n_k = 0) clients exactly zero, summing to 1."""
    w = staleness_discount(n_k, staleness, gamma)
    if present is not None:
        w = np.where(np.asarray(present, dtype=bool), w, 0.0)
    total = w.sum()
    assert total > 0.0, "a cohort aggregated with zero total weight"
    return w / total


# ---------------------------------------------------------------------------
# aggregation rules
# ---------------------------------------------------------------------------

def weighted_avg(stack: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted average over the leading client axis (any batch axes)."""
    return (w.reshape((-1,) + (1,) * (stack.ndim - 1)) * stack).sum(0)


def _avg_factors(bs, as_, w):
    """Weighted client-axis average of both factor stacks (fedavg/hetlora)."""
    return weighted_avg(bs, w), weighted_avg(as_, w)


def _flora_delta(bs, as_, w):
    """FLoRA stacking math: the unbiased dW in f32 and zeroed (cold-start)
    adapters. As in the reference, both global factors restart at zero, so
    no later round trains them (ROADMAP.md queue 3)."""
    with ieee_f32():
        dw = torch.einsum("m,m...dr,m...rn->...dn", w.float(), bs.float(),
                          as_.float())
    return (torch.zeros(bs.shape[1:], dtype=torch.float32, device=bs.device),
            torch.zeros(as_.shape[1:], dtype=torch.float32,
                        device=as_.device), dw)


def f32_tensor(x, device=None) -> torch.Tensor:
    """Host weights (numpy, any float dtype) -> an f32 tensor on
    ``device``, cast by numpy on the host: no float64 tensor is made and
    the copy to the card carries f32 (the same round-to-nearest cast
    either way)."""
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _client_weights(n_k, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """n_k / sum(n_k) in float64, cast to ``like``'s dtype (or ``dtype``)
    on its device."""
    return torch.as_tensor(_weights(n_k), dtype=dtype or like.dtype,
                           device=like.device)


def aggregate_fedavg(bs, as_, ranks, n_k) -> AggregationResult:
    """Homogeneous FedAvg of the raw factors (FedIT)."""
    ranks = np.asarray(ranks)
    assert (ranks == ranks[0]).all(), "fedavg requires homogeneous ranks"
    b_g, a_g = _avg_factors(bs, as_, _client_weights(n_k, bs))
    return AggregationResult(b_g, a_g, None)


def aggregate_hetlora(bs, as_, ranks, n_k) -> AggregationResult:
    """HetLoRA: zero-padding alignment, separate averaging of B and A
    (E[B]E[A] != E[BA], the bias the later methods remove)."""
    b_g, a_g = _avg_factors(bs, as_, _client_weights(n_k, bs))
    return AggregationResult(b_g, a_g, None)


def aggregate_flora(bs, as_, ranks, n_k) -> AggregationResult:
    """FLoRA: dW = sum w_k B_k A_k is merged into the base weights and the
    adapters restart from zero."""
    b_g, a_g, dw = _flora_delta(bs, as_, _client_weights(
        n_k, bs, torch.float32))
    return AggregationResult(b_g, a_g, None, merge_delta=dw)


def _omega_args(omega, fallback, device):
    """(omega, fallback) numpy -> f32 tensors; an all-zero fallback is
    None."""
    om = f32_tensor(omega, device)
    if fallback is None or not np.any(fallback):
        return om, None
    return om, f32_tensor(fallback, device)


def aggregate_flexlora(bs, as_, ranks, n_k, *, backend: str = "factored"
                       ) -> AggregationResult:
    """FlexLoRA: rank-agnostic weighted sum + SVD realloc (Eqs. 2-4)."""
    r_max = bs.shape[-1]
    omega, _ = _omega_args(parts.omega_flexlora(ranks, n_k, r_max), None,
                           bs.device)
    return _weighted_svd(bs, as_, omega, None, None, None, r_max, backend)


def aggregate_raflora(bs, as_, ranks, n_k, *, rank_levels: Sequence[int],
                      global_b=None, global_a=None,
                      backend: str = "factored") -> AggregationResult:
    """raFLoRA: rank-partitioned aggregation (Eq. 8 / Algorithm 1)."""
    omega, fallback = _omega_args(
        *parts.omega_raflora(ranks, n_k, rank_levels), bs.device)
    return _weighted_svd(bs, as_, omega, global_b, global_a, fallback,
                         max(rank_levels), backend)


def aggregate_ffa(bs, as_, ranks, n_k, *, global_b) -> AggregationResult:
    """FFA-LoRA (paper ref [9]): the random-init down factor is FROZEN at
    its shared global value; only the up factor is trained and averaged.

    Layout: the server maps the model's lora_a to the first factor here,
    so the FROZEN factor is ``bs``/``global_b`` and the averaged one is
    ``as_`` (zero-padded, HetLoRA-style, under heterogeneous ranks)."""
    return AggregationResult(
        global_b, weighted_avg(as_, _client_weights(n_k, as_)), None)


def _weighted_svd(bs, as_, omega, global_b, global_a, fallback, r_max,
                  backend) -> AggregationResult:
    """Weighted-diagonal contraction + SVD realloc, for unstacked factors
    (M, d, r) or factors with any batch axes between the client and matrix
    axes. The dense and factored backends batch over those axes natively;
    the kernel backend flattens them into one layer axis of K1/K2
    (``_agg_kernel_stacked``), or runs them at L = 1 for one adapter."""
    check_fallback_globals(fallback, global_b, global_a)
    if backend == "dense":
        b_g, a_g, sigma = svd_realloc_dense(dense_from_weighted(
            bs, as_, omega, global_b, global_a, fallback), r_max)
    elif backend == "factored":
        b_g, a_g, sigma = svd_realloc_factored(*factored_from_weighted(
            bs, as_, omega, global_b, global_a, fallback), r_max)
    elif backend == "kernel":
        if bs.ndim > 3:
            return _agg_kernel_stacked(bs, as_, omega, global_b, global_a,
                                       fallback, r_max)
        b_g, a_g, sigma = svd_realloc_gram(*kernel_ops.factored_stack_gram(
            bs, as_, omega, global_b, global_a, fallback), r_max)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return AggregationResult(b_g, a_g, sigma)


def _agg_kernel_stacked(bs, as_, omega, global_b, global_a, fallback,
                        r_max) -> AggregationResult:
    """Flatten every batch axis between the client and matrix axes into one
    layer axis, run K1 + K2 once for the whole bucket (the Eq. 8 fallback
    riding as one extra client), then one batched Gram-core SVD realloc."""
    lead = tuple(bs.shape[1:-2])
    m, d, r = bs.shape[0], bs.shape[-2], bs.shape[-1]
    n = as_.shape[-1]
    layers = int(np.prod(lead)) if lead else 1
    bs_l = bs.reshape(m, layers, d, r).movedim(0, 1)
    as_l = as_.reshape(m, layers, r, n).movedim(0, 1)
    gb = None if global_b is None else global_b.reshape(layers, d, r_max)
    ga = None if global_a is None else global_a.reshape(layers, r_max, n)
    u_c, v_c, g_u, g_v = kernel_ops.factored_stack_gram_layered(
        bs_l, as_l, omega, gb, ga, fallback)
    b_g, a_g, sigma = svd_realloc_gram(u_c, v_c, g_u, g_v, r_max)
    return AggregationResult(b_g.reshape(lead + (d, r_max)),
                             a_g.reshape(lead + (r_max, n)),
                             sigma.reshape(lead + (r_max,)))


# -- whole-bucket pipelines (batched round engine) ---------------------------

def _dispatch_stacked(bs, as_, warg, global_b, global_a, fallback, r_max,
                      backend, method):
    """Method dispatch over pre-stacked factors: (b_g, a_g, sigma|None,
    merge_delta|None). ``warg`` is the client-weight vector (averaging
    family and flora) or the omega matrix (SVD family)."""
    if method in _AVG_FAMILY:
        w = warg.to(bs.dtype)
        a_g = weighted_avg(as_, w)
        if method == "ffa":           # frozen factor: keep the global value
            return global_b, a_g, None, None
        return weighted_avg(bs, w), a_g, None, None
    if method == "flora":
        b_g, a_g, dw = _flora_delta(bs, as_, warg)
        return b_g, a_g, None, dw
    res = _weighted_svd(bs, as_, warg, global_b, global_a, fallback, r_max,
                        backend)
    return res.b_g, res.a_g, res.sigma, None


def _assemble(group_bs, group_as, r_max, part=dequantize):
    """Stack a shape bucket from per-rank-group factor tuples: group_bs
    over rank groups, over bucket adapters, of (G, ..., d, r_group) ->
    (M, P, ..., d, r_max), and the A side likewise. ``part`` picks what
    of each entry is stacked: transport-quantized entries dequantize here,
    once, by default."""
    bs = torch.cat([_pad_rank(torch.stack([part(b) for b in bt], dim=1),
                              r_max, -1) for bt in group_bs])
    as_ = torch.cat([_pad_rank(torch.stack([part(a) for a in at], dim=1),
                               r_max, -2) for at in group_as])
    return bs, as_


def _stack_globals(global_bs, global_as):
    return (None if global_bs is None else torch.stack(list(global_bs)),
            None if global_as is None else torch.stack(list(global_as)))


def _grouped_core(group_bs, group_as, warg, global_bs, global_as, fallback,
                  *, r_max, backend, method):
    """Assemble a shape bucket from per-rank-group factor tuples and
    aggregate it; global_bs: over bucket adapters."""
    bs, as_ = _assemble(group_bs, group_as, r_max)
    gb, ga = _stack_globals(global_bs, global_as)
    return _dispatch_stacked(bs, as_, warg, gb, ga, fallback, r_max, backend,
                             method)


# -- sharded whole-bucket pipelines (sharded round engine) -------------------
#
# DESIGN.md §5: each rank holds a contiguous block of every rank group's
# client axis, and every reduction of a method -- the weighted factor
# averages, FLoRA's dW, the weighted-diagonal contraction of the SVD
# family -- becomes a partial over the resident clients plus one
# all-reduce per reduced tensor. The dense backend all-reduces the
# (..., d, n) contraction; the factored and kernel backends all-reduce the
# zero-scattered (d, S * width) / (S * width, n) stacks (each rank writes
# its own column block, so the sum is a gather; the client order differs
# from the batched engine's, which the SVD does not see), the kernel
# backend building its block with K1 (``ops.factored_stack_lead``) and the
# Gram cores of the reduced stack with K2 (``ops.factored_gram_lead``).
# The Eq. 8 fallback is appended once, after the reduction, and the SVD
# reallocation is the unchanged math on the reduced, replicated result.
# The reference vmaps its one-slice realloc (``_realloc_*_lead``); the
# port's ``svd_realloc_*`` take the leading axes natively.

def _sharded_partial_quantized(group_bs, group_as, group_w, *, r_max,
                               mesh):
    """The factored / kernel partial of transport-quantized uploads: the
    raw int8 or bf16 payload blocks and f32 per-column weights (scale *
    sqrt(omega)) are all-reduced, zero-scattered in the stack's column
    layout (column = client * r_max + rank), and dequantized once after
    the reduction. The blocks are disjoint, so each sum has one nonzero
    term and is exact. Returns the reduced f32 (u_c, v_c)."""
    qs, qa = _assemble(group_bs, group_as, r_max, part=lambda f: f.q)
    sb, sa = _assemble(group_bs, group_as, r_max, part=lambda f: f.scale)
    w = torch.cat(group_w)                            # (m_loc, r_max)
    m, r = qs.shape[0], qs.shape[-1]
    lead = tuple(qs.shape[1:-2])
    sq = torch.sqrt(torch.clamp(w.float(), min=0.0))
    sqr = sq.reshape((m,) + (1,) * len(lead) + (r,))
    colw_u = sb[..., 0, :] * sqr                      # (m, *lead, r)
    colw_v = sa[..., 0] * sqr
    u_pay = qs.movedim(0, -2).reshape(lead + (qs.shape[-2], m * r))
    v_pay = qa.movedim(0, -3).reshape(lead + (m * r, qa.shape[-1]))
    cu = colw_u.movedim(0, -2).reshape(lead + (m * r,))
    cv = colw_v.movedim(0, -2).reshape(lead + (m * r,))
    u_full = collective.gather_blocks(u_pay, mesh, -1)
    v_full = collective.gather_blocks(v_pay, mesh, -2)
    cu_full = collective.gather_blocks(cu, mesh, -1)
    cv_full = collective.gather_blocks(cv, mesh, -1)
    return (u_full.float() * cu_full[..., None, :],
            v_full.float() * cv_full[..., :, None])


def _sharded_partial(group_bs, group_as, group_w, gb, *, r_max, backend,
                     method, mesh):
    """One rank's partial of a bucket over its resident clients, reduced
    across the ranks. ``group_w``: per group, this rank's rows of the
    client weights (averaging family, flora) or of omega (SVD family),
    zero at ghosts. Returns the reduced tensors of the method: (b_g, a_g),
    (b_g, a_g, dw), (u_c, v_c) or dw."""
    quantized = any(is_quantized(b) for bt in group_bs for b in bt)
    svd_family = method not in _AVG_FAMILY + ("flora",)
    if quantized and svd_family and backend in ("factored", "kernel"):
        return _sharded_partial_quantized(group_bs, group_as, group_w,
                                          r_max=r_max, mesh=mesh)
    bs, as_ = _assemble(group_bs, group_as, r_max)
    w = torch.cat(group_w)
    if method in _AVG_FAMILY:
        w = w.to(bs.dtype)
        a_g = collective.all_reduce(weighted_avg(as_, w), mesh)
        if method == "ffa":           # frozen factor: keep the global value
            return gb, a_g
        return collective.all_reduce(weighted_avg(bs, w), mesh), a_g
    if method == "flora":
        b_g, a_g, dw = _flora_delta(bs, as_, w)
        return b_g, a_g, collective.all_reduce(dw, mesh)
    if backend in ("factored", "kernel"):
        if backend == "kernel":
            u_loc, v_loc = kernel_ops.factored_stack_lead(bs, as_, w)
        else:
            u_loc, v_loc = factored_stack_batched(bs, as_, w)
        return (collective.gather_blocks(u_loc, mesh, -1),
                collective.gather_blocks(v_loc, mesh, -2))
    with ieee_f32():
        dw = torch.einsum("m...dr,mr,m...rn->...dn", bs.float(), w.float(),
                          as_.float())
    return collective.all_reduce(dw, mesh)


def sharded_grouped_fn(mesh, r_max: int, backend: str, method: str):
    """The sharded-bucket pipeline of one (mesh, method, backend):
    fn(group_bs, group_as, group_w, global_bs, global_as, fallback) ->
    (b_g, a_g, sigma|None, merge_delta|None), ``_grouped_core`` with each
    group's client axis this rank's block and every reduction an
    all-reduce over ``mesh``."""
    def fn(group_bs, group_as, group_w, global_bs, global_as, fallback):
        check_fallback_globals(fallback, global_bs, global_as)
        gb, ga = _stack_globals(global_bs, global_as)
        red = _sharded_partial(group_bs, group_as, group_w, gb,
                               r_max=r_max, backend=backend, method=method,
                               mesh=mesh)
        if method in _AVG_FAMILY:
            return red + (None, None)
        if method == "flora":
            b_g, a_g, dw = red
            return b_g, a_g, None, dw
        if backend == "dense":
            dw = red
            if fallback is not None:
                dw = dw + dense_fallback_term(gb, ga, fallback)
            return svd_realloc_dense(dw, r_max) + (None,)
        u_c, v_c = red
        if fallback is not None:
            # appended exactly once, after the cross-rank reduction
            u_c, v_c = factored_append_fallback(u_c, v_c, gb, ga, fallback)
        if backend == "kernel":
            g_u, g_v = kernel_ops.factored_gram_lead(u_c, v_c)
            return svd_realloc_gram(u_c, v_c, g_u, g_v, r_max) + (None,)
        return svd_realloc_factored(u_c, v_c, r_max) + (None,)
    return fn


@dataclass
class Aggregator:
    """Aggregates a round of client adapter uploads, adapter by adapter
    (``aggregate_layer``, the sequential engine) or bucket by bucket
    (``aggregate_stack`` / ``aggregate_grouped``, the batched engine;
    ``aggregate_grouped_sharded``, the sharded one)."""

    method: str
    rank_levels: Sequence[int]
    backend: str = "factored"
    # raFLoRA partial variants (Fig. 5a): effective-contributor weighting
    # up to this boundary, FlexLoRA weights above. None = full raFLoRA.
    partial_up_to: Optional[int] = None

    def __post_init__(self):
        assert self.method in METHODS, self.method

    def aggregate_layer(self, factors, ranks, n_k, global_b=None,
                        global_a=None) -> AggregationResult:
        """factors: [(B_k (..., d, r_k), A_k (..., r_k, n))] for one
        adapter."""
        r_max = max(self.rank_levels)
        bs, as_ = pad_stack(factors, r_max)
        if self.method == "fedavg":
            return aggregate_fedavg(bs, as_, ranks, n_k)
        if self.method == "hetlora":
            return aggregate_hetlora(bs, as_, ranks, n_k)
        if self.method == "ffa":
            return aggregate_ffa(bs, as_, ranks, n_k, global_b=global_b)
        if self.method == "flora":
            return aggregate_flora(bs, as_, ranks, n_k)
        if self.method == "flexlora":
            return aggregate_flexlora(bs, as_, ranks, n_k,
                                      backend=self.backend)
        if self.partial_up_to is None:
            return aggregate_raflora(
                bs, as_, ranks, n_k, rank_levels=self.rank_levels,
                global_b=global_b, global_a=global_a, backend=self.backend)
        return self._aggregate_partial(bs, as_, ranks, n_k, global_b,
                                       global_a)

    def _aggregate_partial(self, bs, as_, ranks, n_k, global_b, global_a
                           ) -> AggregationResult:
        """raFLoRA-a/b/c variants: rank-aware weights for partitions up to
        ``partial_up_to``; FlexLoRA weights above (Fig. 5a)."""
        omega, fallback = _omega_args(*self._svd_weights(ranks, n_k),
                                      bs.device)
        return _weighted_svd(bs, as_, omega, global_b, global_a, fallback,
                             max(self.rank_levels), self.backend)

    def _svd_weights(self, ranks, n_k):
        """Per-round (omega, fallback) numpy weights for the SVD family:
        flexlora, raflora and the partial raFLoRA variants."""
        r_max = max(self.rank_levels)
        if self.method == "flexlora":
            return parts.omega_flexlora(ranks, n_k, r_max), None
        omega, fb = parts.omega_raflora(ranks, n_k, self.rank_levels)
        if self.partial_up_to is not None:
            om_flex = parts.omega_flexlora(ranks, n_k, r_max)
            cut = self.partial_up_to
            omega = np.concatenate([omega[:, :cut], om_flex[:, cut:]], axis=1)
            fb = np.concatenate([fb[:cut], np.zeros(r_max - cut)])
        return omega, (fb if fb.any() else None)

    def _weight_args(self, ranks, n_k):
        """(warg, fallback) numpy inputs of ``_dispatch_stacked``."""
        if self.method == "fedavg":
            ranks_arr = np.asarray(ranks)
            assert (ranks_arr == ranks_arr[0]).all(), \
                "fedavg requires homogeneous ranks"
        if self.method in _AVG_FAMILY + ("flora",):
            return np.asarray(_weights(n_k), np.float32), None
        omega, fallback = self._svd_weights(ranks, n_k)
        return (np.asarray(omega),
                None if fallback is None else np.asarray(fallback))

    def _present_weight_args(self, ranks, n_arr, present):
        """(warg, fallback) with only ``present`` clients participating:
        the event engine's partial cohorts. Weights are computed on the
        present subset alone -- absent clients stay out of every
        membership-derived quantity (raFLoRA's contributor sets, the Eq. 8
        fallback, the fedavg rank check) -- and scattered back with zeros.
        With every client present this is bit-identical to
        ``_weight_args`` (same inputs, same arrays)."""
        n_arr = np.where(np.asarray(present, dtype=bool), n_arr, 0.0)
        real = np.flatnonzero(n_arr > 0)
        assert real.size > 0, "an aggregation fired with no present client"
        warg_real, fallback = self._weight_args(
            [ranks[i] for i in real], n_arr[real])
        warg_np = np.asarray(warg_real)
        warg = np.zeros((len(n_arr),) + warg_np.shape[1:], warg_np.dtype)
        warg[real] = warg_np
        return warg, fallback

    def _tensor_args(self, ranks, n_k, device, present=None):
        if present is None:
            warg, fallback = self._weight_args(ranks, n_k)
        else:
            warg, fallback = self._present_weight_args(ranks, n_k, present)
        return (f32_tensor(warg, device),
                None if fallback is None else f32_tensor(fallback, device))

    def aggregate_stack(self, bs, as_, ranks, n_k, global_b=None,
                        global_a=None) -> AggregationResult:
        """Aggregate a pre-stacked shape bucket: bs (M, *batch, d, r_max);
        as_ (M, *batch, r_max, n); global factors, if given, carry the
        same batch axes without the client axis. The result keeps the
        batch axes."""
        bs, as_ = dequantize(bs), dequantize(as_)
        warg, fallback = self._tensor_args(ranks, n_k, bs.device)
        return AggregationResult(*_dispatch_stacked(
            bs, as_, warg, global_b, global_a, fallback,
            max(self.rank_levels), self.backend, self.method))

    def aggregate_grouped(self, group_bs, group_as, ranks, n_k,
                          global_bs=None, global_as=None,
                          staleness=None, gamma: float = 1.0,
                          present=None) -> AggregationResult:
        """Batched round engine hot path: aggregate a shape bucket straight
        from per-rank-group factor stacks (ranks/n_k in concatenated
        group-client order). ``staleness``/``gamma`` discount the async
        engine's stale clients; ``present`` masks the event engine's
        not-yet-arrived ones (``_present_weight_args``). Returns an
        AggregationResult with a leading bucket-adapter axis."""
        n_arr = staleness_discount(n_k, staleness, gamma)
        warg, fallback = self._tensor_args(ranks, n_arr,
                                           _device(group_bs[0][0]),
                                           present)
        return AggregationResult(*_grouped_core(
            group_bs, group_as, warg, global_bs, global_as, fallback,
            r_max=max(self.rank_levels), backend=self.backend,
            method=self.method))

    def aggregate_grouped_sharded(self, group_bs, group_as, ranks, n_k,
                                  mesh, global_bs=None, global_as=None,
                                  staleness=None, gamma: float = 1.0,
                                  present=None) -> AggregationResult:
        """Sharded round engine hot path: ``aggregate_grouped`` with each
        group's client axis split over ``mesh``'s ranks and every
        reduction an all-reduce (DESIGN.md §5). group_bs/group_as hold
        THIS rank's contiguous block of each group (``collective.block``
        of the group padded to a multiple of the shard count); ranks/n_k
        cover the whole padded cohort in group order, ``n_k[j] == 0``
        marking a ghost. Weights are computed on the real (and present)
        clients alone and scattered back with zeros, so ghosts add
        exactly nothing and leave raFLoRA's contributor sets and the Eq. 8
        fallback untouched; ``staleness``/``gamma`` discount as in
        ``aggregate_grouped``."""
        shards = collective.shard_count(mesh)
        sizes = [(b.q if is_quantized(b) else b).shape[0] * shards
                 for b in (bt[0] for bt in group_bs)]
        assert sum(sizes) == len(n_k), (sizes, len(n_k))
        n_arr = staleness_discount(n_k, staleness, gamma)
        warg, fallback = self._present_weight_args(
            ranks, n_arr,
            np.ones(len(n_arr), dtype=bool) if present is None else present)
        device = _device(group_bs[0][0])
        group_w = [f32_tensor(w[collective.block(len(w), mesh)], device)
                   for w in np.split(warg, np.cumsum(sizes)[:-1])]
        if fallback is not None:
            fallback = f32_tensor(fallback, device)
        fn = sharded_grouped_fn(mesh, max(self.rank_levels), self.backend,
                                self.method)
        return AggregationResult(*fn(group_bs, group_as, group_w,
                                     global_bs, global_as, fallback))
