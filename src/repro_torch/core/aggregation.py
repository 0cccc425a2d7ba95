"""Server-side aggregation of heterogeneous-rank LoRA uploads (a port of
``repro/core/aggregation.py`` without its sharded and event parts).

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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import partitions as parts
from repro_torch.core.svd import (check_fallback_globals, dense_from_weighted,
                                  factored_from_weighted, ieee_f32,
                                  svd_realloc_dense, svd_realloc_factored,
                                  svd_realloc_gram)

METHODS = ("fedavg", "hetlora", "flora", "flexlora", "raflora", "ffa")
_AVG_FAMILY = ("fedavg", "hetlora", "ffa")


@dataclass
class AggregationResult:
    b_g: torch.Tensor                   # (..., d, r_max)
    a_g: torch.Tensor                   # (..., r_max, n)
    sigma: Optional[torch.Tensor]       # (..., r_max) or None
    merge_delta: Optional[torch.Tensor] = None  # FLoRA: dW folded into base


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
    (M, ..., d, r_max), (M, ..., r_max, n)."""
    return (torch.stack([_pad_rank(b, r_max, -1) for b, _ in factors]),
            torch.stack([_pad_rank(a, r_max, -2) for _, a in factors]))


def _weights(n_k: Sequence[float]) -> np.ndarray:
    n = np.asarray(n_k, dtype=np.float64)
    return n / n.sum()


def staleness_discount(n_k: Sequence[float],
                       staleness: Optional[Sequence[int]],
                       gamma: float = 1.0) -> np.ndarray:
    """Staleness-discounted effective sample counts n_k * gamma**s_k;
    ``staleness=None``, ``gamma=1`` or all-zero staleness are exact
    no-ops."""
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
    om = torch.as_tensor(omega, dtype=torch.float32, device=device)
    if fallback is None or not np.any(fallback):
        return om, None
    return om, torch.as_tensor(fallback, dtype=torch.float32, device=device)


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
        from repro_torch.kernels import ops as kernel_ops
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
    from repro_torch.kernels import ops as kernel_ops
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


def _grouped_core(group_bs, group_as, warg, global_bs, global_as, fallback,
                  *, r_max, backend, method):
    """Assemble a shape bucket from per-rank-group factor tuples and
    aggregate it. group_bs: over rank groups, over bucket adapters, of
    (G, ..., d, r_group) tensors; global_bs: over bucket adapters."""
    bs = torch.cat([_pad_rank(torch.stack(list(bt), dim=1), r_max, -1)
                    for bt in group_bs])              # (M, P, ..., d, r_max)
    as_ = torch.cat([_pad_rank(torch.stack(list(at), dim=1), r_max, -2)
                     for at in group_as])             # (M, P, ..., r_max, n)
    gb = None if global_bs is None else torch.stack(list(global_bs))
    ga = None if global_as is None else torch.stack(list(global_as))
    return _dispatch_stacked(bs, as_, warg, gb, ga, fallback, r_max, backend,
                             method)


@dataclass
class Aggregator:
    """Aggregates a round of client adapter uploads, adapter by adapter
    (``aggregate_layer``, the sequential engine) or bucket by bucket
    (``aggregate_stack`` / ``aggregate_grouped``, the batched engine)."""

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

    def _tensor_args(self, ranks, n_k, device):
        warg, fallback = self._weight_args(ranks, n_k)
        return (torch.as_tensor(warg, dtype=torch.float32, device=device),
                None if fallback is None else torch.as_tensor(
                    fallback, dtype=torch.float32, device=device))

    def aggregate_stack(self, bs, as_, ranks, n_k, global_b=None,
                        global_a=None) -> AggregationResult:
        """Aggregate a pre-stacked shape bucket: bs (M, *batch, d, r_max);
        as_ (M, *batch, r_max, n); global factors, if given, carry the
        same batch axes without the client axis. The result keeps the
        batch axes."""
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
        group-client order). Returns an AggregationResult with a leading
        bucket-adapter axis."""
        if present is not None:
            raise NotImplementedError(
                "partial cohorts (present=) belong to the event engine, not "
                "ported yet (ROADMAP.md queue 1 item 8)")
        n_arr = staleness_discount(n_k, staleness, gamma)
        warg, fallback = self._tensor_args(ranks, n_arr,
                                           group_bs[0][0].device)
        return AggregationResult(*_grouped_core(
            group_bs, group_as, warg, global_bs, global_as, fallback,
            r_max=max(self.rank_levels), backend=self.backend,
            method=self.method))
