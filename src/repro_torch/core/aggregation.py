"""Server-side aggregation of heterogeneous-rank LoRA uploads, kernel
backend (a port of the round path of ``repro/core/aggregation.py``).

Stacked-factor representation, as in the reference:

  bs    (M, ..., d, r_max)   client B factors, zero beyond r_k
  as_   (M, ..., r_max, n)   client A factors, zero beyond r_k
  ranks (M,), n_k (M,)       client ranks and sample counts

``flexlora`` (rank-agnostic weights, collapses) and ``raflora``
(rank-partitioned weights with the Eq. 8 fallback, the paper's method)
share one weighted-diagonal contraction: omega is data, not code. The
kernel backend builds the sqrt(omega)-weighted stacks and their Gram cores
with the hand-written kernels (K1, K2) and reallocates through
``svd_realloc_gram``; the (d, n) update is never formed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import partitions as parts
from repro_torch.core.svd import check_fallback_globals, svd_realloc_gram

METHODS = ("flexlora", "raflora")
_NOT_PORTED = {
    "fedavg": "ROADMAP.md queue 1 item 3",
    "hetlora": "ROADMAP.md queue 1 item 3",
    "flora": "ROADMAP.md queue 1 item 3",
    "ffa": "ROADMAP.md queue 1 item 3",
}


@dataclass
class AggregationResult:
    b_g: torch.Tensor                   # (..., d, r_max)
    a_g: torch.Tensor                   # (..., r_max, n)
    sigma: Optional[torch.Tensor]       # (..., r_max)


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


def _agg_kernel_stacked(bs, as_, omega, global_b, global_a, fallback,
                        r_max) -> AggregationResult:
    """Flatten every batch axis between the client and matrix axes into one
    layer axis, run K1 + K2 once for the whole bucket (the Eq. 8 fallback
    riding as one extra client), then one batched Gram-core SVD realloc."""
    from repro_torch.kernels import ops as kernel_ops
    check_fallback_globals(fallback, global_b, global_a)
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


def _pad_rank(x: torch.Tensor, r_max: int, axis: int) -> torch.Tensor:
    pad = r_max - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - (axis % x.ndim)) + 1] = pad
    return F.pad(x, widths)


def _grouped_core(group_bs, group_as, omega, global_bs, global_as, fallback,
                  *, r_max):
    """Assemble a shape bucket from per-rank-group factor tuples and
    aggregate it. group_bs: over rank groups, over bucket adapters, of
    (G, ..., d, r_group) tensors; global_bs: over bucket adapters."""
    bs = torch.cat([_pad_rank(torch.stack(list(bt), dim=1), r_max, -1)
                    for bt in group_bs])              # (M, P, ..., d, r_max)
    as_ = torch.cat([_pad_rank(torch.stack(list(at), dim=1), r_max, -2)
                     for at in group_as])             # (M, P, ..., r_max, n)
    gb = None if global_bs is None else torch.stack(list(global_bs))
    ga = None if global_as is None else torch.stack(list(global_as))
    return _agg_kernel_stacked(bs, as_, omega, gb, ga, fallback, r_max)


@dataclass
class Aggregator:
    """Aggregates a round of client adapter uploads, bucket by bucket."""

    method: str
    rank_levels: Sequence[int]
    backend: str = "factored"
    # raFLoRA partial variants (Fig. 5a); only None (full raFLoRA) is ported
    partial_up_to: Optional[int] = None

    def __post_init__(self):
        if self.method in _NOT_PORTED:
            raise NotImplementedError(
                f"method {self.method!r} is not ported yet "
                f"({_NOT_PORTED[self.method]})")
        assert self.method in METHODS, self.method
        if self.backend != "kernel":
            raise NotImplementedError(
                f"backend {self.backend!r} is not ported yet (ROADMAP.md "
                "queue 1 item 3); the port runs backend='kernel'")
        if self.partial_up_to is not None:
            raise NotImplementedError(
                "partial raFLoRA (partial_up_to=) is not ported yet "
                "(ROADMAP.md queue 1 item 3)")

    def _svd_weights(self, ranks, n_k):
        """Per-round (omega, fallback) numpy weights."""
        r_max = max(self.rank_levels)
        if self.method == "flexlora":
            return parts.omega_flexlora(ranks, n_k, r_max), None
        omega, fb = parts.omega_raflora(ranks, n_k, self.rank_levels)
        return omega, (fb if fb.any() else None)

    def _weight_args(self, ranks, n_k):
        """(omega, fallback) as numpy, converted on the bucket's device."""
        omega, fallback = self._svd_weights(ranks, n_k)
        return (np.asarray(omega),
                None if fallback is None else np.asarray(fallback))

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
        omega_np, fallback_np = self._weight_args(ranks, n_arr)
        dev = group_bs[0][0].device
        omega = torch.as_tensor(omega_np, dtype=torch.float32, device=dev)
        fallback = (None if fallback_np is None else
                    torch.as_tensor(fallback_np, dtype=torch.float32,
                                    device=dev))
        return _grouped_core(
            group_bs, group_as, omega, global_bs, global_as, fallback,
            r_max=max(self.rank_levels))
