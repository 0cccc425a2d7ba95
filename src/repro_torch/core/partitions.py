"""Rank-partition machinery (Section 5 of the paper).

The ordered client rank levels R = {r_1 < r_2 < ... < r_max} induce
non-overlapping partitions [l, h] with l = prev(h) + 1. For the partition
ending at boundary h only the *effective contributors* C_h = {k : r_k >= h}
participate, weighted n_k / N_h.

Key systems observation (ours): every aggregation rule in this family --
FlexLoRA's uniform averaging AND raFLoRA's rank-partitioned averaging -- can
be written as a single weighted-diagonal factored sum

    dW = sum_k  B_k  diag(omega_k)  A_k,

where omega_k[i] is the weight client k contributes at rank index i.

  FlexLoRA:  omega_k[i] = (n_k / N) * 1[i <= r_k]          (rank-agnostic)
  raFLoRA:   omega_k[i] = (n_k / N_{h(i)}) * 1[r_k >= h(i)] (rank-aware)

with h(i) = min{r in R : r >= i} the boundary of i's partition. This unifies
the implementations, makes the mismatch of Theorem 1 visible as a *weight
matrix difference*, and is the exact contraction computed by the
``rank_partition_agg`` Pallas kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def boundaries(rank_levels: Sequence[int]) -> List[int]:
    """Ordered unique rank boundaries R = {r_1 < ... < r_max}."""
    return sorted(set(int(r) for r in rank_levels))


def prev_boundary(h: int, levels: Sequence[int]) -> int:
    """prev(h) per the paper: 0 for the smallest boundary."""
    bs = boundaries(levels)
    i = bs.index(h)
    return 0 if i == 0 else bs[i - 1]


def partition_bounds(rank_levels: Sequence[int]) -> List[Tuple[int, int]]:
    """Partitions [(l, h)] with 1-indexed inclusive bounds (paper notation)."""
    bs = boundaries(rank_levels)
    out, prev = [], 0
    for h in bs:
        out.append((prev + 1, h))
        prev = h
    return out


def boundary_of_index(rank_levels: Sequence[int]) -> np.ndarray:
    """h(i) for every rank index i in [1, r_max]; returned 0-indexed array of
    length r_max where entry i-1 = h(i)."""
    bs = boundaries(rank_levels)
    r_max = bs[-1]
    out = np.zeros(r_max, dtype=np.int64)
    for (l, h) in partition_bounds(rank_levels):
        out[l - 1:h] = h
    return out


def coverage(rank_levels: Sequence[int], client_ranks: Sequence[int]
             ) -> np.ndarray:
    """Rank coverage p_i = |{k : r_k >= i}| / K for i = 1..r_max (Eq. 1)."""
    r_max = max(rank_levels)
    ranks = np.asarray(client_ranks)
    return np.array([(ranks >= i).mean() for i in range(1, r_max + 1)])


def omega_flexlora(client_ranks: Sequence[int],
                   num_samples: Sequence[float],
                   r_max: int) -> np.ndarray:
    """Rank-agnostic FedAvg weights. Returns (M, r_max)."""
    ranks = np.asarray(client_ranks)
    n = np.asarray(num_samples, dtype=np.float64)
    w = n / n.sum()
    idx = np.arange(1, r_max + 1)
    support = (idx[None, :] <= ranks[:, None]).astype(np.float64)
    return w[:, None] * support


def omega_raflora(client_ranks: Sequence[int],
                  num_samples: Sequence[float],
                  rank_levels: Sequence[int]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Rank-partitioned weights (Eq. 8).

    Returns (omega (M, r_max), fallback (r_max,)) where fallback[i] = 1 for
    rank indices whose partition has NO sampled contributor -- those indices
    take the current global slice instead (Eq. 8 second case).
    """
    ranks = np.asarray(client_ranks)
    n = np.asarray(num_samples, dtype=np.float64)
    r_max = max(rank_levels)
    h_of_i = boundary_of_index(rank_levels)          # (r_max,)
    omega = np.zeros((len(ranks), r_max))
    fallback = np.zeros(r_max)
    for i in range(r_max):
        h = h_of_i[i]
        members = ranks >= h
        n_h = n[members].sum()
        if n_h > 0:
            omega[members, i] = n[members] / n_h
        else:
            fallback[i] = 1.0
    return omega, fallback


def effective_contributors(h: int, client_ranks: Sequence[int]) -> np.ndarray:
    """Index mask of C_h = {k : r_k >= h}."""
    return np.asarray(client_ranks) >= h
