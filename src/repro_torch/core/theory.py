"""Theorem 1 / Appendix A-B: closed-form rank-collapse dynamics (a numpy
copy of ``repro/core/theory.py``, identical in numbers).

Implements the paper's tractable model exactly so the geometric-rate claim
is machine-checkable:

  * ``h(p)``            -- hypergeometric second moment E[(N_i/M)^2] (Eq. 14)
  * ``contraction``     -- q_i = beta^2 h(p_i)
  * ``collapse_bound``  -- C, gamma of Eq. 6; bound 1 - rho <= C gamma^t
  * ``simulate_expected`` -- the linear recursion e^{t+1} = q e^t (Eq. 15)
  * ``simulate_sampled``  -- Monte-Carlo over actual client sampling
                             (Eq. 10-11), for FlexLoRA *and* raFLoRA rules
  * ``mean_field_step``   -- Appendix B recursion with basis-drift kappa and
                             residual delta^2 floors
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


def h_sampling(p: np.ndarray, K: int, M: int) -> np.ndarray:
    """h(p) = p^2 + (K-M)/(M(K-1)) p(1-p); E[(N/M)^2] under hypergeometric."""
    p = np.asarray(p, dtype=np.float64)
    tau = (K - M) / (M * (K - 1)) if K > 1 else 0.0
    return p * p + tau * p * (1.0 - p)


def contraction_factors(p: np.ndarray, K: int, M: int,
                        beta: float = 1.0) -> np.ndarray:
    """q_i = beta^2 h(p_i) (Eq. 14)."""
    return beta ** 2 * h_sampling(p, K, M)


def collapse_bound(e0: np.ndarray, p: np.ndarray, K: int, M: int,
                   r1: int, beta: float = 1.0) -> Tuple[float, float]:
    """(C, gamma) of Theorem 1. e0: initial energies (r_max,)."""
    q = contraction_factors(p, K, M, beta)
    low = e0[:r1].sum()
    assert low > 0, "Theorem requires nonzero initial shared-rank energy"
    C = e0[r1:].sum() / low
    gamma = q[r1] / q[r1 - 1] if len(q) > r1 else 0.0
    return float(C), float(gamma)


def simulate_expected(e0: np.ndarray, p: np.ndarray, K: int, M: int,
                      rounds: int, beta: float = 1.0) -> np.ndarray:
    """Expected-energy recursion e_i^{(t)} = e_i^{(0)} q_i^t (Eq. 15).

    Returns energies (rounds+1, r_max).
    """
    q = contraction_factors(p, K, M, beta)
    t = np.arange(rounds + 1)[:, None]
    return np.asarray(e0)[None, :] * q[None, :] ** t


def rho_series(energy: np.ndarray, r1: int) -> np.ndarray:
    """rho_{r1}^{(t)} per round from an energy trajectory (T, r_max)."""
    num = energy[:, :r1].sum(axis=1)
    den = energy.sum(axis=1)
    return num / np.maximum(den, 1e-300)


@dataclass
class SampledSim:
    """Monte-Carlo of the Assumption 1-2 model with real client sampling.

    Each round: draw M of K clients without replacement; client k supports
    direction i iff r_k >= i and contributes beta * sigma_i.

      FlexLoRA rule (Eq. 10):  sigma'_i = beta * (N_i / M) * sigma_i
      raFLoRA  rule (Sec. 5):  sigma'_i = beta * sigma_i      if N_{h(i)} > 0
                               sigma'_i = sigma_i             otherwise
                               (effective contributors normalize themselves)
    """

    client_ranks: np.ndarray          # (K,)
    M: int
    beta: float = 1.0
    seed: int = 0

    def run(self, sigma0: np.ndarray, rounds: int, rule: str = "flexlora",
            rank_levels: Optional[Sequence[int]] = None) -> np.ndarray:
        from repro_torch.core.partitions import boundary_of_index
        rng = np.random.default_rng(self.seed)
        K = len(self.client_ranks)
        r_max = len(sigma0)
        sigma = np.asarray(sigma0, dtype=np.float64).copy()
        out = [np.square(sigma)]
        if rule == "raflora":
            levels = rank_levels or sorted(set(self.client_ranks.tolist()))
            h_of_i = boundary_of_index(levels)     # (r_max,)
        for _ in range(rounds):
            sel = rng.choice(K, size=self.M, replace=False)
            ranks = self.client_ranks[sel]
            idx = np.arange(1, r_max + 1)
            n_i = (ranks[:, None] >= idx[None, :]).sum(axis=0)  # (r_max,)
            if rule == "flexlora":
                sigma = self.beta * (n_i / self.M) * sigma
            elif rule == "raflora":
                n_h = np.array([(ranks >= h).sum() for h in h_of_i])
                covered = n_h > 0
                sigma = np.where(covered, self.beta * sigma, sigma)
            else:
                raise ValueError(rule)
            out.append(np.square(sigma))
        return np.asarray(out)                      # (rounds+1, r_max)


def mean_field_step(e: np.ndarray, p: np.ndarray, K: int, M: int, *,
                    beta: float = 1.0, kappa: float = 1.0,
                    delta2: float = 0.0, lam: float = 0.0) -> np.ndarray:
    """One Appendix-B mean-field update:

        E[e^{t+1}] = (1+lam) h(p) E[kappa^2 beta^2] E[e] + delta^2.

    With kappa=1, delta2=0, lam=0 this reduces to the basic recursion.
    """
    qp = (1.0 + lam) * h_sampling(p, K, M) * (kappa ** 2) * (beta ** 2)
    return qp * e + delta2


def mean_field_floor(p: np.ndarray, K: int, M: int, *, beta: float = 1.0,
                     kappa: float = 1.0, delta2: float = 0.0,
                     lam: float = 0.0) -> np.ndarray:
    """Steady-state floor delta^2 / (1 - q') where q' < 1 (Appendix B)."""
    qp = (1.0 + lam) * h_sampling(p, K, M) * (kappa ** 2) * (beta ** 2)
    return np.where(qp < 1.0, delta2 / np.maximum(1.0 - qp, 1e-12), np.inf)
