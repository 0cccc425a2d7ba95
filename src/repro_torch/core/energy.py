"""Energy-spectrum metrics (Section 3 / Definition 1 of the paper).

"Energy" = squared singular values. ``rho_r`` is the normalized cumulative
energy ratio; rank collapse = (1 - rho_{r_1}) -> 0 over rounds.

All metrics here are computed in NUMPY: they are host-side bookkeeping
on the server's round path, and a copy of ``repro.core.energy`` so the
two packages agree exactly. Inputs are numpy arrays (the server moves the
probe spectrum to the host once per round).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


def energies(sigma) -> np.ndarray:
    """e_i = sigma_i^2 (descending order preserved)."""
    return np.square(np.asarray(sigma, np.float32))


def cumulative_energy(sigma, r: int) -> np.ndarray:
    """E_r = sum_{i<=r} e_i."""
    return energies(sigma)[:r].sum()


def rho(sigma, r: int) -> np.ndarray:
    """rho_r = E_r / E_{r_max} in [0, 1]."""
    e = energies(sigma)
    total = e.sum()
    return np.where(total > 0, e[:r].sum() / np.maximum(total, 1e-30), 0.0)


def higher_rank_energy_ratio(sigma, r1: int) -> np.ndarray:
    """1 - rho_{r1}: the quantity whose decay defines rank collapse."""
    return 1.0 - rho(sigma, r1)


def effective_rank(sigma, eps: float = 1e-12) -> np.ndarray:
    """Entropy-based effective rank (Roy & Vetterli): exp(H(p)), p = e/sum e."""
    e = energies(sigma)
    p = e / np.maximum(e.sum(), eps)
    h = -np.sum(np.where(p > 0, p * np.log(np.maximum(p, eps)), 0.0))
    return np.exp(h)


def energy_breakdown(sigma,
                     rank_levels: Sequence[int]) -> dict:
    """Per-partition energy fractions (the stacked bars of Figure 2a/2b)."""
    from repro_torch.core.partitions import partition_bounds
    e = np.asarray(energies(sigma))
    total = max(float(e.sum()), 1e-30)
    out = {}
    for (l, h) in partition_bounds(rank_levels):
        out[f"rank_{l}_{h}"] = float(e[l - 1:h].sum() / total)
    return out


@dataclass
class EnergyTrace:
    """Round-by-round energy statistics of one adapter (or model average)."""

    rank_levels: Sequence[int]
    rho_r1: Optional[list] = None
    eff_rank: Optional[list] = None
    breakdown: Optional[list] = None

    def __post_init__(self):
        # default_factory semantics: None means "fresh empty trace", while
        # caller-provided histories (e.g. checkpoint restore) are kept --
        # the old unconditional reset silently discarded them
        self.rho_r1 = [] if self.rho_r1 is None else list(self.rho_r1)
        self.eff_rank = [] if self.eff_rank is None else list(self.eff_rank)
        self.breakdown = ([] if self.breakdown is None
                          else list(self.breakdown))

    def state_dict(self) -> dict:
        """JSON-serializable trace state for checkpoint metadata."""
        return {"rank_levels": [int(r) for r in self.rank_levels],
                "rho_r1": list(self.rho_r1),
                "eff_rank": list(self.eff_rank),
                "breakdown": list(self.breakdown)}

    @classmethod
    def from_state(cls, state: dict) -> "EnergyTrace":
        return cls(rank_levels=tuple(state["rank_levels"]),
                   rho_r1=state.get("rho_r1"),
                   eff_rank=state.get("eff_rank"),
                   breakdown=state.get("breakdown"))

    def record(self, sigma) -> None:
        r1 = min(self.rank_levels)
        self.rho_r1.append(float(rho(sigma, r1)))
        self.eff_rank.append(float(effective_rank(sigma)))
        self.breakdown.append(energy_breakdown(sigma, self.rank_levels))

    @property
    def higher_rank_ratio(self) -> np.ndarray:
        return 1.0 - np.asarray(self.rho_r1)

    def collapsed(self, threshold: float = 0.05) -> bool:
        """Definition 1: higher-rank energy has become negligible.

        Before any ``record()`` there is no spectrum to judge, so an empty
        trace is never collapsed."""
        if not self.rho_r1:
            return False
        return bool(self.higher_rank_ratio[-1] < threshold)
