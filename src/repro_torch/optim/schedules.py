"""Learning-rate schedules (paper: linear decay per round)."""
from __future__ import annotations


def linear_decay(base_lr: float, num_rounds: int):
    """Paper setting: lr decays linearly over communication rounds."""
    def schedule(round_idx: int) -> float:
        frac = 1.0 - round_idx / max(num_rounds, 1)
        return base_lr * max(frac, 0.0)
    return schedule


def constant(base_lr: float):
    def schedule(round_idx: int) -> float:
        return base_lr
    return schedule


def get_schedule(name: str, base_lr: float, num_rounds: int):
    if name == "linear":
        return linear_decay(base_lr, num_rounds)
    if name == "constant":
        return constant(base_lr)
    raise ValueError(f"unknown schedule {name!r}")
