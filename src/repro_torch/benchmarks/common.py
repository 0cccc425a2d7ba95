"""Shared benchmark infrastructure (a copy of ``benchmarks/common.py``).

Every benchmark prints ``name,us_per_call,derived`` CSV rows (us_per_call =
wall time of the measured unit; derived = the paper-relevant metric, e.g.
accuracy or energy ratio) and returns its rows for run.py aggregation.
Each bench's ``run(device=None)`` runs on the card unless given a
device (``run.py --device``), and the wall clock is read after the card
has finished (``torch.cuda.synchronize``, the counterpart of
``block_until_ready``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import torch

ROWS: List[dict] = []


def emit(name: str, us_per_call: float, derived, **extra) -> dict:
    row = {"name": name, "us_per_call": us_per_call, "derived": derived,
           **extra}
    ROWS.append(row)
    print(f"{name},{us_per_call:.1f},{derived}")
    return row


def merge_artifact(path: str, update: dict) -> dict:
    """Read-modify-write the JSON artifact at ``path`` so studies that
    share it never clobber each other; returns the merged result."""
    result = {}
    if os.path.exists(path):
        with open(path) as f:
            result = json.load(f)
    result.update(update)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
    return result


def sync() -> None:
    """Wait for the card once this process has used it (no-op on a
    CPU-only run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, repeats: int = 3, **kw):
    """(result, us_per_call) with a warmup call; the clock is read after
    the device has finished the warm-up and the repeats."""
    fn(*args, **kw)
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kw)
    sync()
    us = (time.perf_counter() - t0) / repeats * 1e6
    return out, us


def quick_fl(method: str, *, rounds: int = 10, clients: int = 16,
             participation: float = 0.25, seed: int = 0, device=None,
             base_params: Optional[dict] = None, **kw):
    """Small-but-meaningful FL experiment used across the benchmarks.
    ``device``: None is the card; ``base_params`` are the starting
    weights (else drawn from the seed)."""
    from repro_torch.federation.experiment import build_experiment
    over = {"num_rounds": rounds, "num_clients": clients,
            "participation": participation, "seed": seed}
    over.update(kw.pop("fl_overrides", {}))
    kw.setdefault("lora_overrides", {"rank_levels": (4, 8, 16),
                                     "rank_probs": (0.34, 0.33, 0.33)})
    exp = build_experiment(method, fl_overrides=over,
                           num_classes=kw.pop("num_classes", 10),
                           d_model=kw.pop("d_model", 64),
                           samples_per_class=kw.pop("samples_per_class", 50),
                           batches_per_round=kw.pop("batches_per_round", 1),
                           device=device, base_params=base_params, **kw)
    sync()
    t0 = time.perf_counter()
    exp.server.run(rounds)
    sync()
    wall = time.perf_counter() - t0
    return exp, wall
