"""Peak live bytes of one call (the port's counterpart of
``repro/analysis/liveness.py``, which estimates it from the HLO schedule).

A PyTorch call's resident set is what its allocator holds, so the port
measures it instead of modelling it:

  * on the CPU, ``torch.profiler.profile(profile_memory=True)`` records
    every allocation and free of the call as a ``[memory]`` event with a
    signed byte count; the peak is the maximum of their running sum in
    time order;
  * on the card, the caching allocator's ``max_memory_allocated`` delta
    over the call, after ``reset_peak_memory_stats``.

Both count only what the call itself allocates on top of what was live
before it (its inputs are not counted), which is what the complexity
certifier needs: a program that keeps its flops at O((d+n)R) but forms a
(d, n) temporary has a peak that grows as d*n, and the certifier fits
the slope of this number along a size ladder.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class LivenessStats:
    """Result of :func:`measure`."""

    peak_live_bytes: float = 0.0
    device: str = "cpu"
    events: int = 0                 # allocator events seen (CPU only)


def _cpu_peak(fn: Callable) -> LivenessStats:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"
                     and e.device_type() == torch.autograd.DeviceType.CPU),
                    key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return LivenessStats(float(peak), "cpu", len(events))


def _cuda_peak(fn: Callable, device: torch.device) -> LivenessStats:
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    fn()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    return LivenessStats(float(peak), str(device))


def measure(fn: Callable, device="cpu") -> LivenessStats:
    """Peak bytes the call ``fn()`` holds live on ``device`` on top of
    what was allocated before it."""
    device = torch.device(device)
    if device.type == "cuda":
        return _cuda_peak(fn, device)
    if device.type != "cpu":
        raise ValueError(f"no liveness measurement for {device}")
    return _cpu_peak(fn)

