"""The profiler's device trace, reduced to what the per-layer readers need.

``Tracer`` runs ``torch.profiler`` (host and CUDA activity) over a
window, exports its trace into a temporary file (under ``TMPDIR``), reads
it and deletes it. ``Trace`` holds the device operations (kernels,
copies, fills) with the host time of the call that launched each, the
benchmark's own host ranges (``torch.profiler.record_function`` names
that start with ``RANGE``), and the host's operators, and answers:

* ``busy_s``: the seconds in which some operation ran on the device;
* ``device_s(name)``: the device time of the operations launched while a
  range of that name was open on the host, each counted once, whatever
  the operation is called;
* ``top_ops`` and ``idle_by_host``: the breakdown of the result line.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

RANGE = "fedbench::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        launch = {}
        self.ranges = defaultdict(list)
        host = []
        dev = []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat is None:
                continue
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = e["ts"]
            elif cat in HOST_CATS:
                if cat == "user_annotation" and e["name"].startswith(RANGE):
                    self.ranges[e["name"][len(RANGE):]].append(
                        (e["ts"], e["ts"] + e.get("dur", 0)))
                host.append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
        # (start us, end us, name, host launch time us or None)
        self.ops = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"],
                           launch.get(e.get("args", {}).get("correlation")))
                          for e in dev)
        for name in self.ranges:
            self.ranges[name].sort()
        host.sort()
        self.host = host
        self.host_starts = [h[0] for h in host]

    # -- device activity --------------------------------------------------------

    def _busy(self) -> list:
        """Merged intervals of device activity (us)."""
        merged = []
        for s, e, _, _ in self.ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) * 1e-6

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside range ``name``
        (the benchmark opens ranges of one name one after another, never
        one inside another, so each operation counts once)."""
        spans = self.ranges.get(name, [])
        if not spans:
            return 0.0
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _, at in self.ops:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += e - s
        return total * 1e-6

    # -- breakdown ----------------------------------------------------------------

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name, _ in self.ops:
            by[name] += (e - s) * 1e-6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost host operator or range open at host time t."""
        i = bisect.bisect_right(self.host_starts, t) - 1
        best = None
        for j in range(i, max(i - 200, -1), -1):
            s, e, name = self.host[j]
            if s <= t <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        return best[1] if best else "host: outside any operator"

    def idle_by_host(self, n: int = 10) -> list:
        """Idle device time between operations, summed by what the host
        was doing when the gap opened; the largest ``n``."""
        by = defaultdict(float)
        busy = self._busy()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            by[self._host_at(e0)] += (s1 - e0) * 1e-6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class Tracer:
    """``with Tracer(torch) as tr: ...``; then ``tr.read()``, once the
    measured work is over."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            self.torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        """Export the trace into a temporary file, read it, delete it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        return Trace(events, self.window_s)
