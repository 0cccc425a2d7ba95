"""host_cost: host-side cost counters for the numpy round path (a copy of
``repro/analysis/host_cost.py``).

The device programs are certified from their op traces; the *host* round
path (planning, registry sampling, weight / staleness computation, event
scheduler) is plain numpy + Python. This module gives it the same
treatment with two signals:

  * **loop iterations** -- federation code calls :func:`tick` at its
    Python loops (one call per loop with ``n=len(...)``, so the hook adds
    O(1) work per loop, not per element). Inactive monitors make ``tick``
    a single global read -- the round path pays one ``is None`` check.
  * **allocated ndarray bytes** -- while a :class:`HostCostMonitor` is
    active, a tracing shim patches the numpy array constructors
    (``np.zeros`` / ``np.asarray`` / ``np.stack`` / ...) on the numpy
    module object and records ``result.nbytes`` per call site. Federation
    modules resolve ``np.X`` at call time through the module, so the shim
    sees every host allocation without touching their code.

Together they give a per-round host cost vector the complexity certifier
(``analysis/complexity.py``) fits scaling exponents over: per-round cost
must track cohort size, NOT registry size -- the tripwire for the
ROADMAP million-client item.

Usage::

    mon = HostCostMonitor()
    with mon:
        for r in range(rounds):
            server.run_round()
            mon.mark(f"round{r}")
    per_round = mon.phases[warmup:]
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

_ACTIVE: Optional["HostCostMonitor"] = None

# numpy constructors worth tracing: everything the round path uses to
# build fresh host arrays. Reductions / ufuncs return tiny scalars and
# are deliberately left alone (patching them would distort timings).
_TRACED_FNS = ("empty", "zeros", "ones", "full", "arange", "array",
               "asarray", "ascontiguousarray", "stack", "concatenate",
               "copy", "pad", "where", "repeat", "tile")


def tick(label: str, n: int = 1) -> None:
    """Record ``n`` iterations of the host loop ``label`` (no-op unless a
    monitor is active)."""
    mon = _ACTIVE
    if mon is not None:
        mon.loop_iters[label] = mon.loop_iters.get(label, 0) + int(n)


def alloc(label: str, nbytes: int) -> None:
    """Record an explicit host allocation (for buffers built outside the
    traced numpy constructors)."""
    mon = _ACTIVE
    if mon is not None:
        mon.alloc_bytes[label] = mon.alloc_bytes.get(label, 0) + int(nbytes)


@dataclass
class HostPhase:
    """Counter deltas between two ``mark()`` calls (one round, usually)."""

    label: str
    loop_iters: int = 0
    alloc_bytes: int = 0
    loop_detail: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"label": self.label, "loop_iters": self.loop_iters,
                "alloc_bytes": self.alloc_bytes,
                "loop_detail": dict(sorted(self.loop_detail.items()))}


class HostCostMonitor:
    """Context manager accumulating host-cost counters; ``mark(label)``
    closes a phase with the deltas since the previous mark (mirrors
    ``dispatch_audit.DispatchMonitor``)."""

    def __init__(self):
        self.loop_iters: Dict[str, int] = {}
        self.alloc_bytes: Dict[str, int] = {}
        self.phases: List[HostPhase] = []
        self._last = (0, 0)
        self._last_loops: Dict[str, int] = {}
        self._saved: Dict[str, object] = {}

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "HostCostMonitor":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("nested HostCostMonitor")
        self._patch_numpy()
        _ACTIVE = self
        self._last = (0, 0)
        self._last_loops = {}
        return self

    def __exit__(self, *exc) -> bool:
        global _ACTIVE
        _ACTIVE = None
        for name, orig in self._saved.items():
            setattr(np, name, orig)
        self._saved.clear()
        return False

    def _patch_numpy(self) -> None:
        for name in _TRACED_FNS:
            orig = getattr(np, name)
            self._saved[name] = orig

            def traced(*args, __orig=orig, __label=f"np.{name}", **kw):
                out = __orig(*args, **kw)
                nb = getattr(out, "nbytes", None)
                if nb:
                    mon = _ACTIVE
                    if mon is not None:
                        mon.alloc_bytes[__label] = (
                            mon.alloc_bytes.get(__label, 0) + int(nb))
                return out

            setattr(np, name, traced)

    # -- accounting --------------------------------------------------------
    @property
    def total_loop_iters(self) -> int:
        return sum(self.loop_iters.values())

    @property
    def total_alloc_bytes(self) -> int:
        return sum(self.alloc_bytes.values())

    def mark(self, label: str) -> HostPhase:
        """Close the current phase: counters since the previous mark."""
        now = (self.total_loop_iters, self.total_alloc_bytes)
        detail = {k: v - self._last_loops.get(k, 0)
                  for k, v in self.loop_iters.items()
                  if v - self._last_loops.get(k, 0)}
        ph = HostPhase(label, loop_iters=now[0] - self._last[0],
                       alloc_bytes=now[1] - self._last[1],
                       loop_detail=detail)
        self._last = now
        self._last_loops = dict(self.loop_iters)
        self.phases.append(ph)
        return ph

    def stats(self) -> dict:
        return {
            "phases": [p.to_json() for p in self.phases],
            "loop_iters": dict(sorted(self.loop_iters.items())),
            "alloc_bytes": dict(sorted(self.alloc_bytes.items())),
            "total_loop_iters": self.total_loop_iters,
            "total_alloc_bytes": self.total_alloc_bytes,
        }


def measure_rounds(server, rounds: int = 3, warmup: int = 1,
                   flush: bool = True) -> dict:
    """Run ``rounds`` federated rounds under a monitor and return the
    mean per-round host cost over the post-warmup phases.

    The warmup rounds absorb one-time set-up (first-use allocations,
    buffer fills) so the steady-state mean reflects the recurring host
    cost the scaling contracts constrain.
    """
    mon = HostCostMonitor()
    with mon:
        for r in range(rounds):
            server.run_round()
            if flush:
                server.flush_stats()
            mon.mark(f"round{r}")
    steady = mon.phases[warmup:] or mon.phases
    k = float(len(steady))
    return {
        "loop_iters": sum(p.loop_iters for p in steady) / k,
        "alloc_bytes": sum(p.alloc_bytes for p in steady) / k,
        "phases": [p.to_json() for p in mon.phases],
    }
