"""dispatch_audit: the port's recompile and eager-dispatch auditor (the
counterpart of ``repro/analysis/dispatch_audit.py``).

A PyTorch round has no jit cache to miss: every round re-issues its aten
ops from Python, and its hand-written kernels are built once, at first
use. The torch form of "steady-state rounds compile nothing new" is
therefore: after the warmup no kernel library is built or loaded, and
every steady round runs the SAME multiset of aten ops as the first
steady round (a shape-varying or data-dependent round shows up as a
changed multiset). A ``DispatchMonitor`` is a ``TorchDispatchMode``
whose ``mark(label)`` closes a phase with, since the previous mark:

  * aten ops, by name and output shapes (``aten.mm[(4, 8)]``), so a
    shape-varying round changes the multiset as a retrace would;
  * host syncs: ``aten._local_scalar_dense`` (``.item()``, ``float()``,
    ``bool()``), ``aten.is_nonzero``, ``aten.equal``, device-to-host
    ``_to_copy`` / ``copy_``, and ``.tolist()`` / ``.numpy()``, which
    dispatch no op and are wrapped while the monitor runs (a copy's
    result read by ``.numpy()`` counts once);
  * kernel library builds and loads (``kernels/build.py``'s ``builds``
    and ``loads``) and the launches of every kernel wrapper.

Usage::

    mon = DispatchMonitor()
    with mon:
        for r in range(rounds):
            server.run_round()
            mon.mark(f"round{r}")
    findings = lint_dispatch(mon, "audit/steady", meta={"warmup": 1})

Rules:

  dispatch-steady-state     after meta['warmup'] phases (default 1): no
                            library built or loaded, and every phase's op
                            multiset equals that of the steady phase
                            meta['period'] phases before it (default 1;
                            the async engine at pipeline depth k cycles
                            through k rounds, k - 1 of them filling the
                            buffer)
  dispatch-host-sync-budget host syncs per steady phase within
                            meta['max_host_syncs_per_phase'] (opt-in; the
                            counterpart of ``dispatch-eager-budget``)
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis.op_lint import _launch_counts, _Recorder, _tensors
from repro_torch.analysis.rules import ProgramContext, RuleSet


@dataclass
class PhaseCounters:
    label: str
    ops: Counter = field(default_factory=Counter)
    host_syncs: Counter = field(default_factory=Counter)
    builds: int = 0
    loads: int = 0
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def op_count(self) -> int:
        return sum(self.ops.values())

    @property
    def sync_count(self) -> int:
        return sum(self.host_syncs.values())

    def to_json(self) -> dict:
        return {"label": self.label, "ops": self.op_count,
                "distinct_ops": len(self.ops),
                "host_syncs": self.sync_count,
                "host_sync_detail": dict(sorted(self.host_syncs.items())),
                "builds": self.builds, "loads": self.loads,
                "launches": dict(sorted(self.launches.items()))}


_ACTIVE_MONITOR: Optional["DispatchMonitor"] = None


def _build_counts():
    from repro_torch.kernels import build
    return build.builds, build.loads


class DispatchMonitor(_Recorder):
    """Context manager accumulating per-phase dispatch counters."""

    def __init__(self):
        super().__init__()
        self._ops: Counter = Counter()
        self._syncs: Counter = Counter()
        self.phases: List[PhaseCounters] = []
        self._last_builds = (0, 0)
        self._last_launches: Dict[str, int] = {}

    def __enter__(self):
        global _ACTIVE_MONITOR
        if _ACTIVE_MONITOR is not None:
            raise RuntimeError("nested DispatchMonitor")
        _ACTIVE_MONITOR = self
        self._last_builds = _build_counts()
        self._last_launches = _launch_counts()
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE_MONITOR
        _ACTIVE_MONITOR = None
        return super().__exit__(*exc)

    def host_read(self, kind: str) -> None:
        self._syncs[kind] += 1

    def op(self, name: str, args, out) -> None:
        shapes = [tuple(t.shape) for t in _tensors(out)]
        self._ops[f"{name}{shapes}"] += 1

    def mark(self, label: str) -> PhaseCounters:
        """Close the current phase: counters since the previous mark."""
        builds, launches = _build_counts(), _launch_counts()
        ph = PhaseCounters(
            label, ops=self._ops, host_syncs=self._syncs,
            builds=builds[0] - self._last_builds[0],
            loads=builds[1] - self._last_builds[1],
            launches={k: n - self._last_launches.get(k, 0)
                      for k, n in launches.items()
                      if n != self._last_launches.get(k, 0)})
        self._ops, self._syncs = Counter(), Counter()
        self._last_builds, self._last_launches = builds, launches
        self.phases.append(ph)
        return ph

    def stats(self) -> dict:
        return {
            "phases": [p.to_json() for p in self.phases],
            "total_ops": sum(p.op_count for p in self.phases),
            "total_host_syncs": sum(p.sync_count for p in self.phases),
            "total_builds": sum(p.builds for p in self.phases),
            "total_loads": sum(p.loads for p in self.phases),
        }


DISPATCH_RULES = RuleSet("dispatch")


def _multiset_diff(a: Counter, b: Counter, limit: int = 4) -> str:
    keys = sorted(set(a) | set(b), key=lambda k: -abs(a[k] - b[k]))
    return ", ".join(f"{k} {b[k]}->{a[k]}" for k in keys[:limit]
                     if a[k] != b[k])


@DISPATCH_RULES.rule(
    "dispatch-steady-state",
    "after the first meta['warmup'] phases (default 1) no kernel library "
    "is built or loaded, and every phase runs the same aten op multiset as "
    "the steady phase meta['period'] phases earlier (default 1): shape-"
    "stable, data-independent rounds")
def _check_steady_state(ctx: ProgramContext):
    warmup = ctx.meta.get("warmup", 1)
    period = ctx.meta.get("period", 1)
    steady = ctx.payload.phases[warmup:]
    for i, ph in enumerate(steady):
        if ph.builds or ph.loads:
            yield (f"{ph.builds} kernel build(s) + {ph.loads} library "
                   f"load(s) in steady-state phase", ph.label)
        ref = steady[i % period]
        if ph is not ref and ph.ops != ref.ops:
            yield (f"op multiset differs from {ref.label}'s "
                   f"({ph.op_count} vs {ref.op_count} ops: "
                   f"{_multiset_diff(ph.ops, ref.ops)})", ph.label)


@DISPATCH_RULES.rule(
    "dispatch-host-sync-budget",
    "host syncs per steady-state phase within "
    "meta['max_host_syncs_per_phase'] (each one stalls the host on the "
    "card; opt-in threshold)")
def _check_sync_budget(ctx: ProgramContext):
    budget = ctx.meta.get("max_host_syncs_per_phase")
    if budget is None:
        return
    warmup = ctx.meta.get("warmup", 1)
    for ph in ctx.payload.phases[warmup:]:
        if ph.sync_count > budget:
            yield (f"{ph.sync_count} host syncs > budget {budget} "
                   f"({dict(ph.host_syncs)})", ph.label)


def lint_dispatch(monitor: DispatchMonitor, program: str,
                  meta: Optional[dict] = None,
                  only: Optional[Iterable[str]] = None):
    ctx = ProgramContext(program=program, kind="dispatch", payload=monitor,
                         meta=dict(meta or {}))
    return DISPATCH_RULES.run(ctx, only=only)
