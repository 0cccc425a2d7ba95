"""Complexity certifier: scaling-law contracts over measured cost vectors
(a copy of ``repro/analysis/complexity.py`` whose device costs come from
op traces).

A sweep (``python -m repro_torch.tools.certify_scaling``) runs every
engine x backend x method aggregation program at a geometric ladder of
problem sizes along each axis and extracts a cost vector per point:

  device metrics (from ``analysis/op_lint`` + ``analysis/liveness``)
      dot_flops, hbm_bytes, collective_bytes, collective_count,
      peak_live_bytes
  host metrics (from ``analysis/host_cost`` over real tiny rounds)
      host_loop_iters, host_alloc_bytes

Per (axis, metric) we fit a log-log least-squares slope -- the empirical
scaling exponent -- and gate it against the declared CONTRACTS catalog
(the reference's, unchanged): e.g. factored/kernel aggregation flops and
peak-live bytes must stay ~linear along the joint d=n axis (the
O((d+n)R) claim), sharded collective bytes must track the factor
perimeter rather than d*n, the per-bucket all-reduce count must not grow
with shard count, and per-round host cost must be independent of
registry size (the ROADMAP million-client tripwire). The dense backend
carries *min*-slope contracts: it MUST certify O(d*n) -- if the dense
positive control stops looking quadratic, the measurement pipeline
itself is broken. On the CPU the kernel backend runs the plain versions
of K1 and K2, which are O((d+n)R) too, so the low-rank contracts hold
there; on the card the kernels' resident set is the allocator's.

Joint-axis design note: a single-axis d ladder cannot separate O(d*n)
from O((d+n)R) -- both are linear in d alone. The distinguishing axis is
"dn" (d = n = s scaled together): dense slope ~2, factored/kernel ~1.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.rules import Finding, ProgramContext, RuleSet

_EPS = 1e-9


def fit_slope(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Log-log least-squares slope of ``ys`` against ``xs``.

    An all-zero series fits as slope 0 (a metric that never appears
    scales as O(1)); isolated zeros are clamped to a tiny epsilon, so a
    cost that *appears* along the ladder (0 -> positive) yields a huge
    positive slope and trips any max-slope contract -- the conservative
    reading.
    """
    if len(xs) != len(ys) or len(xs) < 2:
        raise ValueError("need >= 2 aligned points")
    if all(y <= 0 for y in ys):
        return 0.0
    lx = [math.log(float(x)) for x in xs]
    ly = [math.log(max(float(y), _EPS)) for y in ys]
    n = float(len(lx))
    mx, my = sum(lx) / n, sum(ly) / n
    den = sum((a - mx) ** 2 for a in lx)
    if den == 0.0:
        raise ValueError("degenerate ladder: all x equal")
    return sum((a - mx) * (b - my) for a, b in zip(lx, ly)) / den


@dataclass(frozen=True)
class Measurement:
    """One ladder point: the cost vector at coordinate ``x`` of ``axis``."""
    axis: str
    x: float
    costs: Dict[str, float]


@dataclass
class ScalingRow:
    """All measurements for one program (or the host round path)."""

    program: str                      # e.g. "batched/raflora/kernel"
    engine: str
    method: str
    backend: str
    measurements: List[Measurement] = field(default_factory=list)

    def axes(self) -> List[str]:
        seen = []
        for m in self.measurements:
            if m.axis not in seen:
                seen.append(m.axis)
        return seen

    def slopes(self) -> Dict[Tuple[str, str], float]:
        """{(axis, metric): fitted exponent} over every measured axis."""
        out: Dict[Tuple[str, str], float] = {}
        for axis in self.axes():
            pts = sorted((m for m in self.measurements if m.axis == axis),
                         key=lambda m: m.x)
            if len(pts) < 2:
                continue
            xs = [p.x for p in pts]
            metrics = sorted({k for p in pts for k in p.costs})
            for met in metrics:
                ys = [p.costs.get(met, 0.0) for p in pts]
                out[(axis, met)] = fit_slope(xs, ys)
        return out

    def stats(self) -> dict:
        """JSON view for the audit artifact (slopes rounded for diff
        stability; contracts are evaluated on the unrounded values)."""
        ladder = {}
        for axis in self.axes():
            ladder[axis] = sorted(
                {m.x for m in self.measurements if m.axis == axis})
        return {
            "slopes": {f"{axis}/{met}": round(v, 3) + 0.0  # kill -0.0
                       for (axis, met), v in sorted(self.slopes().items())},
            "ladder": ladder,
        }


@dataclass(frozen=True)
class Contract:
    """A declared bound on one (axis, metric) exponent for a slice of the
    program matrix. ``None`` selectors match anything."""

    name: str
    metric: str
    axis: str
    max_slope: Optional[float] = None
    min_slope: Optional[float] = None
    engines: Optional[Tuple[str, ...]] = None
    methods: Optional[Tuple[str, ...]] = None
    backends: Optional[Tuple[str, ...]] = None
    note: str = ""

    def applies(self, engine: str, method: str, backend: str) -> bool:
        return ((self.engines is None or engine in self.engines)
                and (self.methods is None or method in self.methods)
                and (self.backends is None or backend in self.backends))


_SVD = ("flexlora", "raflora")
_LOWRANK = ("factored", "kernel")

# -- the contract catalog ---------------------------------------------------
# max_slope headroom: a pure O(s) series fits 1.0 exactly; constant-plus-
# linear terms and lane padding bend small-ladder fits by ~0.2, so linear
# claims gate at 1.35 and quadratic certifications at >= 1.6.
CONTRACTS: Tuple[Contract, ...] = (
    # O((d+n)R) aggregation: flops / resident set / HBM traffic of the
    # low-rank backends stay ~linear when d and n scale TOGETHER
    Contract("agg-flops-linear-dn", "dot_flops", "dn", max_slope=1.35,
             methods=_SVD, backends=_LOWRANK,
             note="SVD-family low-rank aggregation flops ~ O((d+n)R M)"),
    Contract("agg-live-linear-dn", "peak_live_bytes", "dn", max_slope=1.35,
             methods=_SVD, backends=("factored",),
             note="no (d, n)-scale resident intermediate on the low-rank "
                  "path"),
    Contract("agg-live-linear-dn-kernel", "peak_live_bytes", "dn",
             max_slope=1.35, methods=_SVD, backends=("kernel",),
             engines=("sequential", "batched", "async", "event"),
             note="kernel-backend resident set stays linear on the "
                  "single-device engines; sharded rows are excluded -- "
                  "their CPU interpret-mode grid lowers to a while loop "
                  "whose carried tuple holds whole padded stack buffers "
                  "(liveness sees the carry, an interpreter artifact; the "
                  "sharded kernel path is gated via flops, collectives "
                  "and the shards axis instead)"),
    Contract("agg-hbm-linear-dn", "hbm_bytes", "dn", max_slope=1.35,
             methods=_SVD, backends=("factored",),
             note="HBM traffic tracks the factor perimeter, not the "
                  "product (factored only: the kernel backend's CPU "
                  "interpret-mode grid loop carries whole-buffer copies "
                  "per step, an artifact gated via flops + live instead)"),
    Contract("avg-live-linear-dn", "peak_live_bytes", "dn", max_slope=1.35,
             methods=("fedavg", "hetlora", "ffa"),
             note="averaging-family aggregation never forms B@A (flora's "
                  "dense merge_delta is by design and excluded)"),
    # communication: sharded collective bytes follow the factors; the
    # per-bucket psum count is independent of the shard count
    Contract("collective-linear-dn", "collective_bytes", "dn",
             max_slope=1.35, engines=("sharded",), methods=_SVD,
             backends=_LOWRANK,
             note="collective bytes ~ d*W + W*n beyond the factor term, "
                  "never d*n"),
    Contract("collective-count-shards", "collective_count", "shards",
             max_slope=0.2, engines=("sharded",),
             note="one psum per bucket regardless of mesh size"),
    # cohort / rank axes: Gram-style cores are quadratic in the stacked
    # width M*R (that IS the O((d+n) R^2 M^2) SVD-realloc budget) but must
    # not go cubic
    Contract("agg-flops-cohort", "dot_flops", "m", max_slope=2.4,
             methods=_SVD, backends=_LOWRANK,
             note="stacked-width Gram/QR cost <= quadratic in cohort"),
    Contract("agg-flops-rank", "dot_flops", "r", max_slope=2.5,
             methods=_SVD, backends=_LOWRANK,
             note="stacked-width Gram/QR cost <= quadratic in r_max"),
    Contract("avg-flops-cohort", "dot_flops", "m", max_slope=1.4,
             methods=("fedavg", "hetlora", "ffa", "flora"),
             note="weighted averaging is linear in cohort size"),
    # positive-control contracts: the dense backend MUST look quadratic
    # along dn -- if it stops certifying O(d*n) the ladder, the walker or
    # the liveness pass is broken, not the backend
    Contract("dense-cert-flops", "dot_flops", "dn", min_slope=1.6,
             methods=_SVD, backends=("dense",),
             note="dense backend certifies O(d*n) flops (measurement "
                  "positive control)"),
    Contract("dense-cert-live", "peak_live_bytes", "dn", min_slope=1.6,
             methods=_SVD, backends=("dense",),
             note="dense backend certifies an O(d*n) resident buffer"),
    # host round path: per-round cost tracks the cohort, NEVER the
    # registry (ROADMAP million-client tripwire)
    Contract("host-registry-iters", "host_loop_iters", "registry",
             max_slope=0.15, engines=("host",),
             note="per-round host loop iterations independent of "
                  "registered-client count"),
    Contract("host-registry-alloc", "host_alloc_bytes", "registry",
             max_slope=0.15, engines=("host",),
             note="per-round host ndarray bytes independent of "
                  "registered-client count"),
    Contract("host-cohort-iters", "host_loop_iters", "m", min_slope=0.3,
             max_slope=1.5, engines=("host",),
             note="per-round host work scales with the sampled cohort "
                  "(sublinear would mean the counters went dead)"),
)


SCALING_RULES = RuleSet("scaling")


@SCALING_RULES.rule(
    "scaling-contract",
    "every fitted (axis, metric) exponent of the program stays inside the "
    "declared complexity contract bounds (meta['contracts'])")
def _check_contracts(ctx: ProgramContext):
    contracts = ctx.meta.get("contracts")
    if not contracts:
        return
    row = ctx.payload
    slopes = row.slopes()
    for c in contracts:
        if not c.applies(row.engine, row.method, row.backend):
            continue
        s = slopes.get((c.axis, c.metric))
        if s is None:
            continue                  # axis not measured for this row
        if c.max_slope is not None and s > c.max_slope:
            yield (f"{c.name}: {c.metric} ~ {c.axis}^{s:.2f} exceeds "
                   f"max exponent {c.max_slope} ({c.note})",
                   f"{c.axis}/{c.metric}")
        if c.min_slope is not None and s < c.min_slope:
            yield (f"{c.name}: {c.metric} ~ {c.axis}^{s:.2f} below "
                   f"min exponent {c.min_slope} ({c.note})",
                   f"{c.axis}/{c.metric}")


def evaluate_row(row: ScalingRow,
                 contracts: Sequence[Contract] = CONTRACTS
                 ) -> List[Finding]:
    """Findings for every contract the row's fitted exponents violate."""
    ctx = ProgramContext(program=row.program, kind="scaling", payload=row,
                         meta={"contracts": tuple(contracts)})
    return SCALING_RULES.run(ctx)


def dense_control_contracts() -> Tuple[Contract, ...]:
    """The linear (low-rank path) contracts re-targeted at the dense
    backend: evaluating a dense row against THESE must produce findings.
    A dense row sliding under them means the tripwire is dead."""
    out = []
    for c in CONTRACTS:
        if (c.max_slope is not None and c.backends
                and set(c.backends) <= set(_LOWRANK)):
            out.append(replace(c, backends=("dense",),
                               name=c.name + "@dense-control"))
    return tuple(out)


def device_costs(trace, liveness) -> Dict[str, float]:
    """Cost vector of one traced program: ``op_lint.OpTrace`` and
    ``liveness.LivenessStats`` of the same call."""
    return {
        "dot_flops": float(trace.flops),
        "hbm_bytes": float(trace.hbm_bytes),
        "collective_bytes": float(trace.collective_bytes),
        "collective_count": float(trace.collective_count),
        "peak_live_bytes": float(liveness.peak_live_bytes),
    }
