"""Complexity-certifier sweep (DESIGN.md §9) of the port: run every engine
x backend x method aggregation program at a geometric ladder of problem
sizes, fit log-log scaling exponents per axis from op traces and peak
live bytes, gate them against the contract catalog
(``analysis/complexity.CONTRACTS``) and write
``build/audit_torch/AUDIT_scaling.json``.

    PYTHONPATH=src python -m repro_torch.tools.certify_scaling [--out PATH]
        [--fast] [--device cpu|cuda]

``--device`` defaults to the card; ``--device cpu`` runs the device rows
on the CPU.

Axes and ladders (the reference's):

  dn        d = n = s together -- the axis that separates O(d*n) from
            O((d+n)R): dense slope ~2, factored/kernel ~1. All engines.
  d, n      single-axis ladders (batched engine rows).
  m         clients per rank group (batched rows).
  r         r_max via single-level rank_levels=(r,) (batched rows).
  shards    ranks of the sharded engine's group: one gloo group of S
            processes on this host per ladder point, each rank running
            every sharded row (``launch.mesh.spawn_ranks``).
  registry  registered-client count at FIXED cohort, measured as host
            counters over real tiny rounds (``analysis/host_cost``) on
            the batched AND event engines.
  (host) m  sampled-cohort ladder of the same host counters.

Each point's device costs are the op trace's FLOPs (``FlopCounterMode``),
bytes and counted all-reduces (``analysis/op_lint``) and the call's peak
live bytes (``analysis/liveness``: profiler memory events on the CPU,
the allocator's peak on the card), each from one call of the program.

Positive controls (the sweep FAILS if any does NOT trip, or raises): the
dense backend must certify O(d*n) against the low-rank contracts
(``dense-dn-superlinear``), and an injected O(registry) host scan must
trip the registry contract (``host-registry-scan``).

Exit status: 0 all contracts hold + controls tripped, 1 otherwise, 2 on
usage errors.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from repro_torch.tools import audit_path

DN_LADDER = (128, 256, 512)
M_LADDER = (2, 4, 8)
R_LADDER = (8, 16)
SHARD_LADDER = (2, 4, 8)
HOST_K_LADDER = (1_000, 10_000, 100_000)
HOST_M_LADDER = (4, 8, 16)
HOST_NUM_CLIENTS = 32
HOST_ROUNDS, HOST_WARMUP = 3, 1
EVENT_ROUNDS, EVENT_WARMUP = 4, 2

FAST_DN_LADDER = (128, 256)
FAST_M_LADDER = (2, 4)
FAST_SHARD_LADDER = (2, 4)
FAST_HOST_K_LADDER = (1_000, 10_000)
FAST_HOST_M_LADDER = (4, 8)


def _device_rows(fast: bool):
    """(engine, method, backend_label) rows; '-' = averaging family (run
    on the factored default, backend-independent)."""
    from repro_torch.analysis.op_lint import BACKENDS, ENGINES, SVD_METHODS
    engines = ("batched", "sharded") if fast else ENGINES
    svd = ("raflora",) if fast else SVD_METHODS
    avg = ("fedavg",) if fast else ("fedavg", "hetlora", "ffa", "flora")
    rows = []
    for engine in engines:
        for method in avg:
            rows.append((engine, method, "-"))
        for method in svd:
            for backend in BACKENDS:
                rows.append((engine, method, backend))
    return rows


def _base_point(engine: str, method: str, label: str):
    from repro_torch.analysis.op_lint import ProgramPoint
    return ProgramPoint(engine=engine, method=method,
                        backend="factored" if label == "-" else label,
                        d=DN_LADDER[0], n=DN_LADDER[0], rank_levels=(8,),
                        m_per_group=M_LADDER[0], p_bucket=1,
                        depth=2 if engine == "async" else 1)


def point_costs(pt, device="cpu", mesh=None) -> dict:
    """Device cost vector of one program point: one traced call and one
    call under the liveness measurement."""
    from repro_torch.analysis import complexity, liveness, op_lint
    fn = op_lint.program_fn(pt, device=device, mesh=mesh)
    with torch.no_grad():
        trace, _ = op_lint.trace_ops(fn)
        live = liveness.measure(fn, device)
    return complexity.device_costs(trace, live)


def _measure_device_row(engine: str, method: str, label: str, fast: bool,
                        device="cpu", mesh=None, shard_costs=None):
    """ScalingRow of one program: every ladder point of every axis that
    applies to its engine. ``shard_costs``: {S: costs} of the sharded
    row measured in S-rank groups."""
    from repro_torch.analysis.complexity import Measurement, ScalingRow
    base = _base_point(engine, method, label)
    dn = FAST_DN_LADDER if fast else DN_LADDER
    ms = FAST_M_LADDER if fast else M_LADDER
    meas = []

    def probe(axis, x, pt):
        meas.append(Measurement(axis, float(x),
                                point_costs(pt, device, mesh)))

    for s in dn:
        probe("dn", s, base.scaled(d=s, n=s))
    if engine == "batched" and not fast:
        for s in dn[1:]:
            probe("d", s, base.scaled(d=s))
            probe("n", s, base.scaled(n=s))
        probe("d", dn[0], base)
        probe("n", dn[0], base)
    if engine == "batched":
        for m in ms:
            probe("m", m * base.depth, base.scaled(m_per_group=m))
    if engine == "batched" and not fast:
        for r in R_LADDER:
            probe("r", r, base.scaled(rank_levels=(r,)))
    for s, costs in sorted((shard_costs or {}).items()):
        meas.append(Measurement("shards", float(s), costs))
    return ScalingRow(program=f"{engine}/{method}/{label}", engine=engine,
                      method=method, backend=label if label != "-"
                      else "factored", measurements=meas)


def _sharded_rank_costs(rank: int, world: int, rows) -> dict:
    """One rank of an S-rank group: the base point's costs of every
    sharded row (rank 0's are returned; every rank runs the same
    collectives)."""
    from repro_torch.launch.mesh import make_fl_mesh
    torch.set_num_threads(1)
    mesh = make_fl_mesh(device="cpu")
    return {row: point_costs(_base_point(*row), "cpu", mesh)
            for row in rows}


def _shard_ladder_costs(rows, fast: bool) -> dict:
    """{row: {S: costs}} over the shard ladder, one spawned group a
    point."""
    from repro_torch.launch.mesh import spawn_ranks
    rows = [r for r in rows if r[0] == "sharded"]
    out = {row: {} for row in rows}
    if not rows:
        return out
    for s in FAST_SHARD_LADDER if fast else SHARD_LADDER:
        costs = spawn_ranks(_sharded_rank_costs, s, rows)[0]
        for row in rows:
            out[row][s] = costs[row]
    return out


# -- host round path --------------------------------------------------------

def _build_host_experiment(event: bool, device="cpu"):
    """Tiny real federation whose registry can be inflated between
    measurements: iid partition (equal shard sizes keep per-round byte
    counts shape-stable), a single rank level (one train group, so loop
    counters are a deterministic function of cohort size only)."""
    from repro_torch.federation.experiment import build_experiment
    if event:
        from repro_torch.federation.events import (ConstantLatency,
                                                   CountTrigger,
                                                   EventScheduler)
        cohort = HOST_NUM_CLIENTS // 4
        kwargs = dict(round_engine="async", pipeline_depth=1,
                      event_scheduler=EventScheduler(
                          ConstantLatency(1.0), CountTrigger(cohort)))
    else:
        kwargs = dict(round_engine="batched")
    return build_experiment(
        "raflora",
        fl_overrides={"num_rounds": 200, "num_clients": HOST_NUM_CLIENTS,
                      "participation": 0.25, "partition": "iid"},
        lora_overrides={"rank_levels": (8,), "rank_probs": (1.0,)},
        num_classes=4, d_model=32, samples_per_class=40,
        batches_per_round=1, backend="factored", device=device, **kwargs)


def _host_costs(server, rounds: int, warmup: int) -> dict:
    from repro_torch.analysis import host_cost
    cost = host_cost.measure_rounds(server, rounds=rounds, warmup=warmup)
    return {"host_loop_iters": cost["loop_iters"],
            "host_alloc_bytes": cost["alloc_bytes"]}


def measure_host_rows(fast: bool, verbose: bool = False, device="cpu"):
    """Host-counter ScalingRows: registry ladder on the batched and event
    engines, cohort ladder on the batched engine."""
    from repro_torch.analysis.complexity import Measurement, ScalingRow
    ks = FAST_HOST_K_LADDER if fast else HOST_K_LADDER
    cohorts = FAST_HOST_M_LADDER if fast else HOST_M_LADDER
    rows = []

    exp = _build_host_experiment(event=False, device=device)
    meas = []
    for k in ks:
        exp.registry.inflate(k)
        costs = _host_costs(exp.server, HOST_ROUNDS, HOST_WARMUP)
        meas.append(Measurement("registry", float(k), costs))
        if verbose:
            print(f"  [host] batched registry={k}: {costs}")
    fl0 = exp.server.fl
    for m in cohorts:
        exp.server.fl = dataclasses.replace(
            fl0, participation=m / HOST_NUM_CLIENTS)
        costs = _host_costs(exp.server, HOST_ROUNDS, HOST_WARMUP)
        meas.append(Measurement("m", float(m), costs))
        if verbose:
            print(f"  [host] batched cohort={m}: {costs}")
    exp.server.fl = fl0
    rows.append(ScalingRow(program="host/batched-round", engine="host",
                           method="round", backend="-",
                           measurements=meas))

    exp_ev = _build_host_experiment(event=True, device=device)
    meas_ev = []
    for k in ks:
        exp_ev.registry.inflate(k)
        costs = _host_costs(exp_ev.server, EVENT_ROUNDS, EVENT_WARMUP)
        meas_ev.append(Measurement("registry", float(k), costs))
        if verbose:
            print(f"  [host] event registry={k}: {costs}")
    rows.append(ScalingRow(program="host/event-round", engine="host",
                           method="round", backend="-",
                           measurements=meas_ev))
    return rows


# -- controls ---------------------------------------------------------------

def add_controls(report, rows):
    from repro_torch.analysis import complexity, host_cost
    from repro_torch.analysis.complexity import Measurement, ScalingRow

    def dense_control():
        findings = []
        for row in rows:
            if row.backend != "dense":
                continue
            findings.extend(complexity.evaluate_row(
                row, complexity.dense_control_contracts()))
        return findings

    report.run_control(
        "dense-dn-superlinear", "scaling-contract", dense_control,
        "dense rows violate every low-rank dn contract: the ladder "
        "certifies O(d*n) and the fits can see it")

    def host_scan_control():
        meas = []
        for k in HOST_K_LADDER:
            with host_cost.HostCostMonitor() as mon:
                # the injected regression: a per-round O(registry) scan
                host_cost.tick("control/registry_scan", k)
                host_cost.alloc("control/pool_copy", 8 * k)
                mon.mark("round0")
            ph = mon.phases[0]
            meas.append(Measurement("registry", float(k), {
                "host_loop_iters": float(ph.loop_iters),
                "host_alloc_bytes": float(ph.alloc_bytes)}))
        row = ScalingRow(program="control/host-linear-scan",
                         engine="host", method="round", backend="-",
                         measurements=meas)
        return complexity.evaluate_row(row)

    report.run_control(
        "host-registry-scan", "scaling-contract", host_scan_control,
        "an injected per-round O(registry) scan trips the registry "
        "contracts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=audit_path("scaling"))
    ap.add_argument("--fast", action="store_true",
                    help="reduced ladders + engine subset (smoke tier)")
    ap.add_argument("--device", default=None,
                    help="where the device rows run: the card unless "
                         "'cpu' is asked for (the shard ladder and the "
                         "host rows run on the CPU)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis import complexity, op_lint
    from repro_torch.analysis.report import AuditReport, ProgramAudit
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)

    dn = FAST_DN_LADDER if args.fast else DN_LADDER
    report = AuditReport(matrix={
        "fast": args.fast,
        "device": str(device),
        "ladders": {
            "dn": list(dn),
            "m": list(FAST_M_LADDER if args.fast else M_LADDER),
            "r": [] if args.fast else list(R_LADDER),
            "shards": list(FAST_SHARD_LADDER if args.fast
                           else SHARD_LADDER),
            "registry": list(FAST_HOST_K_LADDER if args.fast
                             else HOST_K_LADDER),
            "host_m": list(FAST_HOST_M_LADDER if args.fast
                           else HOST_M_LADDER),
        },
        "contracts": [
            {"name": c.name, "metric": c.metric, "axis": c.axis,
             "max_slope": c.max_slope, "min_slope": c.min_slope,
             "engines": list(c.engines) if c.engines else None,
             "methods": list(c.methods) if c.methods else None,
             "backends": list(c.backends) if c.backends else None}
            for c in complexity.CONTRACTS],
    })

    device_rows = _device_rows(args.fast)
    shard_costs = _shard_ladder_costs(device_rows, args.fast)
    rows = []
    with op_lint.one_rank_mesh(device) as mesh:
        for engine, method, label in device_rows:
            row = _measure_device_row(
                engine, method, label, args.fast, device,
                mesh if engine == "sharded" else None,
                shard_costs.get((engine, method, label)))
            rows.append(row)
            findings = complexity.evaluate_row(row)
            stats = row.stats()
            base = min((m for m in row.measurements if m.axis == "dn"),
                       key=lambda m: m.x)
            stats["base_costs"] = {k: int(v) for k, v in base.costs.items()}
            audit = report.add(ProgramAudit(row.program, "scaling",
                                            findings, stats))
            if args.verbose or not audit.ok:
                for f in findings:
                    print(f"  {f}")
            print(f"[scal] {row.program:28s} "
                  f"{'ok' if audit.ok else 'FAIL'} "
                  f"(dn flops^{stats['slopes'].get('dn/dot_flops')}, "
                  f"live^{stats['slopes'].get('dn/peak_live_bytes')})")

    for row in measure_host_rows(args.fast, args.verbose):
        rows.append(row)
        findings = complexity.evaluate_row(row)
        audit = report.add(ProgramAudit(row.program, "scaling", findings,
                                        row.stats()))
        if args.verbose or not audit.ok:
            for f in findings:
                print(f"  {f}")
        reg = row.stats()["slopes"].get("registry/host_loop_iters")
        print(f"[scal] {row.program:28s} "
              f"{'ok' if audit.ok else 'FAIL'} "
              f"(registry iters^{reg})")

    add_controls(report, rows)

    report.write(args.out)
    s = report.summary()
    print(f"[scal] {s['programs']} programs, {s['errors']} errors, "
          f"{s['controls']} controls ({len(s['controls_failed'])} dead) "
          f"-> {args.out}")
    if not report.ok:
        for p in report.failed_programs:
            print(f"[scal] FAIL {p.program}: "
                  + "; ".join(str(f) for f in p.errors[:3]))
        for name in report.failed_controls:
            ctl = report.controls[name]
            why = ctl.error or "did not trip"
            print(f"[scal] DEAD CONTROL {name}: rule {ctl.rule} {why}")
        return 1
    print("[scal] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
