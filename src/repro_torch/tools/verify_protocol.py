"""Protocol-verification sweep (DESIGN.md §10) of the port: exhaustively
model-check the event-driven round path over bounded interleavings, run
the determinism lint over the round-path and serving-path sources, and
write ``build/audit_torch/AUDIT_protocol.json``.

    PYTHONPATH=src python -m repro_torch.tools.verify_protocol [--out PATH]
        [--fast] [--verbose]

Matrix:

  protocol   3 trigger families (count / timeout / staleness-bound)
             x lifecycles {none+symmetric, dropout->rejoin, mid-run join}
             at 3 clients x 2 plans over a 3-value latency grid, plus a
             3-plan ladder per trigger on a 2-value grid. Every unique
             arrival schedule (after partial-order reduction) drives the
             port's REAL EventScheduler through the server's consumption
             protocol; every reachable event boundary is checkpoint-cut
             and replayed (``--fast``: 2-value grids, no 3-plan ladder, no
             mid-run join).
  rng-host   host-determinism AST rules, and the explicit-generator rule
             for torch sampling calls, over every module active while the
             virtual clock runs (federation/, core aggregation, trace
             replay, checkpoint I/O, the verifier itself) and the serving
             path.

Positive controls (the sweep FAILS if any does not trip): an injected
double-fire (re-delivering consumed arrivals), ghost/absent weight leak,
cancelled-arrival delivery, a torn checkpoint snapshot, an understated
staleness bound, a host-clock read, an unseeded default_rng, a
SeedSequence shape collision, set-order iteration, a host key reuse, a
torch sampler without a generator and a ``torch.manual_seed`` call.

Exit status: 0 sweep green + all controls tripped, 1 otherwise, 2 on
usage errors.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.analysis import rng_lint
from repro_torch.analysis.protocol import (CancelledDeliveryScheduler,
                                           DoubleConsumeScheduler, Scenario,
                                           check_scenario)
from repro_torch.analysis.report import AuditReport, ProgramAudit
from repro_torch.federation.events import (ClientLifecycle, CountTrigger,
                                           LifecycleEvent,
                                           StalenessBoundTrigger,
                                           TimeoutTrigger)
from repro_torch.tools import ROOT, audit_path

# federation shape of every scenario: 3 clients, heterogeneous ranks and
# sample counts (weights must conserve under heterogeneity, not just
# uniformity); the symmetric variant equalizes n_k of clients {0, 2} so
# the symmetry reduction applies
NUM_CLIENTS = 3
RANKS = (8, 4, 8)
N_K_HET = (3, 1, 2)
N_K_SYM = (3, 1, 3)
GRID_FULL = (0.5, 1.5, 2.5)
GRID_FAST = (0.5, 1.5)
GRID_LADDER = (0.5, 2.5)

TRIGGERS = {
    "count": (lambda: CountTrigger(3), None),
    "timeout": (lambda: TimeoutTrigger(1.5), None),
    "staleness": (lambda: StalenessBoundTrigger(1), 1),
}


def lc_none() -> ClientLifecycle:
    return ClientLifecycle()


def lc_droprejoin() -> ClientLifecycle:
    """Client 2 drops mid-window 0 (cancelling its in-flight plan-0
    arrival on every grid), rejoins before plan 2 would dispatch."""
    return ClientLifecycle([
        LifecycleEvent(time=0.4, kind="dropout", client=2),
        LifecycleEvent(time=1.6, kind="rejoin", client=2),
    ])


def lc_join() -> ClientLifecycle:
    """A fourth client joins mid-window 0 and is dispatched from plan 1."""
    return ClientLifecycle([
        LifecycleEvent(time=0.6, kind="join", client=NUM_CLIENTS,
                       rank=8, shard=np.arange(2)),
    ])


LIFECYCLES = {"none": lc_none, "droprejoin": lc_droprejoin, "join": lc_join}


def build_scenarios(fast: bool):
    scenarios = []
    for trig_name, (trig, bound) in sorted(TRIGGERS.items()):
        for lc_name, lc in sorted(LIFECYCLES.items()):
            if fast and lc_name == "join":
                continue
            sym = lc_name == "none"
            scenarios.append(Scenario(
                name=f"protocol/{trig_name}/{lc_name}",
                num_clients=NUM_CLIENTS, num_plans=2,
                trigger_fn=trig, lifecycle_fn=lc,
                grid=GRID_FAST if fast else GRID_FULL,
                n_k=N_K_SYM if sym else N_K_HET, ranks=RANKS,
                staleness_bound=bound,
                symmetric=((0, 2),) if sym else ()))
        if not fast:
            # depth ladder: three overlapping plans on a coarser grid
            scenarios.append(Scenario(
                name=f"protocol/{trig_name}/none-3plan",
                num_clients=NUM_CLIENTS, num_plans=3,
                trigger_fn=trig, lifecycle_fn=lc_none, grid=GRID_LADDER,
                n_k=N_K_SYM, ranks=RANKS, staleness_bound=bound,
                symmetric=((0, 2),)))
    return scenarios


def _protocol_sweep(report: AuditReport, fast: bool, verbose: bool) -> None:
    for sc in build_scenarios(fast):
        findings, stats, _ = check_scenario(sc)
        audit = ProgramAudit(sc.name, "protocol", findings, stats.to_json())
        report.add(audit)
        if verbose or not audit.ok:
            for f in findings[:10]:
                print(f"  {f}")
        s = stats.to_json()
        print(f"[prot] {sc.name:32s} {'ok' if audit.ok else 'FAIL'} "
              f"(schedules={s['unique_schedules']}/{s['assignments']}, "
              f"fires={s['fires']}, cuts={s['replays']})")


def _protocol_controls(report: AuditReport) -> None:
    """Injected protocol bugs on reduced grids: each invariant's tripwire
    must be live (a sweep whose rules cannot fail proves nothing)."""
    small = Scenario(name="control/protocol", num_clients=NUM_CLIENTS,
                     num_plans=2, trigger_fn=lambda: CountTrigger(3),
                     lifecycle_fn=lc_none, grid=GRID_FAST,
                     n_k=N_K_HET, ranks=RANKS)
    drop = Scenario(name="control/protocol-drop", num_clients=NUM_CLIENTS,
                    num_plans=2, trigger_fn=lambda: CountTrigger(2),
                    lifecycle_fn=lc_droprejoin, grid=GRID_FAST,
                    n_k=N_K_HET, ranks=RANKS)
    stale = Scenario(name="control/protocol-stale", num_clients=NUM_CLIENTS,
                     num_plans=2,
                     trigger_fn=lambda: StalenessBoundTrigger(2),
                     lifecycle_fn=lc_none, grid=GRID_FAST,
                     n_k=N_K_HET, ranks=RANKS, staleness_bound=0)

    report.run_control(
        "double-fire", "proto-exactly-once",
        lambda: check_scenario(small, replay=False,
                               sched_cls=DoubleConsumeScheduler)[0],
        "scheduler re-delivering consumed arrivals")
    report.run_control(
        "cancelled-delivery", "proto-cancelled-consumed",
        lambda: check_scenario(drop, replay=False,
                               sched_cls=CancelledDeliveryScheduler)[0],
        "scheduler delivering dropout-cancelled arrivals")
    report.run_control(
        "ghost-weight-leak", "proto-ghost-weight",
        lambda: check_scenario(drop, replay=False, break_present=True)[0],
        "aggregation ignoring the present mask")
    report.run_control(
        "torn-snapshot", "proto-replay-divergence",
        lambda: check_scenario(small, corrupt_replay=True)[0],
        "checkpoint snapshot corrupted before replay")
    report.run_control(
        "understated-staleness-bound", "proto-staleness-bound",
        lambda: check_scenario(stale, replay=False)[0],
        "trigger bound 2 vs declared bound 0")


# modules active while the virtual clock runs (launch/ CLIs time their own
# wall-clock phases and are off the round path by construction); the
# clients' local training joins them for the explicit-generator rule
ROUND_PATH_FILES = (
    "src/repro_torch/federation/events.py",
    "src/repro_torch/federation/server.py",
    "src/repro_torch/federation/topology.py",
    "src/repro_torch/federation/experiment.py",
    "src/repro_torch/federation/transport.py",
    "src/repro_torch/federation/client.py",
    "src/repro_torch/core/aggregation.py",
    "src/repro_torch/data/traces.py",
    "src/repro_torch/checkpointing/checkpoint.py",
    "src/repro_torch/analysis/protocol.py",
)

# serving-path sources: the hot-swap/decode loop must be as deterministic as
# the round path (the serve CLI's wall-phase prints carry explicit waivers)
SERVING_PATH_FILES = (
    "src/repro_torch/serving/adapter_store.py",
    "src/repro_torch/serving/engine.py",
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/launch/serve.py",
)


def _rng_host_sweep(report: AuditReport, verbose: bool) -> None:
    for path in ROUND_PATH_FILES + SERVING_PATH_FILES:
        with open(ROOT / path) as f:
            source = f.read()
        name = f"rng-host/{path.split('src/repro_torch/')[-1]}"
        findings, stats = rng_lint.lint_host_source(name, source)
        audit = ProgramAudit(name, "rng-host", findings, stats)
        report.add(audit)
        if verbose or not audit.ok:
            for f in findings:
                print(f"  {f}")
        print(f"[host] {name:44s} {'ok' if audit.ok else 'FAIL'}")

    for ctl_name, rule, src, detail in [
            ("injected-host-clock", "rng-host-clock",
             rng_lint.BROKEN_HOST_CLOCK, "time.time() on the round path"),
            ("unseeded-default-rng", "rng-unseeded-default-rng",
             rng_lint.BROKEN_UNSEEDED, "np.random.default_rng() bare"),
            ("seed-collision", "rng-seed-collision",
             rng_lint.BROKEN_SEED_COLLISION,
             "two SeedSequence([seed, client]) sites"),
            ("set-order-iteration", "rng-order-sensitive-iteration",
             rng_lint.BROKEN_SET_ITERATION,
             "aggregation input built from set(clients)"),
            ("host-key-reuse", "rng-host-key-reuse",
             rng_lint.BROKEN_HOST_KEY_REUSE,
             "one PRNGKey feeding init AND randint"),
            ("torch-global-sampler", "rng-torch-global-generator",
             rng_lint.BROKEN_TORCH_GLOBAL_RNG,
             "torch.randn without generator="),
            ("torch-manual-seed", "rng-torch-global-generator",
             rng_lint.BROKEN_TORCH_MANUAL_SEED,
             "torch.manual_seed reseeding the global generator")]:
        report.run_control(
            ctl_name, rule,
            lambda s=src, n=ctl_name:
                rng_lint.lint_host_source(f"control/{n}", s)[0],
            detail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=audit_path("protocol"))
    ap.add_argument("--fast", action="store_true",
                    help="bounded smoke scope: 2-value grids, no 3-plan "
                         "ladder, no mid-run-join scenario")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    report = AuditReport(matrix={
        "clients": NUM_CLIENTS, "ranks": list(RANKS),
        "n_k": {"het": list(N_K_HET), "sym": list(N_K_SYM)},
        "triggers": sorted(TRIGGERS),
        "lifecycles": sorted(LIFECYCLES),
        "grid": list(GRID_FAST if args.fast else GRID_FULL),
        "scope": "fast" if args.fast else "full",
        "round_path_files": list(ROUND_PATH_FILES),
        "serving_path_files": list(SERVING_PATH_FILES),
    })

    _protocol_sweep(report, args.fast, args.verbose)
    _protocol_controls(report)
    _rng_host_sweep(report, args.verbose)

    report.write(args.out)
    s = report.summary()
    print(f"[vrfy] {s['programs']} programs, {s['errors']} errors, "
          f"{s['controls']} controls ({len(s['controls_failed'])} dead) "
          f"-> {args.out}")
    if not report.ok:
        for p in report.failed_programs:
            print(f"[vrfy] FAIL {p.program}: "
                  + "; ".join(str(f) for f in p.errors[:3]))
        for name in report.failed_controls:
            ctl = report.controls[name]
            why = ctl.error or "did not trip"
            print(f"[vrfy] DEAD CONTROL {name}: rule {ctl.rule} {why}")
        return 1
    print("[vrfy] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
