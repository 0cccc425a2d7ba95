"""Program-audit sweep (DESIGN.md §8) of the port: the op lint, the
dispatch audit and the CUDA lint over the engine x backend x method
matrix, written to ``build/audit_torch/AUDIT_program_lint.json``.

    PYTHONPATH=src python -m repro_torch.tools.lint_programs [--out PATH]
        [--device cpu|cuda] [--skip-dispatch] [--verbose]

``--device`` defaults to the card; ``--device cpu`` runs the programs and
the pad probes on the CPU through the plain versions, with no ptxas
report to read.

Matrix (small shapes -- the rules are scale-free, chosen so every legal
low-rank stack stays strictly below the (d, n) materialization bar):

  engines   sequential (``_dispatch_stacked`` on one adapter), batched
            (``_grouped_core``), async (the same grouped program at
            pipeline_depth x M clients), event (the same grouped program
            the fire path dispatches; a present mask is weight data),
            sharded (``sharded_grouped_fn`` on a one-rank mesh in this
            process)
  methods   averaging family (fedavg / hetlora / ffa / flora) once per
            engine (backend-independent); SVD family (flexlora / raflora)
            x {dense, factored, kernel}
  passes    op_lint on every program and on the round-path entry points
            (``train_group_masked``, ``Aggregator.aggregate_stack`` /
            ``aggregate_grouped``, the event fire, ``svd_realloc_gram``,
            the int8 transport's encode); cuda_lint over the kernels'
            ptxas reports (on the card: built here) and the pad
            probes; dispatch_audit over a multi-round run of the batched
            and async engines

Positive controls (the sweep FAILS if any does not trip, or raises):
dense-backend materialization, a ``.item()`` and a ``.tolist()`` inside a
traced program, an f64 upcast, a bf16 program with f32 upcasts, an
oversized fabricated ptxas report, and a shape-varying round sequence.

Exit status: 0 sweep green + all controls tripped, 1 otherwise, 2 on
usage errors.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.analysis import cuda_lint, dispatch_audit, op_lint
from repro_torch.analysis.op_lint import (AVG_METHODS, BACKENDS, ENGINES,
                                          SVD_METHODS, ProgramPoint)
from repro_torch.analysis.report import AuditReport, ProgramAudit
from repro_torch.analysis.rules import Finding
from repro_torch.tools import audit_path

# sweep shapes: M_max * P * W < d * n for every legal stack (W the stack
# width with the fallback client), so only a dense dW reaches the bar
D, N, R_MAX = 160, 192, 8
RANK_LEVELS = (4, 8)
M_PER_GROUP = 2                 # clients per rank group
P_BUCKET = 2                    # adapters per bucket (grouped rows)
ASYNC_DEPTH = 2
DISPATCH_ROUNDS, DISPATCH_WARMUP = 6, 2
MAX_HOST_SYNCS_PER_ROUND = 4    # measured 2 (losses, energy probe)

TRANSPORT_F64_REASON = (
    "transport.py computes the error-feedback residual x - q * scale in "
    "float64 on purpose, to round it once, as the reference's fused "
    "program does")
TRANSPORT_META = {"allow_f64": True, "f64_reason": TRANSPORT_F64_REASON}


def _lint_point(engine: str, method: str, backend: str) -> ProgramPoint:
    return ProgramPoint(engine=engine, method=method, backend=backend, d=D,
                        n=N, rank_levels=RANK_LEVELS,
                        m_per_group=M_PER_GROUP, p_bucket=P_BUCKET,
                        depth=ASYNC_DEPTH if engine == "async" else 1)


def _meta(engine: str, method: str, backend: str, shards: int) -> dict:
    """Per-row thresholds. Materialization is armed for the SVD family
    (flora's merge delta is dense BY DESIGN; the averaging family forms
    no product); non-sharded programs get a zero collective budget, the
    sharded ones the exact expected all-reduce bytes x1.5: the averaged
    factors, flora's and the dense backend's dW, or the zero-scattered
    (d, W) / (W, n) stacks of the factored and kernel backends."""
    meta = {"max_collective_count": 0, "max_collective_bytes": 0}
    if engine == "sharded":
        width = len(RANK_LEVELS) * M_PER_GROUP * shards * R_MAX
        if method in ("fedavg", "hetlora"):
            exact = D * R_MAX + R_MAX * N
        elif method == "ffa":
            exact = R_MAX * N
        elif method == "flora" or backend == "dense":
            exact = D * N
        else:
            exact = D * width + width * N
        meta = {"max_collective_count": 2,
                "max_collective_bytes": int(1.5 * 4 * P_BUCKET * exact)}
    if method in SVD_METHODS:
        meta.update(forbid_elems=D * N, forbid_dims=(D, N))
    return meta


def _rows():
    for engine in ENGINES:
        for method in AVG_METHODS:
            yield engine, method, "-"
        for method in SVD_METHODS:
            for backend in BACKENDS:
                yield engine, method, backend


def _op_sweep(report, device, verbose):
    dense_controls, traffic = [], {}
    with op_lint.one_rank_mesh(device) as mesh:
        for engine, method, backend in _rows():
            name = f"{engine}/{method}/{backend}"
            be = "factored" if backend == "-" else backend
            fn = op_lint.program_fn(_lint_point(engine, method, be),
                                    device=device,
                                    mesh=mesh if engine == "sharded" else None)
            with torch.no_grad():
                trace, _ = op_lint.trace_ops(fn)
            findings = op_lint.lint_ops(
                trace, name, _meta(engine, method, be, mesh.size(0)))
            stats = trace.stats()
            if method in SVD_METHODS and backend != "dense":
                traffic[(engine, method, backend)] = (
                    trace.collective_count, trace.collective_bytes)
            if method in SVD_METHODS and backend == "dense":
                # the dense backend MUST trip the materialization rule: the
                # standing positive control that the tripwire is live
                mat = [f for f in findings
                       if f.rule == "op-materialization"]
                dense_controls.extend(mat)
                findings = [f for f in findings
                            if f.rule != "op-materialization"]
                stats["expected_materialization_hits"] = len(mat)
            audit = report.add(ProgramAudit(name, "op", findings, stats))
            if verbose or not audit.ok:
                for f in findings:
                    print(f"  {f}")
            print(f"[op  ] {name:28s} {'ok' if audit.ok else 'FAIL'} "
                  f"(ops={stats['ops']}, flops={stats['flops']}, "
                  f"coll={stats['collective_bytes']}B)")
    report.add_control(
        "dense-materialization", "op-materialization", dense_controls,
        f"{len(dense_controls)} (d, n)-scale outputs across dense rows")
    # kernel == factored collective traffic: the kernels change what a
    # rank computes, never what it sends
    parity = []
    for engine in ENGINES:
        for method in SVD_METHODS:
            a = traffic[(engine, method, "factored")]
            b = traffic[(engine, method, "kernel")]
            if a != b:
                parity.append(Finding(
                    "op-collective-parity", "error",
                    f"{engine}/{method}/parity",
                    f"factored {a} != kernel {b} (count, bytes)", engine))
    audit = report.add(ProgramAudit("parity/kernel-vs-factored", "op",
                                    parity, {"pairs": len(traffic) // 2}))
    print(f"[op  ] parity kernel==factored: "
          f"{'ok' if audit.ok else 'FAIL'}")


def _build_tiny_experiment(engine: str, depth: int = 1, device="cpu"):
    from repro_torch.federation.experiment import build_experiment
    return build_experiment(
        "raflora",
        fl_overrides={"num_rounds": DISPATCH_ROUNDS + 2, "num_clients": 6,
                      "participation": 1.0},
        lora_overrides={"rank_levels": RANK_LEVELS,
                        "rank_probs": (0.5, 0.5)},
        num_classes=4, d_model=32, samples_per_class=20,
        batches_per_round=1, backend="kernel", round_engine=engine,
        pipeline_depth=depth, device=device)


def _entry_points(exp, device):
    """(name, zero-argument call, meta) for the round-path entry points."""
    from repro_torch.core.svd import svd_realloc_gram
    from repro_torch.federation.transport import (TransportConfig,
                                                  UpdateTransport)
    server = exp.server
    gen = torch.Generator().manual_seed(0)

    def f32(*shape):
        return torch.randn(shape, generator=gen).to(device)

    batch = server.batch_fn(0, np.random.default_rng(0))[0]
    stack = {k: torch.as_tensor(np.stack([v, v]), device=device)
             for k, v in batch.items()}
    out = [("op/train_group_masked", lambda: server.trainer
            .train_group_masked(server.base, server.global_lora, [4, 8],
                                [stack], 1e-3), {})]
    agg = server.aggregator
    m = M_PER_GROUP * len(RANK_LEVELS)
    ranks = [r for r in RANK_LEVELS for _ in range(M_PER_GROUP)]
    n_k = [10.0] * m
    bs, as_ = f32(m, D, R_MAX), f32(m, R_MAX, N)
    group_bs = tuple((f32(M_PER_GROUP, D, r),) for r in RANK_LEVELS)
    group_as = tuple((f32(M_PER_GROUP, r, N),) for r in RANK_LEVELS)
    gbs, gas = (f32(D, R_MAX),), (f32(R_MAX, N),)
    present = [True] * (m - 1) + [False]
    mat = {"forbid_elems": D * N, "forbid_dims": (D, N)}
    out += [
        ("op/aggregate_stack",
         lambda: agg.aggregate_stack(bs, as_, ranks, n_k), mat),
        ("op/aggregate_grouped",
         lambda: agg.aggregate_grouped(group_bs, group_as, ranks, n_k,
                                       global_bs=gbs, global_as=gas), mat),
        ("op/event_fire",
         lambda: agg.aggregate_grouped(group_bs, group_as, ranks, n_k,
                                       present=present), mat)]
    width = 4 * 8
    u, v = f32(D, width), f32(width, N)
    out.append(("op/svd_realloc_gram",
                lambda: svd_realloc_gram(u, v, u.T @ u, v @ v.T, R_MAX), mat))
    transport = UpdateTransport(TransportConfig(mode="int8"))
    factors = {("layer", "q"): (f32(2, D, R_MAX), f32(2, R_MAX, N))}
    out.append(("op/transport_int8_encode",
                lambda: transport.encode_group([0, 1], factors),
                TRANSPORT_META))
    return out


def _entry_sweep(report, exp, device, verbose):
    for name, fn, meta in _entry_points(exp, device):
        trace, _ = op_lint.trace_ops(fn)
        findings = op_lint.lint_ops(trace, name, meta)
        stats = trace.stats()
        if meta.get("f64_reason"):
            stats["f64_waiver"] = meta["f64_reason"]
        audit = report.add(ProgramAudit(name, "op", findings, stats))
        if verbose or not audit.ok:
            for f in findings:
                print(f"  {f}")
        print(f"[op  ] {name:28s} {'ok' if audit.ok else 'FAIL'} "
              f"(ops={stats['ops']})")


def _op_controls(report):
    x = torch.ones(4, 4)

    def traced(fn):
        return lambda: op_lint.lint_ops(op_lint.trace_ops(fn)[0],
                                        "control/op")

    report.run_control("traced-item", "op-host-transfer",
                       traced(lambda: (x * 2.0).sum().item()),
                       ".item() inside a traced program")
    report.run_control("traced-tolist", "op-host-transfer",
                       traced(lambda: (x * 2.0).tolist()),
                       ".tolist() inside a traced program")
    report.run_control("f64-upcast", "op-dtype-upcast",
                       traced(lambda: x.double().sum()),
                       "a float64 intermediate")

    def bf16_pass():
        b = torch.ones(256, 256, dtype=torch.bfloat16)
        trace, _ = op_lint.trace_ops(lambda: (b.float() @ b.float()))
        return op_lint.lint_ops(trace, "control/bf16-upcast",
                                {"bf16_min_elems": 256 * 256})

    report.run_control("bf16-upcast", "op-dtype-upcast", bf16_pass)


def _cuda_sweep(report, device, verbose):
    from repro_torch.kernels import build
    meta = {}
    if device.type == "cuda":
        build.build_all()
        logs = cuda_lint.ptxas_reports()
        meta["libraries"] = sorted(build.SIGNATURES)
    else:
        logs = {}                 # no nvcc here: the probes run plain
    progs = cuda_lint.CudaPrograms(cuda_lint.collect_build(logs),
                                   cuda_lint.probe_registry(device))
    findings = cuda_lint.lint_cuda(progs, "cuda/registry", meta)
    stats = {"device": str(device),
             "libraries": sorted(logs),
             "entries": [e.to_json() for e in progs.entries],
             "probes": [{"name": p.name, "ok": p.ok, "detail": p.detail}
                        for p in progs.probes],
             "spill_waivers": {k: list(v) for k, v in
                               sorted(cuda_lint.SPILL_WAIVERS.items())}}
    audit = report.add(ProgramAudit("cuda/registry", "cuda", findings,
                                    stats))
    if verbose or not audit.ok:
        for f in findings:
            print(f"  {f}")
    print(f"[cuda] registry: {len(progs.entries)} entries from "
          f"{len(logs)} libraries, {len(progs.probes)} probes on {device} "
          f"{'ok' if audit.ok else 'FAIL'}")

    def oversized_pass():
        return cuda_lint.lint_cuda(cuda_lint.oversized_control(),
                                   "control/cuda-oversized")

    report.run_control("oversized-spill", "cuda-spill-budget",
                       oversized_pass)
    report.run_control("oversized-smem", "cuda-static-smem", oversized_pass)


def _dispatch_sweep(report, exp_batched, device, verbose):
    engines = [("batched", exp_batched, 1),
               ("async", _build_tiny_experiment("async", ASYNC_DEPTH,
                                                device), ASYNC_DEPTH)]
    for engine, exp, period in engines:
        mon = dispatch_audit.DispatchMonitor()
        with mon:
            for r in range(DISPATCH_ROUNDS):
                exp.server.run_round()
                mon.mark(f"round{r}")
        name = f"dispatch/{engine}"
        meta = {"warmup": DISPATCH_WARMUP, "period": period,
                "max_host_syncs_per_phase": MAX_HOST_SYNCS_PER_ROUND}
        findings = dispatch_audit.lint_dispatch(mon, name, meta)
        audit = report.add(ProgramAudit(name, "dispatch", findings,
                                        mon.stats()))
        if verbose or not audit.ok:
            for f in findings:
                print(f"  {f}")
        steady = mon.phases[DISPATCH_WARMUP:]
        print(f"[disp] {name}: {DISPATCH_ROUNDS} rounds, steady "
              f"builds={sum(p.builds for p in steady)} "
              f"syncs<={max((p.sync_count for p in steady), default=0)} "
              f"{'ok' if audit.ok else 'FAIL'}")

    def shape_varying_pass():
        mon = dispatch_audit.DispatchMonitor()
        with mon:
            for r in range(4):
                (torch.ones(8 + r) * 2.0).sum()
                mon.mark(f"round{r}")
        return dispatch_audit.lint_dispatch(mon, "control/shape-varying",
                                            {"warmup": 1})

    report.run_control("shape-varying-round", "dispatch-steady-state",
                       shape_varying_pass)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=audit_path("program_lint"))
    ap.add_argument("--device", default=None,
                    help="where the programs and probes run: the card "
                         "(which builds the kernels and lints their ptxas "
                         "reports) unless 'cpu' is asked for")
    ap.add_argument("--skip-dispatch", action="store_true",
                    help="skip the multi-round dispatch audit (the only "
                         "pass that runs real rounds)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)

    report = AuditReport(matrix={
        "d": D, "n": N, "r_max": R_MAX, "rank_levels": list(RANK_LEVELS),
        "clients_per_group": M_PER_GROUP, "bucket_adapters": P_BUCKET,
        "async_depth": ASYNC_DEPTH, "device": str(device),
        "engines": list(ENGINES), "avg_methods": list(AVG_METHODS),
        "svd_methods": list(SVD_METHODS), "backends": list(BACKENDS),
        "dispatch": {"rounds": DISPATCH_ROUNDS, "warmup": DISPATCH_WARMUP,
                     "max_host_syncs_per_phase": MAX_HOST_SYNCS_PER_ROUND},
    })
    _op_sweep(report, device, args.verbose)
    _op_controls(report)
    exp = _build_tiny_experiment("batched", device=device)
    _entry_sweep(report, exp, device, args.verbose)
    _cuda_sweep(report, device, args.verbose)
    if not args.skip_dispatch:
        _dispatch_sweep(report, exp, device, args.verbose)

    report.write(args.out)
    s = report.summary()
    print(f"[lint] {s['programs']} programs, {s['errors']} errors, "
          f"{s['controls']} controls ({len(s['controls_failed'])} dead) "
          f"-> {args.out}")
    if not report.ok:
        for p in report.failed_programs:
            print(f"[lint] FAIL {p.program}: "
                  + "; ".join(str(f) for f in p.errors[:3]))
        for name in report.failed_controls:
            ctl = report.controls[name]
            why = ctl.error or "did not trip"
            print(f"[lint] DEAD CONTROL {name}: rule {ctl.rule} {why}")
        return 1
    print("[lint] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
