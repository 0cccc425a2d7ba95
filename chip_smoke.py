#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits nonzero without one) and the CUDA toolkit's
``nvcc``. Imports ``repro_torch`` from ``src/`` next to this file, never
JAX. Phases, each printing one JSON line:

1. build          compile every hand-written kernel from the sources.
2. kernels        each kernel against its plain PyTorch version on the card
                  at the vit-base round's bucket shapes, with times.
3. round_small    one fedvit-tiny (d_model=32) round on cuda and on cpu
                  from the same weights and seed; products and spectra
                  must agree to the kernel-path tolerance.
4. round_vit_base the main path: three raFLoRA rounds of the batched engine
                  with the kernel backend at ViT-base width; every kernel
                  must launch in every round.
5. kernel summary one {"kernels": [...]} line, then the card's name and
                  power limit, then the final {"ok": true, ...} line.

``--profile`` adds one profiled vit-base round after phase 4 (device time
of the top kernels, the device's idle share).

Any failure exits nonzero before the final line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
REPLACES = {
    "weighted_stack_b": "src/repro/kernels/rank_partition_agg.py:198",
    "weighted_stack_a": "src/repro/kernels/rank_partition_agg.py:231",
    "gram_left": "src/repro/kernels/rank_partition_agg.py:287",
    "gram_right": "src/repro/kernels/rank_partition_agg.py:320",
}
SOURCES = {
    "weighted_stack_b": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "weighted_stack_a": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "gram_left": "src/repro_torch/kernels/csrc/gram.cu",
    "gram_right": "src/repro_torch/kernels/csrc/gram.cu",
}
# vit-base round buckets: (name, layers L' = adapters x layers, d, n)
BUCKETS = (("attn_qkvo", 48, 768, 768), ("mlp_down", 12, 3072, 768),
           ("mlp_up", 12, 768, 3072))
CLIENTS = 6        # 5 sampled clients + the Eq. 8 fallback client
RANK = 32          # r_max, already a multiple of 8


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events around ``iters`` calls
    (inputs stay resident in L2 where they fit, as in the round)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {stem: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for stem, log in build.ptxas_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(build.ptxas_log), "ptxas": ptxas})


def phase_kernels(torch, summary: dict):
    """Each kernel vs its plain version at the round's bucket shapes."""
    from repro_torch.kernels import rank_partition_agg as rpa
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = torch.finfo(torch.float32).eps
    rows = []
    for name, layers, d, n in BUCKETS:
        bs = torch.randn(layers, CLIENTS, d, RANK, generator=gen,
                         device="cuda")
        as_ = torch.randn(layers, CLIENTS, RANK, n, generator=gen,
                          device="cuda")
        # raFLoRA-like weights: zero beyond some ranks, one negative entry
        omega = torch.rand(CLIENTS, RANK, generator=gen, device="cuda")
        omega[0, 8:] = 0.0
        omega[1, 0] = -0.25
        rr = CLIENTS * RANK
        # K1's library yardstick: the scale as one broadcast multiply by
        # precomputed weights (plus B's permute-copy to client-major columns)
        w = torch.sqrt(torch.clamp(omega, min=0.0))
        cases = {
            "weighted_stack_b": (
                rpa.weighted_stack_b, rpa.weighted_stack_b_plain, (bs, omega),
                lambda: (bs * w[None, :, None, :]).permute(0, 2, 1, 3)
                .reshape(layers, d, rr)),
            "weighted_stack_a": (
                rpa.weighted_stack_a, rpa.weighted_stack_a_plain,
                (as_, omega),
                lambda: (as_ * w[None, :, :, None]).reshape(layers, rr, n)),
        }
        u = rpa.weighted_stack_b_plain(bs, omega).contiguous()
        v = rpa.weighted_stack_a_plain(as_, omega).contiguous()
        cases["gram_left"] = (rpa.gram_left, rpa.gram_left_plain, (u,),
                              lambda: u.mT @ u)
        cases["gram_right"] = (rpa.gram_right, rpa.gram_right_plain, (v,),
                               lambda: v @ v.mT)
        for kname, (kern, plain, args, library) in cases.items():
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if kname.startswith("weighted_stack"):
                # one IEEE sqrt and one multiply per element: bit-exact
                tol = 0.0
                nbytes = 2 * args[0].numel() * 4 + omega.numel() * 4
                flops = args[0].numel()
            else:
                # worst-case rounding of a length-`depth` f32 dot product
                # (Higham's gamma_depth) times the largest column norm^2
                x = args[0]
                depth = d if kname == "gram_left" else n
                norms = (x * x).sum(dim=1 if kname == "gram_left" else 2)
                tol = depth * eps * float(norms.max())
                require(bool(torch.equal(got, got.mT)),
                        f"{kname} {name}: output not exactly symmetric")
                # the input read once and the full (both-triangle) output
                # written once; G is symmetric, so the work is the
                # R(R+1)/2 distinct dot products of 2*depth FLOP each
                nbytes = x.numel() * 4 + layers * rr * rr * 4
                flops = float(layers * depth * rr * (rr + 1))
            require(err <= tol, f"{kname} {name}: max_abs_err {err} > {tol}")
            k_ms = time_ms(torch, lambda: kern(*args))
            p_ms = time_ms(torch, lambda: plain(*args))
            l_ms = time_ms(torch, library)
            b_ms, b_by = bound_ms(nbytes, flops)
            rows.append({"kernel": kname, "bucket": name,
                         "shape": list(args[0].shape), "max_abs_err": err,
                         "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "flop": flops,
                         "kernel_gb_per_s": nbytes / k_ms / 1e6,
                         "kernel_tflop_per_s": flops / k_ms / 1e9})
            s = summary.setdefault(kname, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "bound_by": b_by})
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += k_ms
            s["plain_ms"] += p_ms
            s["bound_ms"] += b_ms
            s["library_ms"] += l_ms
    emit({"phase": "kernels", "per_bucket": rows,
          "launches": {k.__name__: k.launches for k in rpa.KERNELS}})


def _products(server):
    r_max = server.lora_cfg.r_max
    f = server._extract_factors(server.global_lora, r_max)
    return {p: (b @ a).float().cpu() for p, (b, a) in f.items()}


def phase_round_small(torch):
    """One fedvit-tiny round on cuda and on cpu from the same weights."""
    from repro_torch.federation.experiment import build_experiment
    kw = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                            "participation": 0.5},
              lora_overrides={"rank_levels": (4, 8, 16),
                              "rank_probs": (0.34, 0.33, 0.33)},
              samples_per_class=30, num_classes=6, d_model=32,
              batches_per_round=1, backend="kernel")
    cpu = build_experiment("raflora", device="cpu", **kw)
    gpu = build_experiment("raflora", device="cuda",
                           base_params=cpu.server.global_params(), **kw)
    runs = {}
    for dev, exp in (("cuda", gpu), ("cpu", cpu)):
        stats = exp.server.run(1)[0]
        runs[dev] = (stats, _products(exp.server))
    (sc, pc), (sh, ph) = runs["cuda"], runs["cpu"]
    require(sc.clients == sh.clients and sc.ranks == sh.ranks,
            "round_small: cuda and cpu sampled different clients")
    loss_rel = abs(sc.mean_client_loss - sh.mean_client_loss) / abs(
        sh.mean_client_loss)
    scale = max(1.0, float(abs(sh.sigma_probe).max()))
    sig_err = float(abs(sc.sigma_probe - sh.sigma_probe).max())
    prod_err = max(float((pc[p] - ph[p]).abs().max()) for p in ph)
    ok = loss_rel <= 1e-4 and sig_err <= 1e-3 * scale and \
        prod_err <= 2e-3 * scale
    emit({"phase": "round_small", "clients": sc.clients, "ranks": sc.ranks,
          "loss_cuda": sc.mean_client_loss, "loss_cpu": sh.mean_client_loss,
          "loss_rel_err": loss_rel, "sigma_max_abs_err": sig_err,
          "product_max_abs_err": prod_err,
          "tol": {"loss_rtol": 1e-4, "sigma_atol": 1e-3 * scale,
                  "product_atol": 2e-3 * scale}, "ok": ok})
    require(ok, "round_small: cuda round disagrees with the cpu round")


def phase_round_vit_base(torch, rounds: int = 3) -> dict:
    """The main path: raFLoRA rounds at ViT-base width, kernel backend."""
    import numpy as np
    from repro_torch.configs import FLConfig, LoRAConfig, get_config
    from repro_torch.data import ClusterClassification, make_partition
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.kernels import rank_partition_agg as rpa
    from repro_torch.models.transformer import Model

    t0 = time.perf_counter()
    cfg = get_config("vit-base")
    fl = FLConfig(aggregator="raflora", num_clients=20, participation=0.25,
                  num_rounds=40, local_batch_size=32, learning_rate=2e-3,
                  partition="pathological", dirichlet_alpha=1.0,
                  labels_per_client=5)
    lora = LoRAConfig(rank_levels=(4, 8, 16, 24, 32),
                      rank_probs=(0.2, 0.2, 0.2, 0.2, 0.2))
    data = ClusterClassification(num_classes=20, dim=cfg.d_model,
                                 patches=cfg.frontend.tokens_per_item,
                                 samples_per_class=40, seed=0)
    (x_tr, y_tr), _ = data.train_test_split()
    shards = make_partition(fl.partition, y_tr, fl.num_clients,
                            alpha=fl.dirichlet_alpha,
                            labels_per_client=fl.labels_per_client,
                            seed=fl.seed)
    registry = ClientRegistry.create(fl, lora, shards)
    model = Model(cfg, lora, device="cuda")
    batch_fn = make_batch_fn(registry, x_tr, y_tr, fl, 2, data.patches)
    server = FederatedLoRA(model, fl, lora, registry, batch_fn,
                           backend="kernel")
    setup_s = time.perf_counter() - t0

    times: dict = {}
    trained: dict = {}

    def timed(stage, fn, keep=False):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            end.synchronize()
            times[stage] = start.elapsed_time(end)
            if keep:
                trained["out"] = out
            return out
        return wrapper

    server._plan_round = timed("plan_ms", server._plan_round)
    server._train_grouped = timed("train_ms", server._train_grouped, True)
    server._aggregate_grouped = timed("aggregate_ms",
                                      server._aggregate_grouped)
    n_buckets = 3
    rpa.reset_launches()          # the main path's count starts here
    for _ in range(rounds):
        before = {k.__name__: k.launches for k in rpa.KERNELS}
        torch.cuda.reset_peak_memory_stats()
        stats = server.run_round()
        torch.cuda.synchronize()
        grew = {k.__name__: k.launches - before[k.__name__]
                for k in rpa.KERNELS}
        require(all(g == n_buckets for g in grew.values()),
                f"round {stats.round}: kernel launches {grew}, expected "
                f"{n_buckets} each")
        finite = all(bool(torch.isfinite(t).all())
                     for t in _leaves(server.global_lora))
        require(finite, f"round {stats.round}: non-finite global factors")
        group_factors, _ = trained["out"]
        masked_zero = True
        for members, _, factors in group_factors:
            for b, a in factors.values():
                for j, i in enumerate(members):
                    r = stats.ranks[i]
                    masked_zero &= bool((b[j][..., r:] == 0).all())
                    masked_zero &= bool((a[j][..., r:, :] == 0).all())
        require(masked_zero, f"round {stats.round}: client factors beyond "
                             "their rank are not exactly zero")
        emit({"phase": "round_vit_base", "round": stats.round,
              "clients": stats.clients, "ranks": stats.ranks,
              "plan_ms": times["plan_ms"], "train_ms": times["train_ms"],
              "aggregate_ms": times["aggregate_ms"],
              "round_wall_s": stats.wall_time_s,
              "mean_client_loss": stats.mean_client_loss,
              "higher_rank_energy_ratio":
                  float(server.energy.higher_rank_ratio[-1]),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "launches": grew, "global_finite": finite,
              "masked_slices_zero": masked_zero,
              "setup_s": setup_s if stats.round == 0 else None})
        require(np.isfinite(stats.mean_client_loss),
                f"round {stats.round}: non-finite client loss")
    return {k.__name__: k.launches for k in rpa.KERNELS}, server


def phase_profile(torch, server) -> None:
    """One more vit-base round under torch.profiler: device time by
    kernel and the device's busy share of the round's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_round()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "profile", "round_wall_ms": wall_ms,
          "device_busy_ms": dev_ms, "device_idle_share": 1 - dev_ms / wall_ms,
          "top_kernels": [{"name": e.key[:90], "count": e.count,
                           "device_ms": e.self_device_time_total / 1e3}
                          for e in top]})


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: repro_torch not found under src/ next to this "
              "script", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary: dict = {}
    try:
        phase_build()
        phase_kernels(torch, summary)
        phase_round_small(torch)
        launches, server = phase_round_vit_base(torch)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, server)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, s in summary.items():
        require_launch = launches.get(name, 0)
        if require_launch == 0:
            print(f"chip_smoke: FAIL: {name} never launched on the main "
                  "path", file=sys.stderr)
            return 1
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": require_launch, **s})
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi unavailable: {smi.stderr.strip()}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
