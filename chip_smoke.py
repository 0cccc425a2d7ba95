#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits nonzero without one) and the CUDA toolkit's
``nvcc``. Imports ``repro_torch`` from ``src/`` next to this file, never
JAX. Phases, each printing one JSON line:

1. build          compile every hand-written kernel from the sources.
2. kernels        each kernel against its plain PyTorch version on the card
                  at the shapes its main path gives it (K1/K2: the
                  vit-base round's buckets; K4: Qwen2-7B's q/k/v/o at
                  decode and prefill), with times, bounds and library
                  yardsticks.
3. round_small    one fedvit-tiny (d_model=32) round on cuda and on cpu
                  from the same weights and seed; products and spectra
                  must agree to the kernel-path tolerance.
4. round_vit_base main path 1: three raFLoRA rounds of the batched engine
                  with the kernel backend at ViT-base width; K1 and K2
                  must launch in every round.
5. serve_small    a reduced qwen2 serving engine on cuda (K4) and on cpu
                  (plain) from the same weights: equal greedy tokens.
6. serve_qwen2_7b main path 2: Qwen2-7B at full width in f32, 4 slots of
                  32-token prompts and 16 new tokens over 3 tenants at
                  ranks 16/8/4, with a hot swap after 8 decode steps; K4
                  must launch 4 x 28 times per engine step, and the tokens
                  must equal the same engine's plain path on the card.
7. kernel summary one {"kernels": [...]} line, then the card's name and
                  power limit, then the final {"ok": true, ...} line.

``--profile`` adds one profiled vit-base round after phase 4 (device time
of the top kernels, the device's idle share). Phase 6 always profiles one
extra decode step for K4's share of its device time.

Any failure exits nonzero before the final line.
"""
from __future__ import annotations

import gc
import json
import math
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
    "batched_lora_apply": "src/repro/kernels/lora_apply.py:153",
}
SOURCES = {
    "weighted_stack_b": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "weighted_stack_a": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "gram_left": "src/repro_torch/kernels/csrc/gram.cu",
    "gram_right": "src/repro_torch/kernels/csrc/gram.cu",
    "batched_lora_apply": "src/repro_torch/kernels/csrc/lora_apply.cu",
}
# vit-base round buckets: (name, layers L' = adapters x layers, d, n)
BUCKETS = (("attn_qkvo", 48, 768, 768), ("mlp_down", 12, 3072, 768),
           ("mlp_up", 12, 768, 3072))
CLIENTS = 6        # 5 sampled clients + the Eq. 8 fallback client
RANK = 32          # r_max, already a multiple of 8
# Qwen2-7B serving (launch/serve.py defaults): K4's projections per layer
# (name, K, N), the slots' pages, and the engine shape
QWEN_PROJ = (("q", 3584, 3584), ("k", 3584, 512), ("v", 3584, 512),
             ("o", 3584, 3584))
SLOTS, PROMPT_LEN, NEW_TOKENS, SERVE_RANK = 4, 32, 16, 16
DEV = "cuda"       # the card; the serving phases take their device here


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


def time_rotating_ms(torch, fn, arg_sets, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls that cycle through
    ``arg_sets``: copies enough to exceed the 50 MB L2, so every call
    reads its weights from device memory, as one decode step does."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _lora_library(torch, x, w, a, b, s, ids):
    """cuBLAS f32 x @ W plus the gathered bmm adapter term."""
    i = ids.long()
    z = torch.bmm(x[:, None, :], a[i].mT)
    return x @ w + s[i][:, None] * torch.bmm(z, b[i].mT)[:, 0]


def phase_kernel_lora_apply(torch, summary: dict):
    """K4 vs its plain version at Qwen2-7B's q/k/v/o shapes: decode (one
    row per slot) and prefill (32 prompt tokens per slot), 4 pages at
    r = 16, every slot on its own page."""
    from repro_torch.kernels import lora_apply as la
    gen = torch.Generator(device=DEV).manual_seed(1)
    eps = torch.finfo(torch.float32).eps
    rows, totals = [], {}
    for phase, m in (("decode", SLOTS), ("prefill", SLOTS * PROMPT_LEN)):
        tot = totals.setdefault(phase, {"ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "bound_ms": 0.0,
                                        "bytes_ms": 0.0, "ops_ms": 0.0})
        for proj, k, n in QWEN_PROJ:
            r, p = SERVE_RANK, SLOTS
            nbytes_w = k * n * 4
            copies = max(2, math.ceil(100e6 / nbytes_w))
            sets = []
            for _ in range(copies):
                x = torch.randn(m, k, generator=gen, device=DEV)
                w = torch.randn(k, n, generator=gen, device=DEV) * k ** -.5
                a = torch.randn(p, r, k, generator=gen, device=DEV) \
                    * k ** -.5
                b = torch.randn(p, n, r, generator=gen, device=DEV) * 0.1
                s = torch.ones(p, device=DEV)
                ids = (torch.arange(m, device=DEV) * p // m).to(
                    torch.int32)
                sets.append((x, w, a, b, s, ids))
            args = sets[0]
            got = la.batched_lora_apply(*args)
            want = la.batched_lora_apply_plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # worst-case rounding of the (K + r)-deep f32 dot products:
            # (K + r) eps max(|x| @ |W| + |s| (|x| @ |A|^T) @ |B|^T)
            mag = la.batched_lora_apply_plain(
                *(t.abs() for t in args[:5]), args[5])
            tol = (k + r) * eps * float(mag.max())
            require(err <= tol, f"batched_lora_apply {phase} {proj}: "
                                f"max_abs_err {err} > {tol}")
            require(torch.equal(got, la.batched_lora_apply(*args)),
                    f"batched_lora_apply {phase} {proj}: not deterministic")
            k_ms = time_rotating_ms(torch, la.batched_lora_apply, sets)
            p_ms = time_rotating_ms(torch, la.batched_lora_apply_plain, sets)
            l_ms = time_rotating_ms(
                torch, lambda *t: _lora_library(torch, *t), sets)
            nbytes = 4 * (k * n + p * r * (k + n) + m * (k + n) + p) + 4 * m
            flops = 2.0 * m * k * n + 2.0 * m * r * (k + n)
            b_ms, b_by = bound_ms(nbytes, flops)
            rows.append({"kernel": "batched_lora_apply", "phase": phase,
                         "proj": proj, "m": m, "k": k, "n": n, "pages": p,
                         "rank": r, "max_abs_err": err, "tol": tol,
                         "kernel_ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": nbytes, "flop": flops,
                         "kernel_gb_per_s": nbytes / k_ms / 1e6,
                         "kernel_tflop_per_s": flops / k_ms / 1e9})
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["library_ms"] += l_ms
            tot["bound_ms"] += b_ms
            tot["bytes_ms"] += nbytes / PEAK_BYTES_PER_S * 1e3
            tot["ops_ms"] += flops / PEAK_F32_FLOPS * 1e3
            tot["max_abs_err"] = max(tot.get("max_abs_err", 0.0), err)
            del sets, args, got, want, mag
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "batched_lora_apply",
          "per_shape": rows, "per_layer": totals})
    dec = totals["decode"]
    # the summary row is one decode step's four launches of one layer
    summary["batched_lora_apply"] = {
        "max_abs_err": max(t["max_abs_err"] for t in totals.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": "bytes" if dec["bytes_ms"] >= dec["ops_ms"]
        else "operations",
        "library_ms": dec["library_ms"],
        "shape": "one decode layer: q, k, v, o at 4 rows",
        "prefill_layer": {key: totals["prefill"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms")}}


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
    from repro_torch.kernels import ops
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
    ops.reset_launches()          # the main path's count starts here
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


def _tenant_tree(torch, params, gen, device):
    """Random nonzero factors shaped like the model's adapter leaves."""
    from repro_torch.core.lora import flatten, unflatten
    flat = {}
    for path, t in flatten(params).items():
        if path[-1] == "lora_a":
            flat[path] = torch.randn(t.shape, generator=gen, device=device) \
                * t.shape[-1] ** -0.5
        elif path[-1] == "lora_b":
            flat[path] = torch.randn(t.shape, generator=gen, device=device) \
                * 0.1 * t.shape[-1] ** -0.5
    return unflatten(flat)


def phase_serve_small(torch):
    """A reduced qwen2-7b (GQA 4/2) engine on cuda with K4 and on cpu
    with the plain path, from the same weights and tenants."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              num_kv_heads=2)
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {"hi": (_tenant_tree(torch, params, gen, "cpu"), 16),
               "lo": (_tenant_tree(torch, params, gen, "cpu"), 4)}
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    runs = {}
    for dev, kern in ((DEV, True), ("cpu", False)):
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        for name, (tree, rank) in tenants.items():
            store.put(name, move(tree), rank)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            move(params), store, max_len=14, slots=2)
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        first_logits = eng.last_logits.cpu()
        for _ in range(4):
            toks.append(eng.decode([True, True]).cpu())
        runs[dev] = (torch.stack(toks, dim=1), first_logits)
    (tc, lc), (th, lh) = runs[DEV], runs["cpu"]
    logit_err = float((lc - lh).abs().max())
    ok_logits = bool(torch.allclose(lc, lh, rtol=1e-4, atol=1e-5))
    ok_tokens = bool(torch.equal(tc, th))
    emit({"phase": "serve_small", "tokens_cuda": tc.tolist(),
          "tokens_cpu": th.tolist(), "tokens_equal": ok_tokens,
          "first_logits_max_abs_err": logit_err,
          "tol": {"rtol": 1e-4, "atol": 1e-5}})
    require(ok_tokens, "serve_small: cuda and cpu greedy tokens differ")
    require(ok_logits, "serve_small: first-step logits beyond rtol 1e-4")


def phase_serve_qwen2_7b(torch) -> int:
    """Main path 2: the serving engine at Qwen2-7B's full width in f32,
    K4 on every q/k/v/o projection, against the same engine's plain path
    on the card. Returns K4's launches in this run."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = get_config("qwen2-7b")
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    model = Model(cfg, lora, device=DEV, use_kernels=True)
    plain = Model(cfg, lora, device=DEV, use_kernels=False)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = model.init(gen)
    tenants = {"t16": 16, "t8": 8, "t4": 4}
    store = AdapterStore(lora.rank_levels)
    for name, rank in tenants.items():
        store.put(name, _tenant_tree(torch, params, gen, DEV), rank)
    store.publish()
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT_LEN),
                            generator=gen, device=DEV)
    slot_tenants = ["t16", "t8", "t4", "t16"]
    # one slot more than the tokens, for the profiled step at the end
    max_len = PROMPT_LEN + NEW_TOKENS + 1
    eng = ServingEngine(model, params, store, max_len=max_len, slots=SLOTS)
    ref = ServingEngine(plain, params, store, max_len=max_len, slots=SLOTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    per_step = 4 * cfg.num_layers

    def timed(fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    ops.reset_launches()          # the main path's count starts here
    active = torch.ones(SLOTS, dtype=torch.bool, device=DEV)
    steps, compared, diverged = [], 0, None
    for step in range(NEW_TOKENS):
        if step == 9:             # the round landing after 8 decode steps
            store.put("t16", _tenant_tree(torch, params, gen, DEV), 16)
            store.publish()
        before = la.batched_lora_apply.launches
        if step == 0:
            _, ms = timed(eng.admit, range(SLOTS), prompts, slot_tenants)
            _, ms_plain = timed(ref.admit, range(SLOTS), prompts,
                                slot_tenants)
        else:
            _, ms = timed(eng.decode, active)
            _, ms_plain = timed(ref.decode, active)
        grew = la.batched_lora_apply.launches - before
        require(grew == per_step, f"serve_qwen2_7b step {step}: K4 "
                                  f"launched {grew} times, expected "
                                  f"{per_step}")
        row = {"step": step, "ms": ms, "plain_ms": ms_plain,
               "k4_launches": grew}
        if diverged is None:
            dl = (eng.last_logits - ref.last_logits).abs()
            row["logits_max_abs_diff"] = float(dl.max())
            if torch.equal(eng.tokens, ref.tokens):
                compared += 1
            else:
                # a flip only rounding can explain: the plain path's top-2
                # gap at that slot is within twice the largest logit change
                slot = int((eng.tokens != ref.tokens).nonzero()[0])
                top2 = ref.last_logits[slot].topk(2).values
                gap = float(top2[0] - top2[1])
                tol = 2 * float(dl[slot].max())
                diverged = {"step": step, "slot": slot, "top2_gap": gap,
                            "tol": tol}
                require(gap <= tol, f"serve_qwen2_7b step {step}: tokens "
                                    f"differ at slot {slot} with top-2 gap "
                                    f"{gap} > {tol}")
        steps.append(row)
    want_log = [1] * 9 + [2] * (NEW_TOKENS - 9)
    require(eng.version_log == want_log and ref.version_log == want_log,
            f"serve_qwen2_7b: version logs {eng.version_log} / "
            f"{ref.version_log}, expected {want_log}")
    finite = bool(torch.isfinite(eng.last_logits).all())
    require(finite, "serve_qwen2_7b: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # one more decode step under the profiler: K4's share of device time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.decode(active)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t) * 1e3
    launches = la.batched_lora_apply.launches
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    k4_ms = sum(e.self_device_time_total for e in kern
                if "lora_" in e.key) / 1e3
    share = k4_ms / dev_ms if dev_ms else None    # None: no device trace
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]

    dec = [r["ms"] for r in steps[1:]]
    dec_plain = [r["plain_ms"] for r in steps[1:]]
    dec_ms = sum(dec) / len(dec)
    emit({"phase": "serve_qwen2_7b", "params": n_params,
          "setup_s": setup_s, "prefill_ms": steps[0]["ms"],
          "prefill_plain_ms": steps[0]["plain_ms"],
          "decode_ms_per_token": dec_ms,
          "decode_ms_median": sorted(dec)[len(dec) // 2],
          "decode_plain_ms_per_token": sum(dec_plain) / len(dec_plain),
          "tok_per_s": SLOTS / dec_ms * 1e3,
          "peak_mem_gib": peak, "version_log": eng.version_log,
          "tokens_compared_equal_steps": compared, "diverged": diverged,
          "k4_launches_per_step": per_step, "k4_launches": launches,
          "profiled_step": {"wall_ms": prof_wall, "device_ms": dev_ms,
                            "k4_device_ms": k4_ms,
                            "k4_share_of_device": share,
                            "device_idle_share": 1 - dev_ms / prof_wall,
                            "top_kernels": [
                                {"name": e.key[:90], "count": e.count,
                                 "device_ms": e.self_device_time_total / 1e3}
                                for e in top]},
          "steps": steps})
    require(launches == per_step * (NEW_TOKENS + 1),
            f"serve_qwen2_7b: K4 launched {launches} times")
    return launches


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
        phase_kernel_lora_apply(torch, summary)
        phase_round_small(torch)
        launches, server = phase_round_vit_base(torch)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, server)
        del server                # free the round before the 30.5 GB model
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_small(torch)
        launches["batched_lora_apply"] = phase_serve_qwen2_7b(torch)
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
