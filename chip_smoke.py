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
                  decode and prefill; K6: mamba2-1.3b's prefill layer),
                  with times, bounds and library yardsticks; K2's to K7's
                  rows carry their plan (tile, splits over the depth,
                  blocks; K6's four CUDA launches a call; K5, K6 and K7
                  on the route "mma_tf32x3") and TFLOP/s, K1's GB/s, and
                  every row beside its eager times the device times of
                  the same calls replayed from a CUDA graph
                  (``*_device_ms``); K2, K3 and K6 must repeat bit for
                  bit. Every row's ``bound_ms`` takes the operations at
                  the peak of the route the row runs on: the CUDA cores'
                  67 TFLOP/s of IEEE f32, or 3xTF32's 165 on the tensor
                  cores (K5 above 32 rows, K6, K7; their rows also carry
                  ``bound_simt_f32_ms``, the same work at 67, and the
                  summary's ``runs_on`` names the route).
3. round_small    one fedvit-tiny (d_model=32) round on cuda and on cpu
                  from the same weights and seed; products and spectra
                  must agree to the kernel-path tolerance.
4. round_vit_base main path 1: three raFLoRA rounds of the batched engine
                  with the kernel backend at ViT-base width; K1 and K2
                  must launch in every round.
4a. round_methods one round of each method at ViT-base width from one
                  base state drawn once, in a child process with cuBLAS's
                  split-K off (``phase_round_methods_child``): fedavg
                  (ranks (16,)), hetlora, flora, ffa, flexlora, raflora
                  (the anchor), partial raFLoRA cut at 8 and 16, raflora
                  on the dense and factored backends, raflora and flora in
                  the sequential engine. Backend parity (dense, factored vs kernel) at the
                  round tolerances, engine parity (sequential vs batched)
                  at TestRoundEngineEquivalence's, the method invariants,
                  the expected K1/K2 launches of each run, and
                  ``ops.factored_stack_gram`` (K1/K2 at L = 1) on one
                  vit-base slice against its plain version.
5. serve_small    a reduced qwen2 serving engine on cuda (K4) and on cpu
                  (plain) from the same weights: equal greedy tokens.
6. serve_qwen2_7b main path 2: Qwen2-7B at full width in f32, 4 slots of
                  32-token prompts and 16 new tokens over 3 tenants at
                  ranks 16/8/4, with a hot swap after 8 decode steps; K4
                  must launch 4 x 28 times per engine step, and the tokens
                  must equal the same engine's plain path on the card;
                  then two more prefills of each engine, in turns, and
                  one profiled prefill of each (device time).
7. serve_small_mamba2  a reduced mamba2 engine on cuda (K6) and on cpu
                  (plain), 64-token prompts (two chunks): equal tokens.
8. serve_mamba2_1p3b  main path 3: Mamba-2 1.3B at full width in f32, 4
                  slots of 1024-token prompts (4 chunks of 256) and 16 new
                  tokens over 3 tenants at ranks 16/8/4 with a hot swap;
                  K6 must be called 48 times in the admit call (its
                  wrapper's count; four CUDA launches a call) and never in
                  a decode step, and the tokens must equal the plain path's.
9. kernel summary one {"kernels": [...]} line, then the card's name and
                  power limit, then the final {"ok": true, ...} line.

The kernels phase holds K6 to its plain version at mamba2-1.3b's prefill
shape (with and without an initial state) and at an odd shape after K4,
and at the full shape against a float64 run within a one-pass TF32 run's
error bound (``ssd_scan.one_pass_bound``), which the one-pass run itself
must leave.
Then the kernel_ops phase drives the kernel API ``repro_torch.kernels.ops``
once at full width (the path of K3, K5 and K7, which no model or round
calls, in the reference either) and holds each result to its plain
version, a second launch to the first bit for bit, and K3 to K1's
U_c @ V_c: K3 (layered) at the vit-base buckets with raFLoRA weights and
the Eq. 8 fallback (6 of 12 slabs of rank columns live, the rest skipped),
K3 (one layer) at bench_kernels' M 10, d 768, r 64 (the depth split 5
ways) and at an odd d 300, n 520 with the fallback; K5 at Qwen2-7B's q and k
projections for 128 and 4096 rows and an odd shape (on the tensor-core
route also against the product in f64, within a one-pass TF32 product's
error sigma, which the best one-pass TF32 product must exceed); K7 at
Qwen2-7B's causal prefill, vit-base's bidirectional 197 tokens, hymba-1.5b's
1024-token window and gemma-2b's MQA with D 256.
``--profile`` adds one profiled vit-base round after phase 4 (device time
of the top kernels, the device's idle share). Phases 6 and 8 always
profile one more decode step and one more prefill of each engine for the
kernel's share of the device time.

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

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and the f32-accurate rate of
# 3xTF32 on the tensor cores (three passes at 495 TFLOP/s TF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
# the operations' peak by route: IEEE f32 on the CUDA cores, or 3xTF32 on
# the tensor cores (csrc/mma_tf32x3.cuh)
PEAK_FLOPS = {"simt_f32": PEAK_F32_FLOPS, "mma_tf32x3": PEAK_TF32X3_FLOPS}
# every kernel's row also carries its graph-replayed device times
DEVICE_KEYS = ("kernel_device_ms", "plain_device_ms", "library_device_ms")
REPLACES = {
    "weighted_stack_b": "src/repro/kernels/rank_partition_agg.py:198",
    "weighted_stack_a": "src/repro/kernels/rank_partition_agg.py:231",
    "gram_left": "src/repro/kernels/rank_partition_agg.py:287",
    "gram_right": "src/repro/kernels/rank_partition_agg.py:320",
    "batched_lora_apply": "src/repro/kernels/lora_apply.py:153",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:88",
    "rank_partition_agg": "src/repro/kernels/rank_partition_agg.py:107",
    "rank_partition_agg_layered":
        "src/repro/kernels/rank_partition_agg.py:154",
    "lora_apply": "src/repro/kernels/lora_apply.py:68",
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
}
SOURCES = {
    "weighted_stack_b": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "weighted_stack_a": "src/repro_torch/kernels/csrc/weighted_stack.cu",
    "gram_left": "src/repro_torch/kernels/csrc/gram.cu",
    "gram_right": "src/repro_torch/kernels/csrc/gram.cu",
    "batched_lora_apply": "src/repro_torch/kernels/csrc/lora_apply.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "rank_partition_agg": "src/repro_torch/kernels/csrc/rank_partition_agg.cu",
    "rank_partition_agg_layered":
        "src/repro_torch/kernels/csrc/rank_partition_agg.cu",
    "lora_apply": "src/repro_torch/kernels/csrc/lora_apply.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# the route each kernel's products run on (a key of PEAK_FLOPS) in the
# summary's cases; K5 at most 32 rows runs its IEEE f32 GEMV, and each
# kernel_ops row names its own route
RUNS_ON = {name: "simt_f32" for name in REPLACES}
RUNS_ON.update(lora_apply="mma_tf32x3", flash_attention="mma_tf32x3",
               ssd_scan="mma_tf32x3")
# the main path each kernel's launches are counted on
PATHS = {"weighted_stack_b": "round_vit_base",
         "weighted_stack_a": "round_vit_base", "gram_left": "round_vit_base",
         "gram_right": "round_vit_base",
         "batched_lora_apply": "serve_qwen2_7b",
         "ssd_scan": "serve_mamba2_1p3b",
         "rank_partition_agg": "kernel_ops",
         "rank_partition_agg_layered": "kernel_ops",
         "lora_apply": "kernel_ops", "flash_attention": "kernel_ops"}
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
# Mamba-2 1.3B prefill: 4 slots of 1024 tokens, so the scan runs 4 chunks
MAMBA_PROMPT = 1024
# K6 shapes (B, L, H, P, G, N, chunk): the full-width prefill, an odd one
SCAN_FULL = (SLOTS, MAMBA_PROMPT, 64, 64, 1, 128, 256)
SCAN_ODD = (2, 96, 12, 24, 3, 20, 32)
SCAN_TOL = {"atol": 2e-4, "rtol": 1e-3}   # tests/test_kernels.py:377-380
# K3 at the vit-base round: 5 sampled clients at these ranks (no client
# above 16, so the partitions (16, 24] and (24, 32] take the fallback)
AGG_LEVELS = (4, 8, 16, 24, 32)
AGG_RANKS = (4, 8, 8, 16, 16)
AGG_SAMPLES = (120, 80, 100, 60, 140)
# K7 shapes (name, B, L, H, KVH, D, causal, window)
ATTN_SHAPES = (("qwen2-7b prefill", 4, 1024, 28, 4, 128, True, 0),
               ("vit-base", 32, 197, 12, 12, 64, False, 0),
               ("hymba-1.5b window", 1, 4096, 25, 5, 64, True, 1024),
               ("gemma-2b mqa", 1, 2048, 8, 1, 256, True, 0))
ATTN_TOL = {"atol": 2e-5, "rtol": 1e-4}   # tests/test_flash_attention.py
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


def bound_ms(nbytes: float, flops: float, route: str = "simt_f32") -> tuple:
    """(ms, what binds): the bytes at the memory's rate or the operations
    at the peak of ``route``, whichever takes longer."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[route] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {stem: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "entry function" in ln]
             for stem, log in build.ptxas_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(build.ptxas_log), "ptxas": ptxas})


def phase_kernels(torch, summary: dict):
    """Each kernel vs its plain version at the round's bucket shapes."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import rank_partition_agg as rpa
    gen = torch.Generator(device=DEV).manual_seed(0)
    eps = torch.finfo(torch.float32).eps
    rows = []
    for name, layers, d, n in BUCKETS:
        bs = torch.randn(layers, CLIENTS, d, RANK, generator=gen,
                         device=DEV)
        as_ = torch.randn(layers, CLIENTS, RANK, n, generator=gen,
                          device=DEV)
        # raFLoRA-like weights: zero beyond some ranks, one negative entry
        omega = torch.rand(CLIENTS, RANK, generator=gen, device=DEV)
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
            row = {"kernel": kname, "bucket": name,
                   "shape": list(args[0].shape), "max_abs_err": err,
                   "tol": tol, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "bytes": nbytes, "flop": flops,
                   "kernel_gb_per_s": nbytes / k_ms / 1e6,
                   "kernel_tflop_per_s": flops / k_ms / 1e9}
            if kname.startswith("gram"):
                # K2's plan and a second launch bit-equal
                require(torch.equal(got, kern(*args)),
                        f"{kname} {name}: not deterministic")
                row["plan"] = gemm_plan.plan_gram(layers, rr, depth).report()
            # the same calls replayed from a CUDA graph: device time only
            for key, fn in zip(DEVICE_KEYS, (lambda: kern(*args),
                                             lambda: plain(*args), library)):
                row[key] = time_graph_ms(torch, fn)
            row["kernel_device_tflop_per_s"] = \
                flops / row["kernel_device_ms"] / 1e9
            row["kernel_device_gb_per_s"] = \
                nbytes / row["kernel_device_ms"] / 1e6
            rows.append(row)
            s = summary.setdefault(kname, {
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0, "bound_by": b_by})
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["ms"] += k_ms
            s["plain_ms"] += p_ms
            s["bound_ms"] += b_ms
            s["library_ms"] += l_ms
            for key in DEVICE_KEYS:
                if key in row:
                    s[key] = s.get(key, 0.0) + row[key]
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


_SIDE_STREAM = []     # time_graph_ms's warm-up stream, made once


def time_graph_ms(torch, fn, arg_sets=((),), iters: int = 20) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls, cycling
    through ``arg_sets``, captured into one CUDA graph and replayed, so no
    host time falls between the calls. Where the host takes longer to
    issue a call than the card to run it (K4/K5 at 128 rows), the eager
    times (``time_ms``, ``time_rotating_ms``) measure the host; this one
    is reported beside them as ``*_device_ms``. The warm-up runs on one
    side stream for every call: cuBLAS keeps a workspace for each stream
    it meets and never frees it, so a new stream per call would leave
    memory behind that raises every later phase's peak."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


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

            def lib(*t):
                return _lora_library(torch, *t)

            k_ms = time_rotating_ms(torch, la.batched_lora_apply, sets)
            p_ms = time_rotating_ms(torch, la.batched_lora_apply_plain, sets)
            l_ms = time_rotating_ms(torch, lib, sets)
            # the same calls replayed from a CUDA graph: device time only
            dev = {"kernel_device_ms": time_graph_ms(
                       torch, la.batched_lora_apply, sets),
                   "plain_device_ms": time_graph_ms(
                       torch, la.batched_lora_apply_plain, sets),
                   "library_device_ms": time_graph_ms(torch, lib, sets)}
            nbytes = 4 * (k * n + p * r * (k + n) + m * (k + n) + p) + 4 * m
            flops = 2.0 * m * k * n + 2.0 * m * r * (k + n)
            b_ms, b_by = bound_ms(nbytes, flops)
            rows.append({"kernel": "batched_lora_apply", "phase": phase,
                         "proj": proj, "m": m, "k": k, "n": n, "pages": p,
                         "rank": r, "plan": la.describe_plan(m, n, k),
                         "max_abs_err": err, "tol": tol,
                         "kernel_ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, **dev,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "flop": flops,
                         "kernel_gb_per_s": nbytes / k_ms / 1e6,
                         "kernel_tflop_per_s": flops / k_ms / 1e9,
                         "kernel_device_tflop_per_s":
                             flops / dev["kernel_device_ms"] / 1e9})
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["library_ms"] += l_ms
            for key, val in dev.items():
                tot[key] = tot.get(key, 0.0) + val
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
        "decode_layer_device": {key: dec[key] for key in DEVICE_KEYS},
        "prefill_layer": {key: totals["prefill"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms",
                           *DEVICE_KEYS)}}


def _scan_inputs(torch, shape, gen, init):
    """K6 inputs on the card: x ~ N(0, 1); dt = softplus(N(0, 1) - 4),
    about 0.02; A = -exp(0.5 N(0, 1) - 1), about -0.4; b, c ~ 0.3 N(0, 1);
    d ~ N(0, 1). A chunk of 256 keeps about a fifth of its state, so the
    carry across chunks shows in y. ``init`` adds an N(0, 1) state."""
    bsz, length, h, p, g, n, _ = shape
    softplus = torch.nn.functional.softplus

    def rand(*dims):
        return torch.randn(*dims, generator=gen, device=DEV)
    args = (rand(bsz, length, h, p), softplus(rand(bsz, length, h) - 4.0),
            0.5 * rand(h) - 1.0, 0.3 * rand(bsz, length, g, n),
            0.3 * rand(bsz, length, g, n), rand(h))
    return args, (rand(bsz, h, p, n) if init else None)


def _scan_work(shape, init: bool) -> tuple:
    """(bytes, FLOP) K6 cannot avoid: each input read once and each output
    written once; the recurrence's two state products, the update
    S += B (dt x)^T and the readout C . S, 2 P N multiply-adds per (token,
    head). The chunked form's intra-chunk Q x Q products are left out: a
    smaller chunk avoids them."""
    bsz, length, h, p, g, n, _ = shape
    nbytes = 4 * (2 * bsz * length * h * p + bsz * length * h
                  + 2 * bsz * length * g * n + 2 * h
                  + (2 if init else 1) * bsz * h * p * n)
    mac = 2 * bsz * length * h * p * n
    return nbytes, 2.0 * mac


def _scan_precision(torch, k6, args, chunk, y) -> dict:
    """K6's route carries f32's precision, not TF32's: against a float64
    run, y stays at every output within ``ssd_scan.one_pass_bound`` (a
    one-pass TF32 run's error sigma there plus f32's rounding bound), and
    the same decomposition with each product in one TF32 pass at its most
    accurate leaves it. Reports the largest error over bound of each."""
    want = k6.ssd_scan_f64(*args, chunk)[0]
    bound = k6.one_pass_bound(*args, chunk)
    err = (y.double() - want).abs()
    one_pass = (k6.ssd_scan_one_pass_tf32(*args, chunk)[0] - want).abs()
    ratio = float((err / bound).max())
    one_ratio = float((one_pass / bound).max())
    require(ratio <= 1, f"ssd_scan: error against f64 {ratio} times the "
                        "one-pass TF32 bound")
    require(one_ratio > 1, f"ssd_scan: a one-pass TF32 run holds the bound "
                           f"too ({one_ratio})")
    return {"f64_max_abs_err": float(err.max()),
            "f64_err_over_bound": ratio,
            "one_pass_tf32_max_abs_err": float(one_pass.max()),
            "one_pass_tf32_err_over_bound": one_ratio,
            "one_pass_bound_max": float(bound.max())}


def phase_kernel_ssd_scan(torch, summary: dict):
    """K6 vs its plain version at mamba2-1.3b's prefill shape and at an odd
    shape, each without and with an initial state; two launches must be
    bit-equal. Every row prints the plan (CUDA launches a call, blocks a
    launch, route). At the full shape: eager and device times, TFLOP/s of
    the counted work (``_scan_work``) and of the work done (the plan's),
    and the check that tells 3xTF32 from one TF32 pass."""
    from repro_torch.kernels import ssd_scan as k6
    gen = torch.Generator(device=DEV).manual_seed(2)
    rows = []
    for name, shape in (("full", SCAN_FULL), ("odd", SCAN_ODD)):
        for init in (False, True):
            args, init_state = _scan_inputs(torch, shape, gen, init)
            chunk = shape[-1]

            def kern():
                return k6.ssd_scan(*args, chunk, init_state=init_state)

            def plain():
                return k6.ssd_scan_plain(*args, chunk, init_state=init_state)
            (y, s), (want_y, want_s) = kern(), plain()
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()),
                      float((s - want_s).abs().max()))
            ok = bool(torch.allclose(y, want_y, **SCAN_TOL)) and \
                bool(torch.allclose(s, want_s, **SCAN_TOL))
            require(ok, f"ssd_scan {name} init={init}: max_abs_err {err} "
                        f"beyond {SCAN_TOL}")
            y2, s2 = kern()
            require(torch.equal(y, y2) and torch.equal(s, s2),
                    f"ssd_scan {name} init={init}: not deterministic")
            bsz, length, h, p, g, n, _ = shape
            plan = k6.plan_scan(bsz, length, h, p, g, n, min(chunk, length))
            row = {"kernel": "ssd_scan", "shape": name, "init_state": init,
                   "bLhpgnq": list(shape), "max_abs_err": err,
                   "tol": SCAN_TOL, "plan": plan.report()}
            if name == "full":
                nbytes, flops = _scan_work(shape, init)
                k_ms = time_ms(torch, kern)
                p_ms = time_ms(torch, plain, iters=5, warmup=1)
                dev = {"kernel_device_ms": time_graph_ms(torch, kern),
                       "plain_device_ms": time_graph_ms(torch, plain,
                                                        iters=5)}
                b_ms, b_by = bound_ms(nbytes, flops, RUNS_ON["ssd_scan"])
                row.update({"kernel_ms": k_ms, "plain_ms": p_ms, **dev,
                            "runs_on": RUNS_ON["ssd_scan"],
                            "bound_ms": b_ms, "bound_by": b_by,
                            "bound_simt_f32_ms": bound_ms(nbytes, flops)[0],
                            "bytes": nbytes, "flop": flops,
                            "flop_done": plan.flop,
                            "kernel_tflop_per_s": flops / k_ms / 1e9,
                            "kernel_device_tflop_per_s":
                                flops / dev["kernel_device_ms"] / 1e9,
                            "kernel_done_tflop_per_s":
                                plan.flop / k_ms / 1e9,
                            "kernel_device_done_tflop_per_s":
                                plan.flop / dev["kernel_device_ms"] / 1e9})
                if not init:
                    row.update(_scan_precision(torch, k6, args, chunk, y))
            rows.append(row)
            del args, init_state, y, s, want_y, want_s, y2, s2
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "ssd_scan", "per_shape": rows})
    main = rows[0]            # the prefill's launch: no initial state
    summary["ssd_scan"] = {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "tol": SCAN_TOL,
        "shape": "one mamba2-1.3b prefill layer: B 4, L 1024, H 64, P 64, "
                 "G 1, N 128, chunk 256",
        **{key: main[key] for key in ("kernel_device_ms", "plain_device_ms",
                                      "bound_simt_f32_ms", "plan",
                                      "f64_max_abs_err", "f64_err_over_bound",
                                      "one_pass_tf32_err_over_bound")}}


def _ops_cases(torch):
    """The kernel API's calls at full width. Each case: kernel name, label,
    the ``ops`` call, its plain version on the same (appended, padded)
    inputs, the library yardstick, the tolerance, bytes and FLOP, and an
    optional extra check."""
    from repro_torch.core.partitions import omega_raflora
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ops
    from repro_torch.kernels import rank_partition_agg as rpa
    from repro_torch.kernels import tf32x3
    gen = torch.Generator(device=DEV).manual_seed(3)
    eps = torch.finfo(torch.float32).eps
    cases = []

    def rand(*dims):
        return torch.randn(*dims, generator=gen, device=DEV)

    def agg_case(label, kname, layers, m, d, r, n, omega, fallback):
        """Client factors zero beyond each client's rank, as masked
        training leaves them; global factors only with a fallback."""
        lead = () if layers is None else (layers,)
        ax = len(lead)
        ranks = (omega != 0).sum(dim=1)
        keep = (torch.arange(r, device=DEV)[None, :] < ranks[:, None]).float()
        bs = rand(*lead, m, d, r) * keep[:, None, :]
        as_ = rand(*lead, m, r, n) * keep[:, :, None]
        extra = ((rand(*lead, d, r), rand(*lead, r, n), fallback)
                 if fallback is not None else ())
        entry = ops.rank_partition_agg_layered if layers else \
            ops.rank_partition_agg
        plain = rpa.rank_partition_agg_layered_plain if layers else \
            rpa.rank_partition_agg_plain
        fb, ab, om = ops._append_fallback_client(
            bs, as_, omega, *(extra or (None, None, None)), layer_axes=ax)
        fb, ab = ops._pad_to(fb, ax + 2, 8), ops._pad_to(ab, ax + 1, 8)
        om = ops._pad_to(om, 1, 8)
        depth = om.numel()
        mag = plain(fb.abs(), ab.abs(), om.abs())
        # the library's one call: the omega-scaled stacks, built beforehand
        u_lib = (fb * om[:, None, :]).movedim(ax, ax + 1).reshape(
            *lead, d, depth)
        v_lib = ab.reshape(*lead, depth, n)
        out_elems = (layers or 1) * d * n
        live = rpa.live_slabs(om)
        check = None
        if layers:
            def check(got):
                """dW against K1's U_c @ V_c: sqrt(omega)^2 rounds, so twice
                the sum's rounding plus four roundings per product."""
                u, v = ops.factored_stack_layered(fb, ab, om)
                err = float((u @ v - got).abs().max())
                tol = (2 * depth + 4) * eps * float(mag.max())
                require(err <= tol, f"{label}: K3 vs K1 U_c V_c {err} > {tol}")
                return {"k1_max_abs_err": err, "k1_tol": tol}
        cases.append({
            "kernel": kname, "label": label,
            "call": lambda: entry(bs, as_, omega, *extra),
            "plain": lambda: plain(fb, ab, om),
            "library": lambda: torch.matmul(u_lib, v_lib),
            "tol": {"atol": (depth + 2) * eps * float(mag.max()), "rtol": 0},
            "bytes": 4 * (fb.numel() + ab.numel() + om.numel() + out_elems),
            # a zero weight's rank column adds nothing: count what these
            # weights need
            "flop": 2.0 * out_elems * int((om != 0).sum()),
            "flop_dense": 2.0 * out_elems * depth,
            "check": check, "route": "simt_f32",
            "plan": gemm_plan.plan_agg(layers or 1, om.shape[0], d,
                                       om.shape[1], n).report(),
            # the 16-deep slabs the kernel runs, of all
            "live_slabs": [int(live.sum()), live.numel()]})

    omega, fallback = omega_raflora(AGG_RANKS, AGG_SAMPLES, AGG_LEVELS)
    omega = torch.tensor(omega, dtype=torch.float32, device=DEV)
    fallback = torch.tensor(fallback, dtype=torch.float32, device=DEV)
    for name, layers, d, n in BUCKETS:
        agg_case(f"vit-base {name}", "rank_partition_agg_layered", layers,
                 len(AGG_RANKS), d, RANK, n, omega, fallback)
    agg_case("bench_kernels M 10 d 768 r 64", "rank_partition_agg", None,
             10, 768, 64, 768, torch.rand(10, 64, generator=gen, device=DEV),
             None)
    agg_case("odd d 300 n 520 r 12, fallback", "rank_partition_agg", None,
             3, 300, 12, 520, torch.rand(3, 12, generator=gen, device=DEV),
             (torch.arange(12, device=DEV) >= 8).float())

    def lora_case(label, m, k, n, r, scale):
        x = rand(m, k)
        w = rand(k, n) * k ** -0.5
        a = rand(r, k) * k ** -0.5
        b = rand(n, r) * 0.1
        mag = la.lora_apply_plain(x.abs(), w.abs(), a.abs(), b.abs(),
                                  abs(scale))
        tensor_cores = m > la.GEMV_MAX_ROWS

        def check(got):
            """The tensor-core route carries f32's precision, not TF32's:
            against the product in f64, its error stays within one
            standard deviation of a one-pass TF32 product's error, and
            the best one-pass TF32 product (TF32 operands summed in f64)
            exceeds that bound here."""
            lora = scale * ((x.double() @ a.double().T) @ b.double().T)
            exact = x.double() @ w.double() + lora
            tol = tf32x3.one_pass_sigma(x, w)
            err = float((got.double() - exact).abs().max())
            one_pass = float((tf32x3.one_pass_matmul(x, w) + lora - exact)
                             .abs().max())
            require(err <= tol, f"{label}: error against f64 {err} beyond "
                                f"a one-pass TF32 product's sigma {tol}")
            require(one_pass > tol, f"{label}: a one-pass TF32 product "
                                    f"({one_pass}) holds {tol} too")
            return {"f64_max_abs_err": err, "tf32_sigma_tol": tol,
                    "one_pass_tf32_max_abs_err": one_pass}
        cases.append({
            "kernel": "lora_apply", "label": label,
            "call": lambda: ops.lora_apply(x, w, a, b, scale),
            "plain": lambda: la.lora_apply_plain(x, w, a, b, scale),
            "library": lambda: torch.addmm((x @ a.mT) @ b.mT, x, w,
                                           beta=scale),
            "tol": {"atol": (k + r) * eps * float(mag.max()), "rtol": 0},
            "bytes": 4 * (m * k + k * n + r * (k + n) + m * n),
            "flop": 2.0 * m * k * n + 2.0 * m * r * (k + n),
            "check": check if tensor_cores else None,
            "route": "mma_tf32x3" if tensor_cores else "simt_f32",
            "plan": la.describe_plan(m, n, k, tensor_cores=True)})

    for m in (SLOTS * PROMPT_LEN, SLOTS * 1024):
        for proj, k, n in QWEN_PROJ[:2]:
            lora_case(f"qwen2-7b {proj} {m} rows", m, k, n, SERVE_RANK, 2.0)
    lora_case("odd M 300 K 130 N 520 r 12", 300, 130, 520, 12, 1.7)

    import torch.nn.functional as F
    for label, b, length, h, kvh, d, causal, window in ATTN_SHAPES:
        q, k, v = rand(b, length, h, d), rand(b, length, kvh, d), \
            rand(b, length, kvh, d)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        band = fa._band(length, length, causal, window, DEV)
        mask = band if window else None

        def library(qh=qh, kh=kh, vh=vh, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask,
                is_causal=causal and mask is None,
                enable_gqa=True).transpose(1, 2)
        pairs = int(band.sum())   # (query, key) pairs inside the band
        cases.append({
            "kernel": "flash_attention", "label": label,
            "call": lambda q=q, k=k, v=v, c=causal, w=window:
                ops.flash_attention(q, k, v, c, w),
            "plain": lambda q=q, k=k, v=v, c=causal, w=window:
                fa.flash_attention_plain(q, k, v, c, w),
            "library": library, "tol": ATTN_TOL,
            "bytes": 4 * (2 * q.numel() + 2 * k.numel()),
            "flop": 4.0 * d * h * b * pairs, "check": None,
            "route": "mma_tf32x3",
            "plan": fa.plan_attention(b, length, h, d).report(),
            # the plain version's (B, H, L, L) scores at hymba's 4096
            # tokens take 1.7 GB a call: no graph of 20 of them
            "plain_device": length * length * h * b * 4 < 1e9})
    return cases


# which case of each kernel the summary line reports: K3 layered summed
# over a vit-base round's three buckets, K5 summed over a prefill layer's q
# and k at 4096 rows, K3 and K7 one call each
SUMMARY_CASES = {
    "rank_partition_agg_layered": tuple(f"vit-base {b[0]}" for b in BUCKETS),
    "rank_partition_agg": ("bench_kernels M 10 d 768 r 64",),
    "lora_apply": ("qwen2-7b q 4096 rows", "qwen2-7b k 4096 rows"),
    "flash_attention": ("qwen2-7b prefill",),
}


def phase_kernel_ops(torch, summary: dict) -> dict:
    """K3, K5 and K7 through the kernel API at full width. The path (one
    ``ops`` call per case) runs with the counts set to 0 just before it and
    read just after; then each result is held to its plain version and to
    a second launch, and all three are timed. Returns the path's counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lora_apply import lora_apply
    from repro_torch.kernels.rank_partition_agg import DENSE_KERNELS
    kernels = DENSE_KERNELS + (lora_apply, flash_attention)
    cases = _ops_cases(torch)
    torch.cuda.synchronize()
    ops.reset_launches()          # the kernel API's path starts here
    outs = [case["call"]() for case in cases]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    want_launches = {k.__name__: sum(c["kernel"] == k.__name__ for c in cases)
                     for k in kernels}
    require(launches == want_launches, f"kernel_ops: launches {launches}, "
                                       f"expected {want_launches}")
    rows = []
    for case, got in zip(cases, outs):
        label = f"{case['kernel']} {case['label']}"
        want = case["plain"]()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
        require(bool(torch.allclose(got, want, **case["tol"])),
                f"{label}: max_abs_err {err} beyond {case['tol']}")
        require(torch.equal(got, case["call"]()),
                f"{label}: not deterministic")
        row = {"kernel": case["kernel"], "case": case["label"],
               "shape": list(got.shape), "max_abs_err": err,
               "tol": case["tol"]}
        if case["check"] is not None:
            row.update(case["check"](got))
        heavy = case["kernel"] == "flash_attention"
        lib = case["library"]()
        row["library_max_abs_err"] = float((lib - want).abs().max())
        row["kernel_ms"] = time_ms(torch, case["call"])
        row["plain_ms"] = time_ms(torch, case["plain"],
                                  iters=5 if heavy else 20,
                                  warmup=1 if heavy else 3)
        row["library_ms"] = time_ms(torch, case["library"])
        # the same calls replayed from a CUDA graph: device time only
        for key, fn in zip(DEVICE_KEYS, (case["call"], case["plain"],
                                         case["library"])):
            if key != "plain_device_ms" or case.get("plain_device", True):
                row[key] = time_graph_ms(torch, fn, iters=5 if heavy
                                         and fn is case["plain"] else 20)
        row["kernel_device_tflop_per_s"] = \
            case["flop"] / row["kernel_device_ms"] / 1e9
        route = case["route"]
        b_ms, b_by = bound_ms(case["bytes"], case["flop"], route)
        row.update({"runs_on": route, "bound_ms": b_ms, "bound_by": b_by,
                    "bytes": case["bytes"], "flop": case["flop"],
                    "kernel_tflop_per_s": case["flop"] / row["kernel_ms"]
                    / 1e9})
        if route != "simt_f32":
            # the parent's SIMT kernels faced this bound for the same work
            row["bound_simt_f32_ms"] = bound_ms(case["bytes"],
                                                case["flop"])[0]
        for key in ("flop_dense", "plan", "live_slabs"):
            if key in case:
                row[key] = case[key]
        rows.append(row)
        del want, lib
    del outs
    torch.cuda.empty_cache()
    emit({"phase": "kernel_ops", "per_case": rows, "launches": launches})
    for kname, labels in SUMMARY_CASES.items():
        picked = [r for r in rows
                  if r["kernel"] == kname and r["case"] in labels]
        require(len(picked) == len(labels), f"{kname}: summary cases missing")
        nbytes = sum(r["bytes"] for r in picked)
        flops = sum(r["flop"] for r in picked)
        summary[kname] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == kname),
            "ms": sum(r["kernel_ms"] for r in picked),
            "plain_ms": sum(r["plain_ms"] for r in picked),
            "bound_ms": sum(r["bound_ms"] for r in picked),
            "bound_by": bound_ms(nbytes, flops, RUNS_ON[kname])[1],
            "library_ms": sum(r["library_ms"] for r in picked),
            "shape": " + ".join(labels),
            **{key: sum(r[key] for r in picked)
               for key in DEVICE_KEYS + ("bound_simt_f32_ms",)
               if all(key in r for r in picked)}}
        require(all(r["runs_on"] == RUNS_ON[kname] for r in picked),
                f"{kname}: a summary case runs off {RUNS_ON[kname]}")
    return launches


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


def _vit_base_setup():
    """Phase 4's ViT-base round setup: the model config, the FLConfig (20
    clients, participation 0.25, batches of 32), raFLoRA's rank levels
    4..32, and the data and client shards."""
    from repro_torch.configs import FLConfig, LoRAConfig, get_config
    from repro_torch.data import ClusterClassification, make_partition
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
    return cfg, fl, lora, shards, x_tr, y_tr, data.patches


def _stage_timer(torch, times: dict):
    """timed(stage, fn, keep=None): ``fn`` wrapped to record its device
    time (CUDA events) under ``times[stage]``, and its arguments and
    output under ``keep`` when given."""
    def timed(stage, fn, keep=None):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            end.synchronize()
            times[stage] = start.elapsed_time(end)
            if keep is not None:
                keep["args"], keep["out"] = a, out
            return out
        return wrapper
    return timed


def phase_round_vit_base(torch, rounds: int = 3) -> dict:
    """The main path: raFLoRA rounds at ViT-base width, kernel backend."""
    import numpy as np
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.kernels import ops
    from repro_torch.kernels import rank_partition_agg as rpa
    from repro_torch.models.transformer import Model

    t0 = time.perf_counter()
    cfg, fl, lora, shards, x_tr, y_tr, patches = _vit_base_setup()
    registry = ClientRegistry.create(fl, lora, shards)
    model = Model(cfg, lora, device="cuda")
    batch_fn = make_batch_fn(registry, x_tr, y_tr, fl, 2, patches)
    server = FederatedLoRA(model, fl, lora, registry, batch_fn,
                           backend="kernel")
    setup_s = time.perf_counter() - t0

    times: dict = {}
    trained: dict = {}
    timed = _stage_timer(torch, times)

    server._plan_round = timed("plan_ms", server._plan_round)
    server._train_grouped = timed("train_ms", server._train_grouped, trained)
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


# round_methods: (label, method, backend, engine, rank levels, partial_up_to)
WIDE_LEVELS = (4, 8, 16, 24, 32)
METHOD_RUNS = (
    ("fedavg", "fedavg", "kernel", "batched", (16,), None),
    ("hetlora", "hetlora", "kernel", "batched", WIDE_LEVELS, None),
    ("flora", "flora", "kernel", "batched", WIDE_LEVELS, None),
    ("ffa", "ffa", "kernel", "batched", WIDE_LEVELS, None),
    ("flexlora", "flexlora", "kernel", "batched", WIDE_LEVELS, None),
    ("raflora", "raflora", "kernel", "batched", WIDE_LEVELS, None),
    ("raflora-partial8", "raflora", "kernel", "batched", WIDE_LEVELS, 8),
    ("raflora-partial16", "raflora", "kernel", "batched", WIDE_LEVELS, 16),
    ("raflora-dense", "raflora", "dense", "batched", WIDE_LEVELS, None),
    ("raflora-factored", "raflora", "factored", "batched", WIDE_LEVELS,
     None),
    ("raflora-sequential", "raflora", "kernel", "sequential", WIDE_LEVELS,
     None),
    ("flora-sequential", "flora", "kernel", "sequential", WIDE_LEVELS, None),
)
VIT_BUCKETS = 3          # q/k/v/o, up, down: the batched engine's buckets
VIT_PARENTS = 6          # vit-base's LoRA targets: the sequential engine's
ROUND_TOL = {"product": 2e-3, "sigma": 1e-3}   # tests/test_torch_round.py
ENGINE_TOL = {"loss_rtol": 1e-4, "product": 1e-4, "base_rtol": 1e-4,
              "base_atol": 1e-5}               # TestRoundEngineEquivalence


def _expected_launches(method, backend, engine) -> int:
    """K1/K2 launches a round, each of the four functions: the SVD family
    on the kernel backend runs them once per shape bucket (batched) or
    once per adapter parent (sequential: ``aggregate_layer`` on the
    scan-stacked (12, d, r) factors of each parent takes the layered
    route); every other run none."""
    if method not in ("flexlora", "raflora") or backend != "kernel":
        return 0
    return VIT_BUCKETS if engine == "batched" else VIT_PARENTS


def _method_round(torch, server, method, engine) -> dict:
    """One round of ``server`` with its stages timed; returns what the
    phase's checks read: stats, the trained plan, every aggregated
    spectrum, the launches, the globals before and after."""
    from repro_torch.core.lora import flatten
    from repro_torch.kernels import rank_partition_agg as rpa
    times, kept, sigmas = {}, {}, []
    timed = _stage_timer(torch, times)
    server._plan_round = timed("plan_ms", server._plan_round)
    server._train_stage = timed("train_ms", server._train_stage, kept)
    server._aggregate_stage = timed("aggregate_ms", server._aggregate_stage)
    agg = server.aggregator
    entry = "aggregate_grouped" if engine == "batched" else "aggregate_layer"
    inner = getattr(agg, entry)

    def capture(*a, **k):
        res = inner(*a, **k)
        if res.sigma is not None:
            sigmas.append(res.sigma)
        return res
    setattr(agg, entry, capture)
    lora_before = {p: x.clone() for p, x in flatten(server.global_lora).items()}
    base_before = flatten(server.base)
    before = [k.launches for k in rpa.KERNELS]
    torch.cuda.reset_peak_memory_stats()
    stats = server.run_round()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches - b
                for k, b in zip(rpa.KERNELS, before)}
    return {"stats": stats, "plan": kept["args"][0], "times": times,
            "sigmas": sigmas, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "lora_before": lora_before, "base_before": base_before,
            "factors": {p: (b.clone(), a.clone()) for p, (b, a) in
                        server._extract_factors(server.global_lora,
                                                server.lora_cfg.r_max)
                        .items()},
            "base": flatten(server.base)}


def _client_stacks(plan, parent, r_max):
    """(B (M, ..., d, r_max), A, member order) of one adapter parent: the
    batched engine's group factors, or the sequential engine's uploads
    zero-padded to r_max."""
    import torch
    from repro_torch.core.aggregation import pad_stack
    if plan.group_factors is None:
        bs, as_ = pad_stack([cf[parent] for cf in plan.client_factors],
                            r_max)
        return bs, as_, list(range(len(plan.client_factors)))
    members = [i for mem, _, _ in plan.group_factors for i in mem]
    bs = torch.cat([f[parent][0] for _, _, f in plan.group_factors])
    as_ = torch.cat([f[parent][1] for _, _, f in plan.group_factors])
    return bs, as_, members


def _max_err(x, y) -> float:
    return float((x - y).abs().max())


def _check_invariants(torch, check, method, run, partial, levels) -> dict:
    """The method invariants of one run: finite globals, client factors
    zero beyond their ranks, the averaging family's n_k-weighted means,
    FFA's frozen lora_a, FLoRA's zero adapters and base moved by its dW,
    and partial raFLoRA's omega. ``check(cond, msg)`` records a failure."""
    import numpy as np
    from repro_torch.core import partitions as parts
    stats, plan = run["stats"], run["plan"]
    out = {}
    finite = all(bool(torch.isfinite(b).all() and torch.isfinite(a).all())
                 for b, a in run["factors"].values())
    check(finite, "non-finite global factors")
    zero = True
    if plan.group_factors is not None:
        for members, _, factors in plan.group_factors:
            for b, a in factors.values():
                for j, i in enumerate(members):
                    r = stats.ranks[i]
                    zero &= bool((b[j][..., r:] == 0).all())
                    zero &= bool((a[j][..., r:, :] == 0).all())
    else:       # the sequential upload is sliced to the client's rank
        for cf, r in zip(plan.client_factors, stats.ranks):
            zero &= all(b.shape[-1] == r and a.shape[-2] == r
                        for b, a in cf.values())
    check(zero, "client factors beyond their rank are not exactly zero")
    out["masked_slices_zero"] = zero
    eps = torch.finfo(torch.float32).eps
    if method in ("fedavg", "hetlora", "ffa", "flora"):
        err, tol = 0.0, 0.0
        for parent, (b_g, a_g) in run["factors"].items():
            bs, as_, members = _client_stacks(plan, parent, max(levels))
            n = np.asarray([plan.n_k[i] for i in members], np.float64)
            w = torch.as_tensor(n / n.sum(), dtype=torch.float32,
                                device=bs.device)
            wb = w.reshape((-1,) + (1,) * (bs.ndim - 1))
            if method == "flora":
                check(not b_g.any() and not a_g.any(),
                      "FLoRA's global adapter is not zero")
                dw = torch.einsum("m,m...dr,m...rn->...dn", w, bs, as_)
                w0 = run["base_before"][parent + ("w",)]
                moved = run["base"][parent + ("w",)] - w0
                p_tol = 4 * eps * float(w0.abs().max()) + \
                    1e-4 * float(dw.abs().max())
                err, tol = max(err, _max_err(moved, dw)), max(tol, p_tol)
                continue
            want_a = (wb * as_).sum(0)
            p_tol = 1e-6 * max(1.0, float(want_a.abs().max()))
            err = max(err, _max_err(a_g, want_a))
            if method == "ffa":
                lora_a = run["lora_before"][parent + ("lora_a",)]
                check(torch.equal(b_g, lora_a.mT), "FFA moved lora_a")
            else:
                want_b = (wb * bs).sum(0)
                p_tol = max(p_tol, 1e-6 * max(1.0, float(
                    want_b.abs().max())))
                err = max(err, _max_err(b_g, want_b))
            tol = max(tol, p_tol)
        key = "base_moved_by_dw" if method == "flora" else "weighted_mean"
        out[key] = {"max_abs_err": err, "tol": tol}
        check(err <= tol, f"{key} error {err} > {tol}")
    if partial is not None:
        members = _client_stacks(plan, next(iter(run["factors"])),
                                 max(levels))[2]
        ranks = [stats.ranks[i] for i in members]
        n_k = [plan.n_k[i] for i in members]
        omega, _ = run["aggregator"]._svd_weights(ranks, n_k)
        ra = parts.omega_raflora(ranks, n_k, levels)[0]
        flex = parts.omega_flexlora(ranks, n_k, max(levels))
        ok = bool(np.array_equal(omega[:, :partial], ra[:, :partial])
                  and np.array_equal(omega[:, partial:], flex[:, partial:]))
        check(ok, "partial omega is not raFLoRA's up to the cut and "
                  "FlexLoRA's beyond")
        out["partial_omega_ok"] = ok
    return out


def _products_err(fa, fb) -> tuple:
    """(max |B_a A_a - B_b A_b| over every adapter, max |B_a A_a|)."""
    err, mag = 0.0, 0.0
    for parent, (b1, a1) in fa.items():
        d1 = b1 @ a1
        err = max(err, _max_err(d1, fb[parent][0] @ fb[parent][1]))
        mag = max(mag, float(d1.abs().max()))
        del d1
    return err, mag


def _stack_gram_single(torch, anchor, levels) -> dict:
    """``ops.factored_stack_gram`` (K1/K2 at L = 1) on one vit-base slice
    -- mlp up at layer 0 (d 768, n 3072) of the anchor round's clients
    below r_max, so (24, 32] takes the Eq. 8 fallback -- against its
    plain version with the kernels phase's tolerances, and against the
    layered entry on the same slice, bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rank_partition_agg as rpa
    plan = anchor["plan"]
    parent = next(p for p in anchor["factors"] if p[-1] == "up")
    r_max = max(levels)
    bs, as_, members = _client_stacks(plan, parent, r_max)
    pick = [j for j, i in enumerate(members)
            if anchor["stats"].ranks[i] < r_max]
    ranks = [anchor["stats"].ranks[members[j]] for j in pick]
    n_k = [plan.n_k[members[j]] for j in pick]
    omega_np, fb_np = anchor["aggregator"]._svd_weights(ranks, n_k)
    require(fb_np is not None, "stack_gram_single: no Eq. 8 fallback")
    dev = bs.device
    omega = torch.as_tensor(omega_np, dtype=torch.float32, device=dev)
    fb = torch.as_tensor(fb_np, dtype=torch.float32, device=dev)
    gb = anchor["lora_before"][parent + ("lora_a",)].mT[0].contiguous()
    ga = anchor["lora_before"][parent + ("lora_b",)].mT[0].contiguous()
    b1, a1 = bs[pick][:, 0].contiguous(), as_[pick][:, 0].contiguous()
    args = (b1, a1, omega, gb, ga, fb)

    def plain():
        b2, a2, om2 = ops._append_fallback_client(*args, layer_axes=0)
        u = rpa.weighted_stack_b_plain(b2[None], om2)
        v = rpa.weighted_stack_a_plain(a2[None], om2)
        return u[0], v[0], rpa.gram_left_plain(u)[0], \
            rpa.gram_right_plain(v)[0]

    def library():
        b2, a2, om2 = ops._append_fallback_client(*args, layer_axes=0)
        w = torch.sqrt(torch.clamp(om2, min=0.0))
        u = (b2 * w[:, None, :]).permute(1, 0, 2).reshape(b2.shape[1], -1)
        v = (a2 * w[:, :, None]).reshape(-1, a2.shape[-1])
        return u, v, u.mT @ u, v @ v.mT

    before = [k.launches for k in rpa.KERNELS]
    got = ops.factored_stack_gram(*args)
    torch.cuda.synchronize()
    require([k.launches - b for k, b in zip(rpa.KERNELS, before)]
            == [1] * 4, "stack_gram_single: not one launch of each kernel")
    want = plain()
    eps = torch.finfo(torch.float32).eps
    errs = {"u_c": _max_err(got[0], want[0]), "v_c": _max_err(got[1], want[1])}
    tols = {"u_c": 0.0, "v_c": 0.0}
    d, n = b1.shape[1], a1.shape[-1]
    for key, g, w, x, depth, axis in (("g_u", got[2], want[2], want[0], d, 0),
                                      ("g_v", got[3], want[3], want[1], n, 1)):
        errs[key] = _max_err(g, w)
        tols[key] = depth * eps * float((x * x).sum(dim=axis).max())
        require(torch.equal(g, g.mT), f"stack_gram_single: {key} not "
                                      "exactly symmetric")
    for key in errs:
        require(errs[key] <= tols[key], f"stack_gram_single: {key} error "
                f"{errs[key]} > {tols[key]}")
    layered = ops.factored_stack_gram_layered(
        b1[None], a1[None], omega, gb[None], ga[None], fb)
    same = all(torch.equal(x, y[0]) for x, y in zip(got, layered))
    require(same, "stack_gram_single: differs from the layered entry")
    rr = got[0].shape[-1]
    m1 = b1.shape[0] + 1
    nbytes = 4 * (m1 * (d + n) * r_max + omega.numel() + fb.numel()
                  + (d + n) * rr + 2 * rr * rr)
    flops = float(m1 * (d + n) * r_max + (d + n) * rr * (rr + 1))
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"slice": {"parent": "/".join(parent), "layer": 0, "d": d,
                      "n": n, "clients": len(pick), "ranks": ranks,
                      "R": rr},
            "max_abs_err": errs, "tol": tols, "layered_bit_equal": same,
            "ms": time_ms(torch, lambda: ops.factored_stack_gram(*args)),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "bound_ms": b_ms, "bound_by": b_by}


def phase_round_methods(torch) -> None:
    """One round of every method at ViT-base width, from one base state
    drawn once: the paper's baselines (fedavg at ranks (16,), hetlora,
    flora, ffa), flexlora, raflora (the anchor), Fig. 5a's partial
    raFLoRA (cut at 8 and 16), raflora on the dense and factored backends,
    and raflora and flora in the sequential engine. K1/K2 launch once per
    bucket (3) in the batched kernel-backend SVD runs, once per adapter
    parent (6) in raflora-sequential, and never in the other runs (flora
    stacks its dW with an einsum; dense and factored run no kernel).
    Checks: backend parity (dense, factored vs kernel), engine parity
    (sequential vs batched, raflora and flora), the method invariants,
    and ``ops.factored_stack_gram`` at L = 1 against its plain version."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import LoRAConfig
    from repro_torch.core.lora import merge_lora, split_lora, truncate_adapters
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.models.transformer import Model

    cfg, fl0, lora0, shards, x_tr, y_tr, patches = _vit_base_setup()
    gen = torch.Generator(device=DEV).manual_seed(fl0.seed)
    params = Model(cfg, lora0, device=DEV).init(gen)
    base_p, lora_p = split_lora(params)

    def make_server(method, backend, engine, levels, partial):
        lora = LoRAConfig(rank_levels=levels,
                          rank_probs=(1.0 / len(levels),) * len(levels))
        fl = dataclasses.replace(fl0, aggregator=method)
        registry = ClientRegistry.create(fl, lora, shards)
        start = (params if lora.r_max == lora0.r_max else
                 merge_lora(base_p, truncate_adapters(lora_p, lora.r_max)))
        return FederatedLoRA(
            Model(cfg, lora, device=DEV), fl, lora, registry,
            make_batch_fn(registry, x_tr, y_tr, fl, 2, patches),
            base_params=start, backend=backend, partial_up_to=partial,
            round_engine=engine)

    # one untimed round first: this process's first cuBLAS, cuSOLVER and
    # allocator calls would otherwise land in the first run's times
    make_server("raflora", "kernel", "batched", WIDE_LEVELS,
                None).run_round()
    kept = {}
    for label, method, backend, engine, levels, partial in METHOD_RUNS:
        server = make_server(method, backend, engine, levels, partial)
        run = _method_round(torch, server, method, engine)
        run["aggregator"] = server.aggregator
        stats = run["stats"]
        fails = []

        def check(cond, msg):
            if not cond:
                fails.append(msg)
        want = _expected_launches(method, backend, engine)
        check(all(g == want for g in run["launches"].values()),
              f"launches {run['launches']}, expected {want} each")
        check(np.isfinite(stats.mean_client_loss), "non-finite client loss")
        checks = _check_invariants(torch, check, method, run, partial,
                                   levels)
        line = {"phase": "round_methods", "run": label, "method": method,
                "backend": backend, "engine": engine,
                "rank_levels": list(levels), "partial_up_to": partial,
                "clients": stats.clients, "ranks": stats.ranks,
                **run["times"], "round_wall_s": stats.wall_time_s,
                "peak_mem_gib": run["peak_mem_gib"],
                "mean_client_loss": stats.mean_client_loss,
                "higher_rank_energy_ratio":
                    (float(server.energy.higher_rank_ratio[-1])
                     if len(server.energy.rho_r1) else None),
                "launches": run["launches"], "expected_launches": want,
                **checks}
        if label == "raflora":
            kept["raflora"] = run
            line["stack_gram_single"] = _stack_gram_single(torch, run,
                                                           levels)
        elif label == "flora":
            kept["flora"] = run
        if label in ("raflora-dense", "raflora-factored"):
            anchor = kept["raflora"]
            check(stats.clients == anchor["stats"].clients,
                  "other clients than the anchor")
            scale = max(1.0, max(float(s.max()) for s in anchor["sigmas"]))
            sig = max(_max_err(s, t) for s, t in
                      zip(run["sigmas"], anchor["sigmas"]))
            prod, _ = _products_err(run["factors"], anchor["factors"])
            line["backend_parity"] = {
                "against": "raflora (kernel)", "sigma_max_abs_err": sig,
                "sigma_tol": ROUND_TOL["sigma"] * scale,
                "product_max_abs_err": prod,
                "product_tol": ROUND_TOL["product"] * scale}
            check(sig <= ROUND_TOL["sigma"] * scale,
                  f"spectra {sig} off the kernel backend's")
            check(prod <= ROUND_TOL["product"] * scale,
                  f"products {prod} off the kernel backend's")
        if engine == "sequential":
            other = kept[method]
            s_bat = other["stats"]
            check(stats.clients == s_bat.clients
                  and stats.ranks == s_bat.ranks, "other clients than batched")
            loss_rel = abs(stats.mean_client_loss
                           - s_bat.mean_client_loss) / abs(
                               s_bat.mean_client_loss)
            prod, mag = _products_err(run["factors"], other["factors"])
            p_tol = ENGINE_TOL["product"] * max(1.0, mag)
            base_ok = all(bool(torch.allclose(
                x, other["base"][p], rtol=ENGINE_TOL["base_rtol"],
                atol=ENGINE_TOL["base_atol"])) for p, x in run["base"].items())
            base_err = max(_max_err(x, other["base"][p])
                           for p, x in run["base"].items())
            line["engine_parity"] = {
                "against": f"{method} (batched)", "loss_rel_err": loss_rel,
                "loss_rtol": ENGINE_TOL["loss_rtol"],
                "product_max_abs_err": prod, "product_tol": p_tol,
                "base_max_abs_err": base_err, "base_allclose": base_ok,
                "base_rtol": ENGINE_TOL["base_rtol"],
                "base_atol": ENGINE_TOL["base_atol"]}
            check(loss_rel <= ENGINE_TOL["loss_rtol"],
                  f"loss {loss_rel} off batched")
            check(prod <= p_tol, f"products {prod} > {p_tol} off batched")
            check(base_ok, "base weights off batched")
        emit(line)
        require(not fails, f"round_methods {label}: " + "; ".join(fails))
        del server, run
        gc.collect()
        torch.cuda.empty_cache()


def phase_round_methods_child() -> None:
    """``phase_round_methods`` in a child process with cuBLAS's split-K
    reductions off (``CUBLAS_WORKSPACE_CONFIG=:0:0``; torch reads it once,
    at its first cuBLAS call). With split-K on, cuBLAS picks its reduction
    by the GEMM's row count, so a client's gradients in the batched step
    (5 clients' rows) and alone (the sequential engine) differ by rounding
    (1.8e-6 of 0.70 at vit-base), and AdamW's g / (|g| + eps) turns the
    elements whose gradient is within that rounding of zero into
    differences of up to lr / 2; with it off, the two engines' per-client
    gradients are bit-equal, as on the CPU where the reference's
    ``TestRoundEngineEquivalence`` tolerances hold. The main path (phase
    4) keeps cuBLAS's default."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--round-methods"],
        env=env, capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    err = proc.stderr.strip().splitlines()
    require(proc.returncode == 0,
            f"round_methods: child exited {proc.returncode}: "
            f"{err[-1] if err else ''}")


def phase_profile(torch, server) -> None:
    """One more vit-base round under torch.profiler: device time by
    kernel, K2's share and the device's idle share of the round."""
    emit({"phase": "profile", **_profile(torch, server.run_round, "gram")})


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


def _move(tree, dev):
    from repro_torch.core.lora import flatten, unflatten
    return unflatten({p: t.to(dev) for p, t in flatten(tree).items()})


def _serve_small(torch, phase: str, cfg, prompt_len: int, tol: dict,
                 kernel, admit_launches: int):
    """A reduced engine on cuda with ``use_kernels`` and on cpu with the
    plain path, from the same weights and tenants (ranks 16 and 4): equal
    greedy tokens over 5 steps, first-step logits within ``tol``, and
    ``kernel`` launched ``admit_launches`` times by the card's admit."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {"hi": (_tenant_tree(torch, params, gen, "cpu"), 16),
               "lo": (_tenant_tree(torch, params, gen, "cpu"), 4)}
    prompts = torch.randint(0, cfg.vocab_size, (2, prompt_len),
                            generator=gen)
    runs = []
    for dev, kern in ((DEV, True), ("cpu", False)):
        store = AdapterStore(lora.rank_levels)
        for name, (tree, rank) in tenants.items():
            store.put(name, _move(tree, dev), rank)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            _move(params, dev), store,
                            max_len=prompt_len + 6, slots=2)
        before = kernel.launches
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        launches = kernel.launches - before
        first_logits = eng.last_logits.cpu()
        for _ in range(4):
            toks.append(eng.decode([True, True]).cpu())
        runs.append((torch.stack(toks, dim=1), first_logits, launches))
    (tc, lc, launches), (th, lh, _) = runs
    ok_tokens = bool(torch.equal(tc, th))
    emit({"phase": phase, "tokens_cuda": tc.tolist(),
          "tokens_cpu": th.tolist(), "tokens_equal": ok_tokens,
          "first_logits_max_abs_err": float((lc - lh).abs().max()),
          "tol": tol, "launches_in_admit": launches})
    require(launches == admit_launches, f"{phase}: {kernel.__name__} "
                                        f"launched {launches} times in "
                                        f"admit, expected {admit_launches}")
    require(ok_tokens, f"{phase}: cuda and cpu greedy tokens differ")
    require(bool(torch.allclose(lc, lh, **tol)),
            f"{phase}: first-step logits beyond {tol}")


def phase_serve_small(torch):
    """A reduced qwen2-7b (GQA 4/2), 8-token prompts, K4 on q/k/v/o."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              num_kv_heads=2)
    _serve_small(torch, "serve_small", cfg, 8, {"rtol": 1e-4, "atol": 1e-5},
                 la.batched_lora_apply, 4 * cfg.num_layers)


def phase_serve_small_mamba2(torch):
    """A reduced mamba2, 64-token prompts so the scan carries its state
    across two chunks of 32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("mamba2-1.3b").reduced()
    _serve_small(torch, "serve_small_mamba2", cfg, 64,
                 {"rtol": 1e-4, "atol": 1e-5}, k6.ssd_scan, cfg.num_layers)


def _profile(torch, fn, match: str) -> dict:
    """One call of ``fn`` under torch.profiler: wall and device time, the
    device time of the kernels whose name contains ``match`` and their
    share, the device's idle share, the top 8 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    match_ms = sum(e.self_device_time_total for e in kern
                   if match in e.key) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall, "device_ms": dev_ms,
            "kernel_device_ms": match_ms,
            # None: the profiler saw no device time
            "kernel_share_of_device": match_ms / dev_ms if dev_ms else None,
            "device_idle_share": 1 - dev_ms / wall,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _serve_full(torch, phase: str, cfg, prompt_len: int, kernel,
                match: str, admit_launches: int,
                decode_launches: int) -> int:
    """A main serving path at full width in f32: 4 slots of ``prompt_len``
    tokens and 16 new tokens over 3 tenants at ranks 16/8/4 (slots on
    16/8/4/16), with a hot swap after 8 decode steps. The engine with
    ``use_kernels`` runs step by step against the same engine's plain path
    on the card, on one copy of the weights; ``kernel`` must launch
    ``admit_launches`` times in the admit call and ``decode_launches`` in
    each decode step. Then two more prefills of each engine in turns, and
    one more decode step and one more prefill of each engine under the
    profiler. Returns the kernel's launches on the main path."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    model = Model(cfg, lora, device=DEV, use_kernels=True)
    plain = Model(cfg, lora, device=DEV, use_kernels=False)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = model.init(gen)
    store = AdapterStore(lora.rank_levels)
    for name, rank in {"t16": 16, "t8": 8, "t4": 4}.items():
        store.put(name, _tenant_tree(torch, params, gen, DEV), rank)
    store.publish()
    prompts = torch.randint(0, cfg.vocab_size, (SLOTS, prompt_len),
                            generator=gen, device=DEV)
    slot_tenants = ["t16", "t8", "t4", "t16"]
    # one slot more than the tokens, for the profiled step at the end
    max_len = prompt_len + NEW_TOKENS + 1
    eng = ServingEngine(model, params, store, max_len=max_len, slots=SLOTS)
    ref = ServingEngine(plain, params, store, max_len=max_len, slots=SLOTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))

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
        before = kernel.launches
        if step == 0:
            call, args = (lambda e: e.admit), (range(SLOTS), prompts,
                                               slot_tenants)
            want = admit_launches
        else:
            call, args, want = (lambda e: e.decode), (active,), \
                decode_launches
        _, ms = timed(call(eng), *args)
        grew = kernel.launches - before
        _, ms_plain = timed(call(ref), *args)
        require(grew == want and kernel.launches - before == want,
                f"{phase} step {step}: {kernel.__name__} launched {grew} "
                f"times, expected {want}")
        row = {"step": step, "ms": ms, "plain_ms": ms_plain,
               "launches": grew}
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
                require(gap <= tol, f"{phase} step {step}: tokens differ "
                                    f"at slot {slot} with top-2 gap {gap} "
                                    f"> {tol}")
        steps.append(row)
    launches = kernel.launches    # read just after the main path
    want_log = [1] * 9 + [2] * (NEW_TOKENS - 9)
    require(eng.version_log == want_log and ref.version_log == want_log,
            f"{phase}: version logs {eng.version_log} / {ref.version_log},"
            f" expected {want_log}")
    require(bool(torch.isfinite(eng.last_logits).all()),
            f"{phase}: non-finite logits")
    want = admit_launches + decode_launches * (NEW_TOKENS - 1)
    require(launches == want, f"{phase}: {kernel.__name__} launched "
                              f"{launches} times, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the prefill again, the engines in turns (kernels, plain, plain,
    # kernels): the first call above also pays the first engine's
    # allocations, and the host's speed drifts within a call
    warm = {True: [], False: []}
    for kern in (True, False, False, True):
        warm[kern].append(timed((eng if kern else ref).admit, range(SLOTS),
                                prompts, slot_tenants)[1])
    prof_decode = _profile(torch, lambda: eng.decode(active), match)
    prof_prefill, prof_prefill_plain = (_profile(
        torch, lambda e=e: e.admit(range(SLOTS), prompts, slot_tenants),
        match) for e in (eng, ref))

    dec = [r["ms"] for r in steps[1:]]
    dec_plain = [r["plain_ms"] for r in steps[1:]]
    dec_ms = sum(dec) / len(dec)
    emit({"phase": phase, "params": n_params, "setup_s": setup_s,
          "prompt_len": prompt_len, "prefill_ms": steps[0]["ms"],
          "prefill_plain_ms": steps[0]["plain_ms"],
          "prefill_warm_ms": warm[True], "prefill_plain_warm_ms": warm[False],
          "decode_ms_per_token": dec_ms,
          "decode_ms_median": sorted(dec)[len(dec) // 2],
          "decode_plain_ms_per_token": sum(dec_plain) / len(dec_plain),
          "tok_per_s": SLOTS / dec_ms * 1e3,
          "prefill_tok_per_s": SLOTS * prompt_len / steps[0]["ms"] * 1e3,
          "peak_mem_gib": peak, "version_log": eng.version_log,
          "tokens_compared_equal_steps": compared, "diverged": diverged,
          "kernel": kernel.__name__, "launches_per_admit": admit_launches,
          "launches_per_decode": decode_launches, "launches": launches,
          "profiled_decode": prof_decode, "profiled_prefill": prof_prefill,
          "profiled_prefill_plain": prof_prefill_plain,
          "steps": steps})
    return launches


def phase_serve_qwen2_7b(torch) -> int:
    """Main path 2: Qwen2-7B, 32-token prompts, K4 on every q/k/v/o
    projection (4 x 28 launches per engine call)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = get_config("qwen2-7b")
    per_call = 4 * cfg.num_layers
    return _serve_full(torch, "serve_qwen2_7b", cfg, PROMPT_LEN,
                       la.batched_lora_apply, "lora_", per_call, per_call)


def phase_serve_mamba2_1p3b(torch) -> int:
    """Main path 3: Mamba-2 1.3B, 1024-token prompts (4 chunks of 256),
    K6 on every layer's prefill scan (48 calls per admit, none per decode
    step: decode runs the one-token recurrence). The profiled prefill's
    K6 share sums the four kernels, all named ssd_scan_*."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("mamba2-1.3b")
    return _serve_full(torch, "serve_mamba2_1p3b", cfg, MAMBA_PROMPT,
                       k6.ssd_scan, "ssd_scan", cfg.num_layers, 0)


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
    if "--round-methods" in sys.argv[1:]:      # phase_round_methods_child
        try:
            phase_round_methods(torch)
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
            return 1
        return 0
    summary: dict = {}
    try:
        phase_build()
        phase_kernels(torch, summary)
        phase_kernel_lora_apply(torch, summary)
        phase_kernel_ssd_scan(torch, summary)
        ops_launches = phase_kernel_ops(torch, summary)
        phase_round_small(torch)
        launches, server = phase_round_vit_base(torch)
        launches.update(ops_launches)
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, server)
        del server                # free the round before the other methods
        gc.collect()
        torch.cuda.empty_cache()
        phase_round_methods_child()
        phase_serve_small(torch)
        launches["batched_lora_apply"] = phase_serve_qwen2_7b(torch)
        gc.collect()              # free the 30.5 GB model before mamba2
        torch.cuda.empty_cache()
        phase_serve_small_mamba2(torch)
        launches["ssd_scan"] = phase_serve_mamba2_1p3b(torch)
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
                        "path": PATHS[name], "launches": require_launch,
                        "runs_on": RUNS_ON[name], **s})
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
