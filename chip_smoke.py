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
                  yardsticks; K2's, K3's, K4's and K5's rows carry the
                  SGEMM's plan (tile, splits over the depth, blocks) and
                  TFLOP/s, and beside their eager times the device times
                  of the same calls replayed from a CUDA graph
                  (``*_device_ms``); K2 and K3 must repeat bit for bit.
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
                  must equal the same engine's plain path on the card;
                  then two more prefills of each engine, in turns, and
                  one profiled prefill of each (device time).
7. serve_small_mamba2  a reduced mamba2 engine on cuda (K6) and on cpu
                  (plain), 64-token prompts (two chunks): equal tokens.
8. serve_mamba2_1p3b  main path 3: Mamba-2 1.3B at full width in f32, 4
                  slots of 1024-token prompts (4 chunks of 256) and 16 new
                  tokens over 3 tenants at ranks 16/8/4 with a hot swap;
                  K6 must launch 48 times in the admit call and never in a
                  decode step, and the tokens must equal the plain path's.
9. kernel summary one {"kernels": [...]} line, then the card's name and
                  power limit, then the final {"ok": true, ...} line.

The kernels phase holds K6 to its plain version at mamba2-1.3b's prefill
shape (with and without an initial state) and at an odd shape after K4.
Then the kernel_ops phase drives the kernel API ``repro_torch.kernels.ops``
once at full width (the path of K3, K5 and K7, which no model or round
calls, in the reference either) and holds each result to its plain
version, a second launch to the first bit for bit, and K3 to K1's
U_c @ V_c: K3 (layered) at the vit-base buckets with raFLoRA weights and
the Eq. 8 fallback (6 of 12 slabs of rank columns live, the rest skipped),
K3 (one layer) at bench_kernels' M 10, d 768, r 64 (the depth split 5
ways) and at an odd d 300, n 520 with the fallback; K5 at Qwen2-7B's q and k
projections for 128 and 4096 rows and an odd shape; K7 at Qwen2-7B's
causal prefill, vit-base's bidirectional 197 tokens, hymba-1.5b's
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

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# K2's, K3's, K4's and K5's rows also carry their graph-replayed device
# times
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


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
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
                # K2's plan, a second launch bit-equal, and the same calls
                # replayed from a CUDA graph: device time only
                require(torch.equal(got, kern(*args)),
                        f"{kname} {name}: not deterministic")
                row["plan"] = gemm_plan.plan_gram(layers, rr, depth).report()
                for key, fn in zip(DEVICE_KEYS, (lambda: kern(*args),
                                                 lambda: plain(*args),
                                                 library)):
                    row[key] = time_graph_ms(torch, fn)
                row["kernel_device_tflop_per_s"] = \
                    flops / row["kernel_device_ms"] / 1e9
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


def phase_kernel_ssd_scan(torch, summary: dict):
    """K6 vs its plain version at mamba2-1.3b's prefill shape and at an odd
    shape, each without and with an initial state; two launches must be
    bit-equal. Times at the full shape."""
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
            bsz, _, h, p, _, _, _ = shape
            row = {"kernel": "ssd_scan", "shape": name, "init_state": init,
                   "bLhpgnq": list(shape), "max_abs_err": err,
                   "tol": SCAN_TOL, "splits": k6._splits(bsz, h, p, y.device)}
            if name == "full":
                nbytes, flops = _scan_work(shape, init)
                k_ms = time_ms(torch, kern)
                p_ms = time_ms(torch, plain, iters=5, warmup=1)
                b_ms, b_by = bound_ms(nbytes, flops)
                row.update({"kernel_ms": k_ms, "plain_ms": p_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "bytes": nbytes, "flop": flops,
                            "kernel_tflop_per_s": flops / k_ms / 1e9})
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
                 "G 1, N 128, chunk 256"}


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
            "check": check,
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
        cases.append({
            "kernel": "lora_apply", "label": label,
            "call": lambda: ops.lora_apply(x, w, a, b, scale),
            "plain": lambda: la.lora_apply_plain(x, w, a, b, scale),
            "library": lambda: torch.addmm((x @ a.mT) @ b.mT, x, w,
                                           beta=scale),
            "tol": {"atol": (k + r) * eps * float(mag.max()), "rtol": 0},
            "bytes": 4 * (m * k + k * n + r * (k + n) + m * n),
            "flop": 2.0 * m * k * n + 2.0 * m * r * (k + n), "check": None,
            "plan": la.describe_plan(m, n, k)})

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
            "flop": 4.0 * d * h * b * pairs, "check": None})
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
        if case["kernel"] != "flash_attention":
            # the same calls replayed from a CUDA graph: device time only
            for key, fn in zip(DEVICE_KEYS, (case["call"], case["plain"],
                                             case["library"])):
                row[key] = time_graph_ms(torch, fn)
            row["kernel_device_tflop_per_s"] = \
                case["flop"] / row["kernel_device_ms"] / 1e9
        b_ms, b_by = bound_ms(case["bytes"], case["flop"])
        row.update({"bound_ms": b_ms, "bound_by": b_by,
                    "bytes": case["bytes"], "flop": case["flop"],
                    "kernel_tflop_per_s": case["flop"] / row["kernel_ms"]
                    / 1e9})
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
            "bound_by": bound_ms(nbytes, flops)[1],
            "library_ms": sum(r["library_ms"] for r in picked),
            "shape": " + ".join(labels),
            **{key: sum(r[key] for r in picked) for key in DEVICE_KEYS
               if all(key in r for r in picked)}}
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
    K6 on every layer's prefill scan (48 launches per admit, none per
    decode step: decode runs the one-token recurrence)."""
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
        del server                # free the round before the 30.5 GB model
        gc.collect()
        torch.cuda.empty_cache()
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
                        **s})
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
