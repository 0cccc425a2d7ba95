#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (exits nonzero without one) and the CUDA toolkit's
``nvcc``. Imports ``repro_torch`` from ``src/`` next to this file, never
JAX. Phases, each printing one JSON line:

1. build          compile every hand-written kernel from the sources, and
                  check with ``cuobjdump -sass`` (the toolkit's, or
                  Triton's copy) that each instance of K4's bf16 route
                  above 32 rows (``lora_mma_bf16_kernel``) holds bf16
                  HMMA instructions; without the tool the phase fails.
1a. non_finite    the port's choosing seams on non-finite and tied inputs:
                  ``serving.engine.greedy`` at Qwen2-7B's vocabulary
                  (152064) in f32 and bf16, on rows with ties, NaNs and
                  infs placed in different 1024-column blocks and the
                  8-wide rows of tests/test_torch_serving.py tiled across
                  the width: equal to ``np.argmax`` of the same rows on the
                  host and to the CPU's ``greedy``, int32, its device ms at
                  4 rows beside the rule it replaced;
                  ``transport._topk_mask`` on the card bit-equal to the
                  CPU on a NaN column, an inf column, fewer than k nonzero
                  columns and a tie at the k-th energy.
2. kernels        each kernel against its plain PyTorch version on the card
                  at the shapes its main path gives it (K1/K2: the
                  vit-base round's buckets; K4: Qwen2-7B's q/k/v/o at
                  decode and prefill; K6: mamba2-1.3b's prefill layer),
                  with times, bounds and library yardsticks; K4 also at
                  Gemma-2B's, Hymba-1.5B's and Granite-3-8B's q/k/v/o,
                  K4's bf16
                  instances at Qwen2-7B's and Llama-4 Maverick's q/k/v/o
                  (decode and prefill, every element within one bf16 ulp
                  of its row's largest |value| of the plain version; the
                  summary's ``batched_lora_apply_bf16`` row), K6 also at
                  Hymba-1.5B's SSD heads (P 50, N 16, chunk 128,
                  2048 tokens); K2's to K7's
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
                  summary's ``runs_on`` names the route). Every K4 row
                  names its route and plan (``describe_plan``: "gemv" at
                  most 32 rows, its split over K; above them "sgemm" in
                  f32, "mma_bf16" in bf16) and takes its bound at the
                  peak of what it runs on: the GEMV's IEEE f32 FMAs at
                  67, the bf16 tensor cores at 989 (``bound_route``);
                  K4's rows carry ``bound_simt_f32_ms`` too, and
                  ``rank0_device_ms``, the same call with rank-0 pages
                  (no shrink launch, no expand).
3. round_small    one fedvit-tiny (d_model=32) round on cuda and on cpu
                  from the same weights and seed; products and spectra
                  must agree to the kernel-path tolerance.
4. round_vit_base main path 1: three raFLoRA rounds of the batched engine
                  with the kernel backend at ViT-base width; K1 and K2
                  must launch in every round.
4-audit.         the port's audit layer on the card (``phase_audit``,
                  after phase 4's launches are read): the CUDA lint over
                  this run's ptxas reports of the six libraries (spills
                  within the waiver table, static shared memory within 48
                  KiB) and the eight pad-to-tile probes through
                  ``kernels.ops`` on the kernels, 0 errors; the dispatch
                  audit of three vit-base rounds (kernel backend, batched
                  engine, a fixed cohort of five) against a warmup of
                  one: no library built or loaded after it, equal op
                  multisets, host syncs a round printed; the peak
                  allocated bytes of one bucket's aggregate (q/k/v/o at
                  the cohort's ranks) at d = n in 768, 1536, 3072: the
                  kernel backend's fitted slope at most 1.35
                  (``agg-live-linear-dn-kernel``), the dense backend's at
                  least 1.6 (its control); each line with the card.
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
4b. main path 4, the buffered server at ViT-base width (phase 4's setup,
                  kernel backend, int8 transport with error feedback,
                  server momentum beta 0.9, staleness gamma 0.8), each
                  phase one line with train / aggregate / momentum /
                  dequant ms, launches, peak memory, the card:
    round_async_vit_base  the async engine at depth 2, 4 rounds and
                  ``drain_pending``: K1/K2 3 launches an aggregation, 0 on
                  buffer-fill rounds, one energy entry an aggregation; a
                  fresh server restored from the checkpoint saved after
                  round 3 (mid-buffer, residuals and momentum) must equal
                  the uninterrupted run (rtol 1e-5, atol 1e-6); one
                  buffered aggregation profiled (device idle share).
    round_event_vit_base  the event engine (the clients above the minimum
                  rank straggle, timeout 2.0, round interval 1.0), 4
                  rounds and the drain: K1/K2 3 launches a fire, some
                  fire a partial cohort, every update aggregated once,
                  and a second run's fire log byte-equal.
    straggler_contrast  ``TestStragglerRankCollapse`` on the card at its
                  own size (d_model 96, 12 rounds), f32 and int8 with
                  error feedback: the test's inequalities.
4c. train_launcher  main path 5: ``python -m repro_torch.launch.train``
                  in process at its defaults (fedvit-tiny d 128, 20
                  clients, 20 rounds, rank levels 4..32) with ``--backend
                  kernel``, for flexlora and raflora: a log row a round
                  with the test accuracy at each eval, K1/K2 once per
                  shape bucket (3) every round and one call of each
                  distinct input shape over all rounds held to its plain
                  version, raFLoRA's final
                  higher-rank energy above FlexLoRA's, a server restored
                  from ``--checkpoint`` bit-equal; round ms.
4d. paper_benches  main path 6, in a child process: the paper's benches
                  through ``repro_torch.benchmarks`` (energy dynamics with
                  the same ordering check, accuracy at seed 0, cost: Table
                  3's bytes against the shape arithmetic, K1/K2 once each
                  an ``aggregate_layer`` call on the kernel backend at a
                  ViT-base layer, the three backends at round_methods'
                  parity tolerances; kernels: K5 at 512^3, K3 at one layer
                  M 10 d 768 r 64, K6 at B 2 L 256 H 8 P 32 N 32 chunk 64,
                  each within phase_kernels' tolerance; the round-latency
                  studies ``run`` and ``run_kernel_backend``, the latter's
                  K1/K2 once per bucket a kernel-backend round at d 64,
                  ranks 4/8/16, on its batched and its sharded server
                  (a one-rank NCCL group), each distinct call shape held
                  to its plain version; the serving latency study at the
                  reference's grid (batch 2/4 x adapters 1/4 x swap 0/4,
                  reduced gemma-2b), its virtual rows equal to the same
                  cells on the CPU), every CSV row and its ms.
4e. round_sharded_vit_base  main path 7, in a child process with
                  cuBLAS's split-K off: the sharded round engine at phase
                  4's setup (kernel backend, f32). (a) world 1 on NCCL, 3
                  rounds against the batched engine from the same base
                  state and seed (the round tolerances every round), K1/K2
                  3 launches a round, 2 all-reduces a bucket; (b) world 1
                  with int8 and error feedback, 1 round against the
                  batched engine with that transport (the quantized
                  collective: no K1, K2 3 launches, 4 all-reduces a
                  bucket); (c) world 2 on the one card (gloo; NCCL
                  refuses two ranks on one device), 1 round, 5 clients and
                  one ghost: products held to (a)'s batched round 0, both
                  ranks' global adapters bit-equal. Each with plan /
                  train / aggregate / collective ms, all-reduce counts,
                  peak memory and the card; every distinct K1/K2 call
                  held to its plain version.
4f. round_variants_vit_base  main path 8: the PEFT variants of Table 5
                  at phase 4's setup (kernel backend, f32): DoRA and QLoRA
                  (4 bits) x FlexLoRA and raFLoRA, 2 rounds each and one
                  more DoRA raFLoRA round under torch.profiler. K1/K2 3
                  launches a round (DoRA's magnitudes enter no bucket);
                  under DoRA every global magnitude moved, is finite and
                  equals the host's float64 FedAvg of the round's client
                  magnitudes (rtol 1e-5); under QLoRA every adapted w has
                  at most 16 levels a column and the base is unchanged by
                  a round; every distinct K1/K2 call held to its plain
                  version; stage ms, higher-rank ratio, peak GiB.
4g. round_paper_lms  main path 9, in a child process with split-K off:
                  one raFLoRA round (after an untimed one) of LLaMA-3.2-3B
                  (28 layers, d 3072, GQA 24/8, vocab 128256, tied head,
                  LoRA on q/v: 2 buckets; 12.9 GB of f32 weights) and of
                  RoBERTa-base under DoRA (3 buckets), 5 clients at rank
                  levels 8/16/32 on ``SequenceCopy`` tokens (64, batch
                  2), batched engine, kernel backend, under
                  torch.profiler: K1/K2 once per bucket, finite spectra
                  and products, the products equal to the factored
                  backend's on the same trained factors (round
                  tolerance), DoRA's magnitude check, every distinct
                  K1/K2 call held to its plain version. The third model,
                  HuBERT-XLarge (48 layers, d 1280, MHA 16 x 80 with qkv
                  bias, the audio frontend, encoder-only; 3.82 GB), trains
                  the same way on frame embeddings instead of tokens
                  (``ClusterClassification`` at dim 1280, 64 frames, 20
                  classes partitioned by class, the label read at
                  position 0): its q/k/v/o make one bucket of L = 192
                  adapters, so K1/K2 launch once; each model's buckets'
                  L must add up to its adapters, and each bucket's K2
                  plan is printed.
5. serve_small    a reduced qwen2 serving engine on cuda (K4) and on cpu
                  (plain) from the same weights: equal greedy tokens.
6. serve_qwen2_7b main path 2: Qwen2-7B at full width in f32, 4 slots of
                  32-token prompts and 16 new tokens over 3 tenants at
                  ranks 16/8/4, with a hot swap after 8 decode steps; K4
                  must launch 4 x 28 times per engine step, and the tokens
                  must equal the same engine's plain path on the card;
                  then two more prefills of each engine, in turns, and
                  one profiled prefill of each (device time).
    serve_batcher_qwen2_7b  main path 15, on phase 6's model and weights
                  before they are freed: the continuous batcher over a
                  4-slot engine (K4), 10 requests of 32-token prompts and
                  16 new tokens over tenants at ranks 16/8/4, arrivals
                  0.02 i virtual s, lognormal(0.02, 0.25) latency, costs
                  0.01 / 0.05: all complete, 4 requests equal to an
                  isolated engine, a hot swap after 8 steps with one
                  version per engine call, stats bit-equal to a host stub
                  engine's replay, K4 4 x 28 launches every engine call;
                  steps, virtual p50 / p95 / TTFT, wall ms a step.
    serve_nan_tenant_qwen2_7b  after the batcher, phase 6's K4 engine with
                  tenant t8 republished clean and then with a NaN in one
                  ``lora_b`` leaf, admit plus two decode steps on each: the
                  card synchronizes, every token in [0, V), the clean
                  slots' tokens unchanged, the poisoned slot's token the
                  first NaN of its logits on the host, K4 4 x 28 launches
                  a call.
6a. serve_qwen2_vl_7b  main path 12, after Qwen2-7B is freed: Qwen2-VL-7B
                  (M-RoPE sections (16, 24, 24), vision frontend stub) as
                  phase 6, K4 112 launches a call; then one image prefill,
                  kernel model against plain model: 4 slots of 16 x 16
                  patch embeddings and 32 tokens at Qwen2-VL's position
                  streams (patches at t 0, h row, w column; text at 16 + i
                  on all three), the last logits by the top-2-gap rule and
                  unlike those with the three streams equal.
6b. serve_gemma_2b  main path 10: Gemma-2B (MQA 8/1, head_dim 256, GeGLU,
                  vocab 256000, tied head, embeddings scaled by sqrt(d))
                  as phase 6, K4 72 launches a call (k/v at N 256).
6c. serve_granite_3_8b  main path 18, after 8g's model is freed:
                  Granite-3-8B at full depth and width in f32 (40 layers,
                  d 4096, GQA 32/8, SwiGLU 12800, vocab 49155, tied head;
                  32.75 GB) as phase 6, K4 160 launches a call (k/v at N
                  1024), tokens equal to the plain engine's every step.
7. serve_small_mamba2  a reduced mamba2 engine on cuda (K6) and on cpu
                  (plain), 64-token prompts (two chunks): equal tokens.
8. serve_mamba2_1p3b  main path 3: Mamba-2 1.3B at full width in f32, 4
                  slots of 1024-token prompts (4 chunks of 256) and 16 new
                  tokens over 3 tenants at ranks 16/8/4 with a hot swap;
                  K6 must be called 48 times in the admit call (its
                  wrapper's count; four CUDA launches a call) and never in
                  a decode step, and the tokens must equal the plain path's.
8a. serve_small_hymba  a reduced hymba engine on cuda (K4 + K6) and on cpu
                  (plain), 96-token prompts: the window of 64 bites in
                  layer 1, the scan runs 3 chunks of 32; equal tokens.
8b. serve_hymba_1p5b  main path 11: Hymba-1.5B (32 layers, GQA 25/5,
                  window 1024 with layers 0 and 16 global, 64 SSD heads of
                  P 50 in every layer) as phase 8 with 2048-token prompts:
                  the window bites in 30 layers at prefill and decode, K6
                  runs 16 chunks of 128; K4 128 launches a call, K6 32
                  calls an admit and none a decode step.
8c. serve_small_deepseek_v2  a reduced deepseek-v2 engine (MLA, 8 experts
                  top-6 + 1 shared) on cuda and on cpu: equal tokens, no K4
                  launch.
8d. serve_deepseek_v2  main path 13: DeepSeek-V2 at full width in f32
                  with 2 of its 60 layers (MLA q_lora 1536, kv_lora 512;
                  160 routed experts top-6 + 2 shared), ragged slots:
                  slots 0-2 admit 32-token prompts and decode 3 steps,
                  then slot 3 admits 20 tokens; 16 new tokens, a hot swap
                  after 8 decode steps. The cache holds only the latents
                  (2304 B a token and layer against 163,840 of per-head
                  K/V), one snapshot version a call, no K4 launch, each
                  slot's tokens held to a teacher-forced full forward;
                  call ms, host syncs (one per MoE layer), a profiled
                  decode step, peak GiB. Then the expert-parallel
                  dispatch on a world-1 NCCL ``make_host_mesh`` (destroyed
                  after): a prefill of the 4 slots' prompts through
                  ``Model(moe_impl="ep")`` dropless and at capacity 16 (no
                  overflow) within 1e-5 of the tp path's logits; at
                  capacity 1.25 finite logits, the dropped assignments,
                  no host sync (CUDA's sync debug mode raising); layer
                  0's MoE through ``moe_apply`` and the capacity dispatch
                  profiled (device ms).
8e. round_deepseek_v2  main path 14, in a child process with split-K off,
                  after the model above is freed: one raFLoRA round
                  (after an untimed one) of the same model, batched
                  engine, kernel backend, 5 clients at 8/16/32 on
                  ``SequenceCopy`` tokens (batch 2 x 64): K1/K2 once per
                  shape bucket (3: q_a, kv_a, o), the products held to
                  the factored backend's, finite spectra, each client's
                  aux loss finite and in its loss; stage ms, peak GiB,
                  the profiled round's idle share.
8f. serve_llama4_maverick  main path 16, after DeepSeek-V2 is freed:
                  Llama-4 Maverick at full width in bf16 with 2 of its 48
                  layers (a dense layer and an MoE layer of 128 experts
                  top-1 + 1 shared; 37.42 GB), its init's seconds and
                  peak (at most 1 GiB over the model's bytes), served as
                  phase 6 (K4 engine against the plain engine on the same
                  weights): K4 8 launches a call, all bf16 instances',
                  one MoE host sync a call, greedy tokens by the top-2
                  rule and against a teacher-forced full forward; first
                  and in-turn prefill ms, a profiled decode step.
8g. train_step_llama4_maverick  main path 17, inside 8f on its weights:
                  one client step of ``launch.steps.build_train_step``
                  (LoRA-only AdamW, f32 gradient accumulation) on
                  ``SequenceCopy`` tokens, batch 1 x 2048, with and
                  without ``remat`` (after an untimed step): finite losses
                  equal within 1e-3 relative, LoRA gradients within 8
                  bf16 ulps of each leaf's largest |value|, remat's peak
                  the lower; step ms and peak GiB of each.
8h. serve_nemotron_4_340b  main path 19, after 6c's model is freed:
                  Nemotron-4-340B at full width in bf16 with 2 of its 96
                  layers (d 18432, GQA 96/8 at head_dim 192, squared-ReLU
                  MLP of 73728, vocab 256000, untied head; 32.71 GB) as
                  8f: K4 on q/k/v/o, 8 launches a call, all bf16
                  instances' (the MLP's up/down adapters take the plain
                  path, as the reference's ``mlp_apply``), tokens by the
                  top-2 rule and against a teacher-forced forward; the
                  decode step's device time beside the time its bytes
                  take at 3.35 TB/s. Then K4 alone at the six projections
                  (q, k, v, o, up, down) on the served W, 4 and 4 x 32
                  rows: one bf16 ulp of the plain version, a repeat bit
                  for bit, device ms, rank-0 ms, byte bound, library ms,
                  the plan (the GEMV's several waves at up and down).
9. kernel summary one {"phase": "script_seconds"} line (each phase's wall
                  seconds, a child's with its process, and the total),
                  one {"kernels": [...]} line, then the card's name and
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
import inspect
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, the f32-accurate rate of
# 3xTF32 on the tensor cores (three passes at 495 TFLOP/s TF32), and bf16
# operands on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BF16_FLOPS = 989e12
# the operations' peak by route: IEEE f32 on the CUDA cores, 3xTF32 on
# the tensor cores (csrc/mma_tf32x3.cuh), or bf16 products on the tensor
# cores: the least time for work on bf16 operands, whatever route a
# kernel takes
PEAK_FLOPS = {"simt_f32": PEAK_F32_FLOPS, "mma_tf32x3": PEAK_TF32X3_FLOPS,
              "mma_bf16": PEAK_BF16_FLOPS}
# every kernel's row also carries its graph-replayed device times
DEVICE_KEYS = ("kernel_device_ms", "plain_device_ms", "library_device_ms")
REPLACES = {
    "weighted_stack_b": "src/repro/kernels/rank_partition_agg.py:198",
    "weighted_stack_a": "src/repro/kernels/rank_partition_agg.py:231",
    "gram_left": "src/repro/kernels/rank_partition_agg.py:287",
    "gram_right": "src/repro/kernels/rank_partition_agg.py:320",
    "batched_lora_apply": "src/repro/kernels/lora_apply.py:153",
    "batched_lora_apply_bf16": "src/repro/kernels/lora_apply.py:153",
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
    "batched_lora_apply_bf16": "src/repro_torch/kernels/csrc/lora_apply.cu",
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
# the main paths each kernel's launches are counted on
K12_PATHS = ("round_vit_base", "round_async_vit_base",
             "round_event_vit_base", "train_launcher", "bench_cost",
             "bench_round_latency", "round_sharded_vit_base",
             "round_variants_vit_base", "round_paper_lms",
             "round_deepseek_v2")
PATHS = {"weighted_stack_b": ", ".join(K12_PATHS),
         "weighted_stack_a": ", ".join(K12_PATHS),
         "gram_left": ", ".join(K12_PATHS),
         "gram_right": ", ".join(K12_PATHS),
         "batched_lora_apply": "serve_qwen2_7b, serve_batcher_qwen2_7b, "
                               "serve_qwen2_vl_7b, serve_gemma_2b, "
                               "serve_hymba_1p5b, serve_granite_3_8b",
         "batched_lora_apply_bf16": "serve_llama4_maverick, "
                                    "serve_nemotron_4_340b",
         "ssd_scan": "bench_kernels, serve_mamba2_1p3b, serve_hymba_1p5b",
         "rank_partition_agg": "kernel_ops, bench_kernels",
         "rank_partition_agg_layered": "kernel_ops",
         "lora_apply": "kernel_ops, bench_kernels",
         "flash_attention": "kernel_ops"}
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
# K4's projections per layer of the other served models: Gemma-2B's MQA
# (k/v N 256) and Hymba-1.5B's GQA 25/5 at head_dim 64 (k/v N 320)
GEMMA_PROJ = (("q", 2048, 2048), ("k", 2048, 256), ("v", 2048, 256),
              ("o", 2048, 2048))
HYMBA_PROJ = (("q", 1600, 1600), ("k", 1600, 320), ("v", 1600, 320),
              ("o", 1600, 1600))
# Hymba-1.5B prefill: 4 slots of 2048 tokens, so the window of 1024 bites
# in its 30 windowed layers and the SSD heads' scan runs 16 chunks of 128
HYMBA_PROMPT = 2048
# Granite-3-8B's GQA 32/8 at head_dim 128 (k/v N 1024), main path 18
GRANITE_PROJ = (("q", 4096, 4096), ("k", 4096, 1024), ("v", 4096, 1024),
                ("o", 4096, 4096))
# (label, projections, prefill rows) of K4's shape checks
K4_MODELS = (("qwen2-7b", QWEN_PROJ, SLOTS * PROMPT_LEN),
             ("gemma-2b", GEMMA_PROJ, SLOTS * PROMPT_LEN),
             ("hymba-1.5b", HYMBA_PROJ, SLOTS * HYMBA_PROMPT),
             ("granite-3-8b", GRANITE_PROJ, SLOTS * PROMPT_LEN))
# K4's bf16 instances: Qwen2-7B's shapes and Llama-4 Maverick's (d 5120,
# 40 heads and 8 KV heads of 128), the latter the path of main path 16
LLAMA4_PROJ = (("q", 5120, 5120), ("k", 5120, 1024), ("v", 5120, 1024),
               ("o", 5120, 5120))
K4_BF16_MODELS = (("qwen2-7b", QWEN_PROJ, SLOTS * PROMPT_LEN),
                  ("llama4-maverick", LLAMA4_PROJ, SLOTS * PROMPT_LEN))
# Nemotron-4-340B's projections in bf16 (d 18432, GQA 96/8 at head_dim
# 192, the squared-ReLU MLP of 73728), timed on main path 19's own weights:
# a decode layer's W is 6.91 GB, up and down 2.72 GB each
NEMOTRON_PROJ = (("q", 18432, 18432), ("k", 18432, 1536),
                 ("v", 18432, 1536), ("o", 18432, 18432),
                 ("up", 18432, 73728), ("down", 73728, 18432))
# Qwen2-VL-7B's image prefill: a 16 x 16 grid of patch embeddings a slot
VL_GRID = 16
# Mamba-2 1.3B prefill: 4 slots of 1024 tokens, so the scan runs 4 chunks
MAMBA_PROMPT = 1024
# K6 shapes (B, L, H, P, G, N, chunk): the full-width prefill, an odd one
SCAN_FULL = (SLOTS, MAMBA_PROMPT, 64, 64, 1, 128, 256)
SCAN_HYMBA = (SLOTS, HYMBA_PROMPT, 64, 50, 1, 16, 128)   # hymba's SSD heads
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
# greedy's rows: the 8-wide rows of tests/test_torch_serving.py's
# GREEDY_ROWS (NaN, +-inf, all -inf, all +inf, ties), each tiled across the
# vocabulary so that it repeats in every block of the card's reduction
NAN, INF = float("nan"), float("inf")
# K7 with one non-finite value entry (key kv, kv head 1, column 5) that
# some rows' band leaves out: (Lkv, causal, window, kv) at Lq 40, D 16
K7_PAST_BAND = {"causal": (40, True, 0, 30), "causal_window": (40, True, 8, 3),
                "window": (40, False, 8, 3),
                "causal_lkv_gt_lq": (48, True, 0, 44)}
# K6 at (1, 256, 4, 16, groups, 8, 64) with one non-finite entry: (groups,
# operand, token, value); x and dt at head 1, b and c at the last group.
# Tokens in a chunk's first and last 32 (the kernel's stages). Then finite
# entries whose intermediates the reference makes non-finite
# (``_k6_special``): C . B overflowing above the diagonal, x dt
# overflowing before a strong decay or in the band, and B inf beside f32
# denormal decays, which the reference flushes to 0.
K6_SPECIAL = {"ssd_scan": (1, "x", 256 - 64 + 5, INF),
              "ssd_scan_last": (1, "x", 255, INF),
              "ssd_scan_nan": (1, "x", 40, NAN),
              "ssd_scan_dt": (1, "dt", 64 + 40, INF),
              "ssd_scan_b": (1, "b", 128 + 10, -INF),
              "ssd_scan_b_g2": (2, "b", 128 + 50, INF),
              "ssd_scan_c": (1, "c", 64 + 20, INF),
              "ssd_scan_cb_overflow": (1, "cb_overflow", 64 + 6, 3e19),
              "ssd_scan_dtx_decay": (1, "dtx_decay", 64 + 10, 1e10),
              "ssd_scan_dtx_band": (1, "dtx_band", 64 + 40, 1e10),
              "ssd_scan_b_denormal": (2, "b_denormal", 20, INF)}
GREEDY_ROWS = {"nan_first": [NAN, 1, 2, 3, 0, 5, 1, 2],
               "nan_middle": [0, 1, NAN, 1, 7, 2, 1, 0],
               "nan_last": [3, 1, 2, 3, 0, 5, 1, NAN],
               "two_nans": [1, NAN, 4, 5, NAN, 2, 9, 1],
               "nan_beside_inf": [0, INF, NAN, 1, 2, INF, NAN, 3],
               "pm_inf": [INF, 1, INF, 0, -INF, 2, -INF, 3],
               "all_neg_inf": [-INF] * 8, "all_pos_inf": [INF] * 8,
               "ties": [0, 2, 2, 1, 2, 0, 1, 2], "all_equal": [5] * 8}
GREEDY_BLOCK = 1024   # columns a block, for placing ties and NaNs apart
# the NaN tenant (main path 2's engine): the poisoned tenant's slot
NAN_SLOT, NAN_STEPS = 1, 3          # admit plus two decode steps


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


def _cuobjdump():
    """The CUDA toolkit's ``cuobjdump``, or the copy Triton ships; None
    where neither is installed."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cands = [os.path.join(home, "bin", "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if os.path.exists(c)), None)


# K4's bf16 route above 32 rows: its four instances (two tiles, with and
# without 16-byte copies) and the SASS a bf16 mma.sync compiles to
BF16_MMA_KERNEL = "lora_mma_bf16_kernel"
BF16_MMA_INSTANCES = 4
HMMA_BF16 = ("HMMA", "BF16")      # an HMMA line with bf16 operands


def _sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output split into {mangled function name: its
    instruction lines}."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def phase_build():
    from repro_torch.analysis import cuda_lint
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {stem: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln or "entry function" in ln]
             for stem, log in build.ptxas_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(build.ptxas_log), "ptxas": ptxas})
    tool = _cuobjdump()
    require(tool is not None, "build: no cuobjdump (neither the CUDA "
            "toolkit's nor Triton's) to read K4's bf16 SASS with")
    sass = subprocess.run([tool, "-sass", str(build._lib_path("lora_apply"))],
                          capture_output=True, text=True, check=True).stdout
    hmma = {cuda_lint.demangle(name):
            sum(all(tok in ln for tok in HMMA_BF16) for ln in lines)
            for name, lines in _sass_functions(sass).items()
            if BF16_MMA_KERNEL in name}
    emit({"phase": "build_sass", "tool": tool, "instruction": "HMMA BF16",
          "count_by_instance": hmma})
    require(len(hmma) == BF16_MMA_INSTANCES and min(hmma.values()) > 0,
            f"build: not every instance of K4's bf16 route holds a bf16 "
            f"HMMA: {hmma}")


def _greedy_rows(np, v: int) -> dict:
    """(name, row of ``v`` f32 logits) by the case it pins: ``GREEDY_ROWS``
    tiled, and seeded normal rows with ties, NaNs and infs placed in
    different ``GREEDY_BLOCK``-column blocks (the first of each is the
    row's answer where it is the first maximum or the first NaN)."""
    blk = GREEDY_BLOCK
    rows = {name: np.resize(np.asarray(row, np.float32), v)
            for name, row in GREEDY_ROWS.items()}
    rng = np.random.default_rng(0)
    placed = {"plain": {},
              "tie_across_blocks": {3 * blk + 7: 50.0, 70 * blk + 1: 50.0,
                                    v - 1: 50.0},
              "nan_across_blocks": {10: 50.0, 40 * blk + 3: NAN,
                                    2 * blk + 5: NAN},
              "nan_in_last_block": {0: 50.0, v - 1: NAN},
              "nan_after_inf": {5 * blk: INF, 100 * blk + 9: NAN},
              "inf_across_blocks": {9 * blk + 1: INF, 120 * blk: INF},
              "tie_at_the_end": {v - 2: 50.0, v - 1: 50.0}}
    for name, cols in placed.items():
        row = rng.normal(size=v).astype(np.float32)
        for col, val in cols.items():
            row[col] = val
        rows[name] = row
    return rows


def phase_non_finite(torch) -> None:
    """The port's choosing seams on non-finite and tied inputs, on the
    card. ``serving.engine.greedy`` at Qwen2-7B's vocabulary (152064) in
    f32 and bf16 on ``_greedy_rows``: the card's tokens equal
    ``np.argmax`` of the same rows on the host and the CPU's ``greedy``,
    int32; its device ms at (4, V) f32 beside the max / where / min rule
    it replaced. ``federation.transport._topk_mask`` (top-2 of 4 rank
    columns) on the card against the CPU, bit-equal, on the cases of
    tests/test_torch_transport.py: a NaN column, an inf column, fewer
    than k nonzero columns, a tie at the k-th energy."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.federation.transport import _topk_mask
    from repro_torch.serving.engine import greedy
    v = get_config("qwen2-7b").vocab_size
    named = _greedy_rows(np, v)
    x32 = torch.from_numpy(np.stack(list(named.values())))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        want = np.argmax(x.float().numpy(), axis=-1)
        got = greedy(x.to(DEV))
        require(got.dtype == torch.int32, f"greedy gave {got.dtype}")
        got = got.cpu().numpy()
        cpu = greedy(x).numpy()
        bad = [n for n, g, c, w in zip(named, got, cpu, want)
               if not g == c == w]
        out[str(dtype)] = {"tokens": dict(zip(named, got.tolist())),
                           "differ": bad}
        require(not bad, f"non_finite: greedy in {dtype} differs from "
                         f"np.argmax on the card or the CPU at {bad}")
    xs = torch.from_numpy(np.stack([named["plain"]] * SLOTS)).to(DEV)
    xs[1:, 7 * GREEDY_BLOCK] = NAN

    def replaced_rule():
        top = xs.max(dim=-1, keepdim=True).values
        idx = torch.arange(v, device=DEV)
        return torch.where(xs == top, idx, v).min(dim=-1).values.to(
            torch.int32)
    emit({"phase": "non_finite_greedy", "vocab": v,
          "rows": list(named), "block": GREEDY_BLOCK, **out,
          "greedy_device_ms_4_rows": time_ms(torch, lambda: greedy(xs)),
          "replaced_rule_device_ms_4_rows": time_ms(torch, replaced_rule),
          "card": card_line()})
    masks = {}
    for case in ("nan", "inf", "zero", "tie"):
        b, a = _topk_case(torch, np, case)
        cpu = _topk_mask(b, a, 2)
        card = _topk_mask(b.to(DEV), a.to(DEV), 2).cpu()
        masks[case] = cpu[0].tolist()
        require(torch.equal(card, cpu), f"non_finite: _topk_mask on the "
                f"card {card.tolist()} against the CPU's {cpu.tolist()} "
                f"({case})")
    emit({"phase": "non_finite_topk", "k": 2, "lead0_masks": masks,
          "card_equal_cpu": True})
    _non_finite_rules(torch, np, v)


def _k6_special(torch, args, op: str, tok: int, value: float,
                groups: int):
    """K6_SPECIAL's entry applied to ``args`` (x, dt, a_log, b, c, d) of 4
    heads in place; returns the heads it reaches (a bool mask). x, dt: one
    entry at head 1. b, c: one entry at the last group. cb_overflow: C[tok]
    and B[tok + 20] at column 3 of the last group, whose product overflows.
    dtx_decay: x[tok] dt[tok] overflows at head 1, dt[tok + 1] = 1e3 after
    it. dtx_band: the same inside the band, B[tok] = e0 and C[tok] = 1e-20
    e0 at head 1's group. b_denormal: B inf at column 3 of the last group,
    A = -1 and dt = 3 at head 3 after it, so that rows tok + 30 .. + 34 see
    decays exp(-90 .. -102), f32 denormals."""
    x, dt, a_log, b, c, _ = args
    g = groups - 1
    if op == "x":
        x[0, tok, 1, 5] = value
    elif op == "dt":
        dt[0, tok, 1] = value
    elif op in ("b", "c"):
        (b if op == "b" else c)[0, tok, g, 3] = value
    elif op == "cb_overflow":
        c[0, tok, g, 3] = b[0, tok + 20, g, 3] = value
    elif op in ("dtx_decay", "dtx_band"):
        x[0, tok, 1, 3], dt[0, tok, 1] = 1e30, value
        if op == "dtx_decay":
            dt[0, tok + 1, 1] = 1e3
        else:                                   # head 1 reads group 0
            b[0, tok, 0], c[0, tok, 0] = 0.0, 0.0
            b[0, tok, 0, 0], c[0, tok, 0, 0] = 1.0, 1e-20
    else:                       # b_denormal: head 3 reads the last group
        a_log[3] = 0.0
        dt[0, tok + 1:tok - tok % 64 + 64, 3] = 3.0
        b[0, tok, g, 3] = value
    reach = torch.ones(4, dtype=torch.bool)
    if op in ("x", "dt", "dtx_decay"):
        reach[[0, 2, 3]] = False
    elif groups == 2:                           # the group of heads 0-1
        reach[:2] = op == "dtx_band"            # or of heads 2-3
        reach[2:] = op != "dtx_band"
    return reach


def _same_classes(torch, got, want) -> bool:
    """NaN at the same places, and +-inf at the same places and signs."""
    got, want = got.float().cpu(), want.float().cpu()
    inf = torch.isinf(want)
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf]))


def _nan_bits_equal(torch, got, want) -> bool:
    """Bit-equal, every NaN counted as one pattern."""
    got, want = got.cpu(), want.cpu()
    keep = ~want.isnan()
    return _same_classes(torch, got, want) and torch.equal(got[keep],
                                                           want[keep])


def _non_finite_rules(torch, np, v: int) -> None:
    """The reference's rules for bad ids and special values on the card,
    each against the CPU on the same inputs: the token lookup
    (``take_rows``: NaN rows past [-V, V)) and the loss's gold logit
    (``gold_logits``: 0 for a target outside [0, V), NaN beside an
    infinite column) at Qwen2-7B's vocabulary, bit-equal; K4 at bad page
    ids on its three routes, bit-equal to the call at ``page_index``'s
    ids and within its tolerance of the plain version; the three 3xTF32
    kernels (K5 above 32 rows, K6, K7) on infinite operands, NaN and
    +-inf where the plain version has them and the rest within its
    tolerance; K3 with inf and NaN at zero weights of dead and live
    slabs, NaN where the einsum has NaN, then a clean call finite."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import rank_partition_agg as rpa
    from repro_torch.kernels import ssd_scan as k6
    from repro_torch.models.transformer import gold_logits, take_rows
    gen = torch.Generator().manual_seed(32)
    eps = torch.finfo(torch.float32).eps
    out = {}
    table = torch.randn(v, 64, generator=gen)
    ids = torch.tensor([[0, v, v + 7, -1, -v, -v - 1, 5, v - 1]])
    for dtype in (torch.float32, torch.bfloat16):
        cpu = take_rows(table.to(dtype), ids)
        card = take_rows(table.to(dtype).to(DEV), ids.to(DEV))
        require(_nan_bits_equal(torch, card, cpu) and bool(
            cpu[0, [1, 2, 5]].isnan().all()) and not bool(
            cpu[0, [0, 3, 4, 6, 7]].isnan().any()),
            f"non_finite_rules: take_rows in {dtype} card != CPU")
    out["take_rows"] = {"ids": ids[0].tolist(), "card_equal_cpu": True}
    logits = torch.randn(6, v, generator=gen)
    logits[0, 9], logits[1, 7], logits[2, 11] = -INF, INF, INF
    logits[3, 4], logits[3, 5] = INF, -INF
    targets = torch.tensor([3, 2, 11, 4, v, -1])
    cpu = gold_logits(logits, targets)
    card = gold_logits(logits.to(DEV), targets.to(DEV))
    require(_nan_bits_equal(torch, card, cpu),
            f"non_finite_rules: gold_logits card {card.tolist()} != CPU "
            f"{cpu.tolist()}")
    require(cpu[[0, 1, 3]].isnan().all()
            and float(cpu[2]) == INF and cpu[4:].tolist() == [0.0, 0.0],
            f"non_finite_rules: gold_logits {cpu.tolist()}")
    out["gold_logits"] = {"targets": targets.tolist(),
                          "gold": [str(x) for x in cpu.tolist()]}
    k4 = {}
    for label, m, k, dtype in (("gemv", 6, 64, torch.float32),
                               ("sgemm", 40, 1024, torch.float32),
                               ("mma_bf16", 40, 1024, torch.bfloat16)):
        p, r, n = 3, 8, 40
        x = torch.randn(m, k, generator=gen)
        case = dict(x=x, w=torch.randn(k, n, generator=gen) * k ** -0.5,
                    a_pages=torch.randn(p, r, k, generator=gen) * k ** -0.5,
                    b_pages=torch.randn(p, n, r, generator=gen),
                    scales=torch.rand(p, generator=gen) + 0.5)
        case = {key: (t.to(dtype) if key != "scales" else t)
                for key, t in case.items()}
        bad = torch.randint(0, p, (m,), generator=gen, dtype=torch.int32)
        bad[:5] = torch.tensor([p, p + 3, -1, -p, -p - 1])
        dev = {key: t.to(DEV) for key, t in case.items()}
        got = la.batched_lora_apply(ids=bad.to(DEV), **dev)
        at = la.batched_lora_apply(ids=la.page_index(bad, p).int().to(DEV),
                                   **dev)
        want = la.batched_lora_apply_plain(ids=bad, **case).float()
        mag = la.batched_lora_apply_plain(
            ids=bad, **{key: t.float().abs() for key, t in case.items()})
        err = float((got.float().cpu() - want).abs().max())
        tol = ((k + r) * eps * float(mag.max()) if dtype == torch.float32
               else float(want.abs().max()) * 2.0 ** -7)
        require(torch.equal(got, at) and err <= tol,
                f"non_finite_rules: K4 {label} at bad page ids: "
                f"equal to clamped {torch.equal(got, at)}, err {err} > {tol}")
        k4[label] = {"route": la.describe_plan(m, n, k, False,
                                               dtype)["route"],
                     "max_abs_err": err, "tol": tol}
    out["k4_page_ids"] = k4
    tc = {}
    x = torch.randn(64, 300, generator=gen)
    w = torch.randn(300, 40, generator=gen) * 300 ** -0.5
    x[5, 7], w[7, 3], x[9, 20] = INF, 0.0, -INF
    a, b = x.new_zeros(0, 300), x.new_zeros(40, 0)
    got = la.lora_apply(x.to(DEV), w.to(DEV), a.to(DEV), b.to(DEV), 1.0)
    want = la.lora_apply_plain(x, w, a, b, 1.0)
    tc["lora_apply"] = _special_check(torch, got, want, 300 * eps * float(
        la.lora_apply_plain(x.abs().nan_to_num(0, 0, 0), w.abs(), a, b,
                            1.0).max()))
    q, kk, vv = (torch.randn(1, 40, h, 16, generator=gen) for h in (2, 1, 1))
    kk[0, 10, 0, 3] = INF
    got = fa.flash_attention(q.to(DEV), kk.to(DEV), vv.to(DEV), True, 0)
    want = fa.flash_attention_plain(q, kk, vv, True, 0)
    tc["flash_attention"] = _special_check(torch, got, want, 2e-5, 1e-4)
    require(bool(want[0, 10:][q[0, 10:, :, 3] < 0].isfinite().all()),
            "non_finite_rules: K7's -inf scores did not drop the key")
    for label, (lkv, causal, window, kv) in K7_PAST_BAND.items():
        for name, value in (("inf", INF), ("nan", NAN)):
            q, kk, vv = (torch.randn(1, n, h, 16, generator=gen)
                         for n, h in ((40, 4), (lkv, 2), (lkv, 2)))
            clean_o = fa.flash_attention(q.to(DEV), kk.to(DEV), vv.to(DEV),
                                         causal, window)
            vv[0, kv, 1, 5] = value
            got = fa.flash_attention(q.to(DEV), kk.to(DEV), vv.to(DEV),
                                     causal, window)
            want = fa.flash_attention_plain(q, kk, vv, causal, window)
            tc[f"flash_attention_v_{name}_{label}"] = _special_check(
                torch, got, want, 2e-5, 1e-4, f"K7 v {name} {label}")
            # query heads 0-1 read kv head 0, which the value cannot reach
            require(torch.equal(got[:, :, :2], clean_o[:, :, :2]),
                    f"non_finite_rules: K7 {label}: kv head 0 moved")
    for label, (groups, op, tok, value) in K6_SPECIAL.items():
        shape = (1, 256, 4, 16, groups, 8, 64)
        clean, _ = _scan_inputs(torch, shape, torch.Generator(
            device=DEV).manual_seed(33), False)
        clean_y = k6.ssd_scan(*clean, shape[-1])[0].cpu()
        args = [t.cpu().clone() for t in clean]
        reach = _k6_special(torch, args, op, tok, value, groups)
        got, state = k6.ssd_scan(*[t.to(DEV) for t in args], shape[-1])
        want, want_state = k6.ssd_scan_plain(*args, shape[-1])
        tc[label] = _special_check(torch, got, want, SCAN_TOL["atol"],
                                   SCAN_TOL["rtol"], label)
        tc[f"{label}_state"] = _special_check(
            torch, state, want_state, SCAN_TOL["atol"], SCAN_TOL["rtol"],
            f"{label}_state")
        # what the value cannot reach: the chunks before its own, and the
        # heads that read neither it nor its group
        c0 = tok - tok % shape[-1] if op != "b_denormal" else 0
        got_c = got.cpu()
        require(torch.equal(got_c[:, :c0], clean_y[:, :c0])
                and torch.equal(got_c[:, :, ~reach], clean_y[:, :, ~reach]),
                f"non_finite_rules: K6 {label} moved outputs it cannot "
                "reach")
    out["tf32x3_infinite"] = tc
    bs = torch.randn(2, 4, 40, 8, generator=gen)
    as_ = torch.randn(2, 4, 8, 24, generator=gen)
    omega = torch.rand(4, 8, generator=gen)
    omega[1], omega[2:4] = -omega[1], 0.0
    omega[0, 2] = omega[1, 6] = 0.0
    clean = bs.clone(), as_.clone()
    bs[0, 2, 5, 3], as_[1, 3, 1, 7] = INF, NAN
    bs[1, 1, 9, 6], as_[0, 0, 2, 11] = -INF, INF
    dev = [t.to(DEV) for t in (bs, as_, omega)]
    got = rpa.rank_partition_agg_layered(*dev)
    want = rpa.rank_partition_agg_layered_plain(bs, as_, omega)
    mag = rpa.rank_partition_agg_layered_plain(clean[0].abs(),
                                               clean[1].abs(), omega.abs())
    k3 = _special_check(torch, got, want, 34 * eps * float(mag.max()))
    again = rpa.rank_partition_agg_layered(*[t.to(DEV) for t in clean],
                                           dev[2])
    require(bool(again.isfinite().all()),
            "non_finite_rules: K3 left a flag set")
    k3["nan_rows_cols"] = [int(want.isnan().all(-1).sum()),
                           int(want.isnan().all(-2).sum())]
    out["rank_partition_agg"] = k3
    emit({"phase": "non_finite_rules", **out, "card_equal_cpu": True,
          "card": card_line()})
    _k7_past_band_full(torch)


def _k7_past_band_full(torch) -> None:
    """K7 at Qwen2-7B's causal prefill (row 10a of PERF.md: B 4, L 1024, H
    28, KVH 4, D 128) with one inf value entry at key 1000 of batch row 1,
    kv head 2: the rows before it do not see the key and are NaN in its
    column, as in the plain version (the pass over V, then the IEEE rows);
    the query heads of the other kv heads and the other batch rows are
    bit-equal to the clean call's. Prints both calls' device times."""
    from repro_torch.kernels import flash_attention as fa
    _, b, length, h, kvh, d, causal, window = ATTN_SHAPES[0]
    gen = torch.Generator(device=DEV).manual_seed(34)
    q, k, v = (torch.randn(b, length, n, d, generator=gen, device=DEV)
               for n in (h, kvh, kvh))
    clean = fa.flash_attention(q, k, v, causal, window)
    clean_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, causal,
                                                         window), 5, 1)
    v[1, 1000, 2, 7] = INF
    got = fa.flash_attention(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    check = _special_check(torch, got, want, 2e-5, 1e-4)
    group = h // kvh
    heads = torch.zeros(h, dtype=torch.bool, device=DEV)
    heads[2 * group:3 * group] = True
    require(torch.equal(got[:, :, ~heads], clean[:, :, ~heads])
            and torch.equal(got[[0, 2, 3]], clean[[0, 2, 3]]),
            "non_finite_rules: K7 at full width moved outputs the value "
            "cannot reach")
    require(check["nan"] == 1000 * group,
            f"non_finite_rules: K7 at full width: {check['nan']} NaN, not "
            f"{1000 * group}")
    emit({"phase": "non_finite_k7_full", "shape": ATTN_SHAPES[0][1:],
          "v_inf_at": [1, 1000, 2, 7], **check,
          "kernel_ms": time_ms(torch, lambda: fa.flash_attention(
              q, k, v, causal, window), 5, 1),
          "clean_kernel_ms": clean_ms, "card": card_line()})


def _special_check(torch, got, want, atol: float, rtol: float = 0.0,
                   label: str = "") -> dict:
    """``got`` (card) against ``want`` (CPU): the same NaN and +-inf
    places, the finite rest within atol + rtol |want|; ``label`` names
    the case in a failure."""
    got, want = got.float().cpu(), want.float().cpu()
    fin = torch.isfinite(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0
    ok = _same_classes(torch, got, want) and bool(
        ((got[fin] - want[fin]).abs() <= atol + rtol * want[fin].abs()).all())
    require(ok, f"non_finite_rules: {label} special values differ: NaN "
                f"{int(got.isnan().sum())} / {int(want.isnan().sum())}, "
                f"inf {int(got.isinf().sum())} / {int(want.isinf().sum())}, "
                f"finite err {err}")
    return {"nan": int(want.isnan().sum()), "inf": int(want.isinf().sum()),
            "finite_where_plain_nan": int((want.isnan()
                                           & got.isfinite()).sum()),
            "max_abs_err": err, "atol": atol, "rtol": rtol}


def _topk_case(torch, np, case: str):
    """tests/test_torch_transport.py's ``_special_inputs``: (B, A) torch
    tensors (2, 6, 4) and (2, 4, 5) from seed 11, lead 0 special."""
    rng = np.random.default_rng(11)
    b = rng.normal(size=(2, 6, 4)).astype(np.float32)
    a = rng.normal(size=(2, 4, 5)).astype(np.float32)
    if case == "nan":
        b[0, 2, 1] = np.nan
    elif case == "inf":
        b[0, 4, 2] = np.inf
    elif case == "zero":
        b[0, :, 1:] = 0.0
        a[0, 1:] = 0.0
    elif case == "tie":
        b[0, :, 2], a[0, 2] = b[0, :, 0], a[0, 0]
        b[0, :, 3] *= 4.0
    return torch.from_numpy(b), torch.from_numpy(a)


def _k12_check(torch, kname, label, kern, plain, args) -> tuple:
    """One K1/K2 call against its plain version on the same inputs:
    (kernel output, max_abs_err, tol). K1 does one IEEE sqrt and one
    multiply per element, so it is held bit-exact; K2 to the worst-case
    rounding of a length-``depth`` f32 dot product (Higham's
    gamma_depth) times the largest column norm^2, its output exactly
    symmetric."""
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if kname.startswith("weighted_stack"):
        tol = 0.0
    else:
        x = args[0]                   # u (L, d, R) or v (L, R, n)
        left = kname == "gram_left"
        depth = x.shape[-2] if left else x.shape[-1]
        norms = (x * x).sum(dim=-2 if left else -1)
        tol = depth * torch.finfo(torch.float32).eps * float(norms.max())
        require(bool(torch.equal(got, got.mT)),
                f"{kname} {label}: output not exactly symmetric")
    require(err <= tol, f"{kname} {label}: max_abs_err {err} > {tol}")
    return got, err, tol


def phase_kernels(torch, summary: dict):
    """Each kernel vs its plain version at the round's bucket shapes."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import rank_partition_agg as rpa
    gen = torch.Generator(device=DEV).manual_seed(0)
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
            got, err, tol = _k12_check(torch, kname, name, kern, plain, args)
            if kname.startswith("weighted_stack"):
                nbytes = 2 * args[0].numel() * 4 + omega.numel() * 4
                flops = args[0].numel()
            else:
                # the input read once and the full (both-triangle) output
                # written once; G is symmetric, so the work is the
                # R(R+1)/2 distinct dot products of 2*depth FLOP each
                depth = d if kname == "gram_left" else n
                nbytes = args[0].numel() * 4 + layers * rr * rr * 4
                flops = float(layers * depth * rr * (rr + 1))
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
    """cuBLAS x @ W plus the gathered bmm adapter term, in the inputs'
    dtype (f32, or bf16 with f32 sums)."""
    i = ids.long()
    z = torch.bmm(x[:, None, :], a[i].mT)
    return x @ w + s[i][:, None].to(x.dtype) * torch.bmm(z, b[i].mT)[:, 0]


def phase_kernel_lora_apply(torch, summary: dict):
    """K4 vs its plain version at the q/k/v/o shapes of each served model
    (``K4_MODELS``: Qwen2-7B, Gemma-2B, Hymba-1.5B): decode (one row per
    slot) and prefill (the prompt's tokens per slot), 4 pages at r = 16,
    every slot on its own page. The summary row is Qwen2-7B's decode
    layer; every model's layer totals ride along."""
    from repro_torch.kernels import lora_apply as la
    gen = torch.Generator(device=DEV).manual_seed(1)
    rows, by_model = [], {}
    for model, projs, prefill_rows in K4_MODELS:
        by_model[model] = _k4_layers(torch, la, gen, model, projs,
                                     prefill_rows, rows)
    bf16_rows, bf16_by_model = [], {}
    for model, projs, prefill_rows in K4_BF16_MODELS:
        bf16_by_model[model] = _k4_layers(torch, la, gen, model, projs,
                                          prefill_rows, bf16_rows,
                                          torch.bfloat16)
    emit({"phase": "kernels", "kernel": "batched_lora_apply",
          "per_shape": rows, "per_layer": by_model})
    emit({"phase": "kernels", "kernel": "batched_lora_apply_bf16",
          "per_shape": bf16_rows, "per_layer": bf16_by_model,
          "card": card_line()})
    dec = bf16_by_model["llama4-maverick"]["decode"]
    summary["batched_lora_apply_bf16"] = {
        "max_abs_err": max(t["max_abs_err"] for layer in
                           bf16_by_model.values() for t in layer.values()),
        "max_err_row_ulps": max(t["max_err_row_ulps"] for layer in
                                bf16_by_model.values()
                                for t in layer.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": "bytes" if dec["bytes_ms"] >= dec["ops_ms"]
        else "operations",
        "bound_route": dec["bound_route"],
        "bound_simt_f32_ms": dec["bound_simt_f32_ms"],
        "library_ms": dec["library_ms"],
        "shape": "one llama4-maverick decode layer in bf16: q, k, v, o at "
                 "4 rows",
        "decode_layer_device": {key: dec[key] for key in
                                DEVICE_KEYS + ("rank0_device_ms",)},
        "other_layers": {
            model: {phase: {key: t[key] for key in
                            ("ms", "plain_ms", "bound_ms", "bound_route",
                             "bound_simt_f32_ms", "library_ms",
                             "max_abs_err", "max_err_row_ulps",
                             *DEVICE_KEYS, "rank0_device_ms")}
                    for phase, t in layer.items()}
            for model, layer in bf16_by_model.items()}}
    totals = by_model["qwen2-7b"]
    dec = totals["decode"]
    # the summary row is one decode step's four launches of one layer
    summary["batched_lora_apply"] = {
        "max_abs_err": max(t["max_abs_err"] for layer in by_model.values()
                           for t in layer.values()),
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": "bytes" if dec["bytes_ms"] >= dec["ops_ms"]
        else "operations",
        "library_ms": dec["library_ms"],
        "shape": "one qwen2-7b decode layer: q, k, v, o at 4 rows",
        "decode_layer_device": {key: dec[key] for key in
                                DEVICE_KEYS + ("rank0_device_ms",)},
        "prefill_layer": {key: totals["prefill"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms",
                           *DEVICE_KEYS, "rank0_device_ms")},
        "other_models_layer": {
            model: {phase: {key: t[key] for key in
                            ("ms", "plain_ms", "bound_ms", "library_ms",
                             "max_abs_err", *DEVICE_KEYS)}
                    for phase, t in layer.items()}
            for model, layer in by_model.items() if model != "qwen2-7b"}}


def _bf16_ulp(torch, v):
    """The bf16 spacing at |v| (elementwise), from 2^-133 up."""
    a = v.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _k4_layers(torch, la, gen, model, projs, prefill_rows, rows,
               dtype=None, weights=None, graph_iters=20) -> dict:
    """One model's q/k/v/o through K4 and its plain version at decode and
    prefill: each shape held to the plain version and timed (eager and
    graph-replayed, with the library yardstick); returns the layer totals
    per phase and appends each shape's row to ``rows``. In f32 the
    tolerance is the worst-case rounding of the dot products. In bf16
    (x, W and the pages bf16, the bf16 instances) every element within
    one bf16 ulp of the largest |value| of its row of the plain version:
    both compute in f32 and round once, so they differ by at most one
    rounding step wherever the two f32 sums lie far closer together
    than a bf16 ulp, which an element's own ulp is not near 0 (a sum in
    another order differs there by more than that tiny ulp). Each row
    names its route and plan (``la.describe_plan``) and takes its bound
    at the peak of what the route runs on: the GEMV and the SGEMM on the
    CUDA cores' IEEE f32 FMAs, the bf16 route above 32 rows on the bf16
    tensor cores (``bound_simt_f32_ms`` beside it, the same work at the
    SIMT peak). Every row also times the same calls with rank-0 pages
    (``rank0_device_ms``: no shrink launch and no expand, the base
    product alone). ``weights`` ({proj: [W, ...]}, a served model's own
    layers) replaces the drawn W, one argument set a layer; W's of
    gigabytes take ``graph_iters`` calls a graph, so that a graph of the
    plain version's f32 copies of W fits beside the model."""
    dtype = dtype or torch.float32
    size = torch.finfo(dtype).bits // 8
    eps = torch.finfo(torch.float32).eps
    totals = {}
    for phase, m in (("decode", SLOTS), ("prefill", prefill_rows)):
        tot = totals.setdefault(phase, {"ms": 0.0, "plain_ms": 0.0,
                                        "library_ms": 0.0, "bound_ms": 0.0,
                                        "bytes_ms": 0.0, "ops_ms": 0.0,
                                        "bound_simt_f32_ms": 0.0})
        for proj, k, n in projs:
            r, p = SERVE_RANK, SLOTS
            if weights is None:
                copies = max(2, math.ceil(100e6 / (k * n * size)))
                layer_ws = [None] * copies
            else:
                layer_ws = weights[proj]
            sets = []
            for w in layer_ws:
                x = torch.randn(m, k, generator=gen, device=DEV).to(dtype)
                if w is None:
                    w = (torch.randn(k, n, generator=gen, device=DEV)
                         * k ** -.5).to(dtype)
                a = (torch.randn(p, r, k, generator=gen, device=DEV)
                     * k ** -.5).to(dtype)
                b = (torch.randn(p, n, r, generator=gen, device=DEV)
                     * 0.1).to(dtype)
                s = torch.ones(p, device=DEV)
                ids = (torch.arange(m, device=DEV) * p // m).to(
                    torch.int32)
                sets.append((x, w, a, b, s, ids))
            args = sets[0]
            plan = la.describe_plan(m, n, k, dtype=dtype)
            route = "mma_bf16" if plan["route"] == "mma_bf16" \
                else "simt_f32"
            bf16_before = la.batched_lora_apply.launches_bf16
            got = la.batched_lora_apply(*args)
            want = la.batched_lora_apply_plain(*args)
            torch.cuda.synchronize()
            require(got.dtype == dtype, f"batched_lora_apply {model}: y is "
                                        f"{got.dtype}, expected {dtype}")
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            extra = {}
            if dtype == torch.bfloat16:
                require(la.batched_lora_apply.launches_bf16
                        == bf16_before + 1, f"batched_lora_apply {model} "
                        f"{phase} {proj}: not a bf16 instance's launch")
                row_ulp = _bf16_ulp(torch, want.float().abs().amax(
                    dim=-1, keepdim=True))
                tol = float(row_ulp.min())
                extra = {"max_err_row_ulps": float((diff / row_ulp).max()),
                         "max_err_own_ulps": float(
                             (diff / _bf16_ulp(torch, want)).max()),
                         "elements_over_own_ulp": int(
                             (diff > _bf16_ulp(torch, want)).sum())}
                require(extra["max_err_row_ulps"] <= 1.0,
                        f"batched_lora_apply {model} {phase} {proj}: "
                        f"{extra['max_err_row_ulps']} bf16 ulps of its "
                        "row's largest value")
            else:
                # worst-case rounding of the (K + r)-deep f32 dot products:
                # (K + r) eps max(|x| @ |W| + |s| (|x| @ |A|^T) @ |B|^T)
                mag = la.batched_lora_apply_plain(
                    *(t.abs() for t in args[:5]), args[5])
                tol = (k + r) * eps * float(mag.max())
                require(err <= tol, f"batched_lora_apply {model} {phase} "
                                    f"{proj}: max_abs_err {err} > {tol}")
                del mag
            require(torch.equal(got, la.batched_lora_apply(*args)),
                    f"batched_lora_apply {model} {phase} {proj}: not "
                    "deterministic")

            def lib(*t):
                return _lora_library(torch, *t)

            k_ms = time_rotating_ms(torch, la.batched_lora_apply, sets)
            p_ms = time_rotating_ms(torch, la.batched_lora_apply_plain, sets)
            l_ms = time_rotating_ms(torch, lib, sets)
            # the same calls replayed from a CUDA graph: device time only
            dev = {"kernel_device_ms": time_graph_ms(
                       torch, la.batched_lora_apply, sets, graph_iters),
                   "plain_device_ms": time_graph_ms(
                       torch, la.batched_lora_apply_plain, sets,
                       graph_iters),
                   "library_device_ms": time_graph_ms(torch, lib, sets,
                                                      graph_iters)}
            rank0 = [(x, w, a[:, :0], b[:, :, :0], s, ids)
                     for x, w, a, b, s, ids in sets]
            dev["rank0_device_ms"] = time_graph_ms(
                torch, la.batched_lora_apply, rank0, graph_iters)
            del rank0
            # x, W, the pages and y in the operands' dtype; scales and
            # ids 4 bytes each
            nbytes = size * (k * n + p * r * (k + n) + m * (k + n)) \
                + 4 * (p + m)
            flops = 2.0 * m * k * n + 2.0 * m * r * (k + n)
            b_ms, b_by = bound_ms(nbytes, flops, route)
            simt_ms = bound_ms(nbytes, flops)[0]
            rows.append({"kernel": "batched_lora_apply", "model": model,
                         "dtype": str(dtype), "phase": phase, **extra,
                         "proj": proj, "m": m, "k": k, "n": n, "pages": p,
                         "rank": r, "plan": plan,
                         "max_abs_err": err, "tol": tol,
                         "kernel_ms": k_ms, "plain_ms": p_ms,
                         "library_ms": l_ms, **dev,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_route": route,
                         "bound_simt_f32_ms": simt_ms,
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
            tot["bound_simt_f32_ms"] += simt_ms
            tot["bytes_ms"] += nbytes / PEAK_BYTES_PER_S * 1e3
            tot["ops_ms"] += flops / PEAK_FLOPS[route] * 1e3
            tot["bound_route"] = route
            tot["max_abs_err"] = max(tot.get("max_abs_err", 0.0), err)
            if extra:
                tot["max_err_row_ulps"] = max(
                    tot.get("max_err_row_ulps", 0.0),
                    extra["max_err_row_ulps"])
            del sets, args, got, want, diff
        torch.cuda.empty_cache()
    return totals


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
    """K6 vs its plain version at mamba2-1.3b's prefill shape, at
    hymba-1.5b's (P 50, N 16, chunk 128) and at an odd shape, each without
    and with an initial state; two launches must be bit-equal. Every row
    prints the plan (CUDA launches a call, blocks a launch, route). At the
    two models' shapes: eager and device times, TFLOP/s of the counted
    work (``_scan_work``) and of the work done (the plan's), and the check
    that tells 3xTF32 from one TF32 pass."""
    from repro_torch.kernels import ssd_scan as k6
    gen = torch.Generator(device=DEV).manual_seed(2)
    rows = []
    for name, shape in (("full", SCAN_FULL), ("hymba", SCAN_HYMBA),
                        ("odd", SCAN_ODD)):
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
            if name != "odd":
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
    hymba = next(r for r in rows if r["shape"] == "hymba"
                 and not r["init_state"])
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
                                      "one_pass_tf32_err_over_bound")},
        "hymba_prefill_layer": {
            "shape": "B 4, L 2048, H 64, P 50, G 1, N 16, chunk 128",
            **{key: hymba[key] for key in (
                "max_abs_err", "kernel_ms", "plain_ms", "kernel_device_ms",
                "plain_device_ms", "bound_ms", "bound_by",
                "bound_simt_f32_ms", "plan", "f64_max_abs_err",
                "f64_err_over_bound", "one_pass_tf32_err_over_bound")}}}


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
        dead = int((~live.repeat_interleave(16)[:depth]).sum())
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
            "live_slabs": [int(live.sum()), live.numel()],
            # the flag pass: B's and A's entries at the dead slabs' depths
            # read once each (no products), and their time at 3.35 TB/s
            "dead_check_bytes": 4 * (layers or 1) * (d + n) * dead,
            "dead_check_bound_ms": 4 * (layers or 1) * (d + n) * dead
            / PEAK_BYTES_PER_S * 1e3})

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
        for key in ("flop_dense", "plan", "live_slabs", "dead_check_bytes",
                    "dead_check_bound_ms"):
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


def _stage_timer(torch, times: dict, accumulate: bool = False):
    """timed(stage, fn, keep=None): ``fn`` wrapped to record its device
    time (CUDA events) under ``times[stage]``, summed over calls when
    ``accumulate``, and its last arguments and output under ``keep`` when
    given."""
    def timed(stage, fn, keep=None):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            times[stage] = times.get(stage, 0.0) + ms if accumulate else ms
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
    # every round builds its model without remat, as the reference's
    # federation/experiment.py does
    model = Model(cfg, lora, device="cuda", remat=False)
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


AUDIT_COHORT = 5          # clients, all of them in every audited round
AUDIT_ROUNDS = 3          # the first is the warmup
AUDIT_LADDER = (768, 1536, 3072)   # d = n: vit-base's width, x2, x4
AUDIT_BUCKET = 4          # adapters of vit-base's q/k/v/o bucket


def phase_audit(torch) -> dict:
    """The audit layer on the card: the CUDA lint, the dispatch audit of
    vit-base rounds and the peak-memory scaling of one bucket's
    aggregate (module docstring, phase 4-audit). Fails on any finding."""
    import dataclasses
    from repro_torch.analysis import (complexity, cuda_lint,
                                      dispatch_audit, liveness, op_lint)
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.kernels import build
    from repro_torch.models.transformer import Model

    t0 = time.perf_counter()
    card = card_line()
    logs = cuda_lint.ptxas_reports()
    progs = cuda_lint.CudaPrograms(cuda_lint.collect_build(logs),
                                   cuda_lint.probe_registry("cuda"))
    torch.cuda.synchronize()
    findings = cuda_lint.lint_cuda(progs, "cuda/registry",
                                   {"libraries": sorted(build.SIGNATURES)})
    emit({"phase": "audit_cuda_lint", "libraries": sorted(logs),
          "entries": len(progs.entries),
          "spilling": {e.name: [e.spill_stores, e.spill_loads]
                       for e in progs.entries
                       if e.spill_stores or e.spill_loads},
          "max_registers": max(e.registers for e in progs.entries),
          "max_static_smem": max(e.smem for e in progs.entries),
          "probes_ok": sum(p.ok for p in progs.probes),
          "probes": len(progs.probes),
          "errors": [str(f) for f in findings], "card": card})
    require(not findings, f"audit: cuda_lint {[str(f) for f in findings]}")

    cfg, fl, lora, shards, x_tr, y_tr, patches = _vit_base_setup()
    fl = dataclasses.replace(fl, num_clients=AUDIT_COHORT,
                             participation=1.0)
    registry = ClientRegistry.create(fl, lora, shards[:AUDIT_COHORT])
    model = Model(cfg, lora, device="cuda", remat=False)
    server = FederatedLoRA(model, fl, lora, registry,
                           make_batch_fn(registry, x_tr, y_tr, fl, 2,
                                         patches), backend="kernel")
    mon = dispatch_audit.DispatchMonitor()
    with mon:
        for r in range(AUDIT_ROUNDS):
            server.run_round()
            torch.cuda.synchronize()
            mon.mark(f"round{r}")
    findings = dispatch_audit.lint_dispatch(mon, "dispatch/vit_base",
                                            {"warmup": 1})
    emit({"phase": "audit_dispatch", "rounds": AUDIT_ROUNDS, "warmup": 1,
          "cohort": AUDIT_COHORT, "ranks": server.history[-1].ranks,
          "per_round": [p.to_json() for p in mon.phases],
          "host_syncs_per_round": [p.sync_count for p in mon.phases],
          "errors": [str(f) for f in findings], "card": card})
    require(not findings,
            f"audit: dispatch {[str(f) for f in findings]}")
    del server, model
    gc.collect()
    torch.cuda.empty_cache()

    slopes, rows = {}, {}
    for backend in ("kernel", "dense"):
        meas = []
        for i, s in enumerate(AUDIT_LADDER):
            pt = op_lint.ProgramPoint(
                "batched", "raflora", backend, d=s, n=s,
                rank_levels=lora.rank_levels, m_per_group=1,
                p_bucket=AUDIT_BUCKET)
            fn = op_lint.program_fn(pt, device="cuda")
            with torch.no_grad():
                if i == 0:        # one-time handles and scratch, not counted
                    fn()
                live = liveness.measure(fn, "cuda")
            meas.append(complexity.Measurement(
                "dn", float(s), {"peak_live_bytes": live.peak_live_bytes}))
            gc.collect()
            torch.cuda.empty_cache()
        row = complexity.ScalingRow(f"batched/raflora/{backend}", "batched",
                                    "raflora", backend, meas)
        slopes[backend] = row.slopes()[("dn", "peak_live_bytes")]
        rows[backend] = {int(m.x): m.costs["peak_live_bytes"] for m in meas}
        findings = complexity.evaluate_row(row)
        require(not findings, f"audit: {backend} peak-memory contracts "
                              f"{[str(f) for f in findings]}")
    require(slopes["kernel"] <= 1.35 and slopes["dense"] >= 1.6,
            f"audit: peak-memory slopes {slopes}")
    out = {"phase": "audit", "peak_live_bytes": rows,
           "peak_live_slope": slopes, "ladder": list(AUDIT_LADDER),
           "bucket": {"adapters": AUDIT_BUCKET,
                      "rank_levels": list(lora.rank_levels)},
           "host_syncs_per_round": [p.sync_count for p in mon.phases],
           "seconds": time.perf_counter() - t0, "card": card}
    emit(out)
    return out


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
            Model(cfg, lora, device=DEV, remat=False), fl, lora, registry,
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


def _run_child(flag: str, label: str, env=None):
    """This script again with ``flag`` in a child process (a phase's
    child, see ``main``): its output is passed through, and a nonzero
    exit fails the phase. Returns the child's stdout."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    sys.stderr.write(proc.stderr)
    err = proc.stderr.strip().splitlines()
    require(proc.returncode == 0, f"{label}: child exited {proc.returncode}"
                                  f": {err[-1] if err else ''}")
    return proc.stdout


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
    _run_child("--round-methods", "round_methods",
               env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0"))


# main path 4: the buffered server at ViT-base width (async and event
# engines, int8 transport with error feedback, server momentum)
BUFFERED_ROUNDS = 4
RESUME_AT = 3            # rounds run before the checkpoint: mid-buffer
# tests/test_transport.py:262-270 (TestTransportCheckpoint)
RESUME_TOL = {"loss_rtol": 1e-6, "rtol": 1e-5, "atol": 1e-6}
CKPT_DIR = os.path.join(ROOT, "build", "smoke_ckpt")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi unavailable: {smi.stderr.strip()}")


def _k12_launches():
    from repro_torch.kernels import rank_partition_agg as rpa
    return {k.__name__: k.launches for k in rpa.KERNELS}


def _buffered_server(torch, events: bool):
    """Phase 4's ViT-base setup on the async engine with the int8
    transport (error feedback), server momentum beta 0.9 and staleness
    gamma 0.8: the cadence at depth 2, or (``events``) the straggler event
    scheduler of ``TestStragglerRankCollapse`` (the clients above the
    minimum rank straggle, timeout 2.0, round interval 1.0)."""
    import numpy as np
    from repro_torch.core.server_opt import FactoredServerMomentum
    from repro_torch.federation import events as ev
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.federation.transport import TransportConfig
    from repro_torch.models.transformer import Model
    cfg, fl, lora, shards, x_tr, y_tr, patches = _vit_base_setup()
    registry = ClientRegistry.create(fl, lora, shards)
    server = FederatedLoRA(
        Model(cfg, lora, device=DEV, remat=False), fl, lora, registry,
        make_batch_fn(registry, x_tr, y_tr, fl, 2, patches),
        backend="kernel", round_engine="async",
        pipeline_depth=1 if events else 2, staleness_gamma=0.8,
        server_momentum=FactoredServerMomentum(beta=0.9),
        transport=TransportConfig(mode="int8", error_feedback=True))
    if events:
        high = np.flatnonzero(registry.ranks > min(lora.rank_levels))
        server.set_event_scheduler(ev.EventScheduler(
            ev.StragglerTailLatency(median=0.8, sigma=0.15, tail_scale=2.5,
                                    straggler_clients=high, seed=5),
            ev.TimeoutTrigger(2.0), round_interval=1.0))
    return server


def _instrument(torch, server, times: dict, kept: list) -> None:
    """Time the train stage, each aggregation and the momentum inside it
    (summed per round in ``times``); keep each aggregation's arguments
    and the global tree it started from in ``kept`` as (args, kwargs,
    global_lora)."""
    timed = _stage_timer(torch, times, accumulate=True)
    server._train_grouped = timed("train_ms", server._train_grouped)
    aggregate = timed("aggregate_ms", server._aggregate_grouped)

    def keep(*a, **k):
        kept.append((a, k, server.global_lora))
        return aggregate(*a, **k)
    server._aggregate_grouped = keep
    mom = server.server_momentum
    mom.apply_bucket = timed("momentum_ms", mom.apply_bucket)


K12 = ("weighted_stack_b", "weighted_stack_a", "gram_left", "gram_right")


def _k12_at_path(torch, server, kept, summary: dict, label: str) -> list:
    """K1/K2 against their plain versions at the shapes main path 4 gave
    them, which phase_kernels' six clients (R 192) do not reach: an
    aggregation stacks every client of the buffer (plus the Eq. 8 client
    when a partition is empty), an event fire the clients of each plan
    with an arrival, so R = M * 32 varies and may end inside one of K2's
    64-wide tiles. Every aggregation of the path is replayed, unwrapped
    and without the momentum (it acts after K2), on its uploads and the
    global tree it started from; each K1/K2 call's inputs are captured
    at its wrapper and run through the kernel and its plain version at
    phase_kernels' tolerances. Called after the path's launches are
    read, so these launches count nowhere."""
    rows = []
    for agg, (args, kwargs, global_lora) in enumerate(kept):
        live = server.global_lora, server.server_momentum
        server.global_lora, server.server_momentum = global_lora, None
        try:
            with _CaptureK12() as capture:
                type(server)._aggregate_grouped(server, *args, **kwargs)
        finally:
            server.global_lora, server.server_momentum = live
        require(len(capture.calls) == 4 * len(BUCKETS),
                f"{label} aggregation {agg}: the replay made "
                f"{len(capture.calls)} K1/K2 calls")
        rows += [{"aggregation": agg, **row} for row in _check_k12_calls(
            torch, capture.calls, summary, f"{label} {agg}")]
    return rows


def _dequant_ms(torch, group_factors) -> float:
    """Device time of the one dequantization of an aggregation's uploads
    (every QuantFactor of its groups), CUDA events over 20 calls."""
    from repro_torch.kernels.ops import dequantize
    facs = [x for _, _, fg in group_factors for pair in fg.values()
            for x in pair]
    return time_ms(torch, lambda: [dequantize(x) for x in facs])


def _leaf_errors(torch, a: dict, b: dict) -> tuple:
    from repro_torch.core.lora import flatten
    fa, fb = flatten(a), flatten(b)
    err = max(_max_err(fa[p], fb[p]) for p in fa)
    ok = all(bool(torch.allclose(fb[p], x, rtol=RESUME_TOL["rtol"],
                                 atol=RESUME_TOL["atol"]))
             for p, x in fa.items())
    return err, ok


def _profile_one_aggregation(torch, server) -> dict:
    """One buffered aggregation under torch.profiler: two rounds planned
    and trained into the buffer, then the buffer's aggregation and its
    write-back profiled alone (device time, K2's share, idle share)."""
    for _ in range(2):
        plan = server._plan_round()
        server._train_stage(plan)
        server._pending.append(plan)
    as_of = server._pending[-1].round

    def aggregate():
        results, _, _ = server._aggregate_buffer(as_of)
        server._write_factors(results)
    return _profile(torch, aggregate, "gram")


def phase_round_async_vit_base(torch, summary: dict) -> dict:
    """Main path 4a: four rounds of the async engine (depth 2) at ViT-base
    width with int8 transport and momentum, then ``drain_pending``; K1/K2
    launch 3 times an aggregation and never on a buffer-fill round, the
    energy trace gets one entry an aggregation, and a fresh server
    restored from the checkpoint saved after round 3 (mid-buffer, with
    residuals and momentum) equals the uninterrupted run."""
    import shutil
    import numpy as np
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    server = _buffered_server(torch, events=False)
    setup_s = time.perf_counter() - t0
    times, kept = {}, []
    _instrument(torch, server, times, kept)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    path = os.path.join(CKPT_DIR, "async")
    rounds, peak = [], 0.0
    ops.reset_launches()          # main path 4a's count starts here
    for r in range(BUFFERED_ROUNDS):
        if r == RESUME_AT:
            require(len(server._pending) == 1
                    and server.transport.has_state()
                    and server.server_momentum.state,
                    "async: the checkpoint is not mid-buffer")
            server.save(path)
        before = _k12_launches()
        times.clear()
        torch.cuda.reset_peak_memory_stats()
        stats = server.run_round()
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        grew = {k: v - before[k] for k, v in _k12_launches().items()}
        aggregated = "aggregate_ms" in times
        rounds.append({"round": stats.round, "aggregated": aggregated,
                       "launches": grew, "round_wall_s": stats.wall_time_s,
                       **times})
        want = 3 if aggregated else 0
        require(aggregated == (r % 2 == 1),
                f"async round {r}: aggregated={aggregated} off the depth-2 "
                "cadence")
        require(all(g == want for g in grew.values()),
                f"async round {r}: K1/K2 launches {grew}, expected {want}")
    require(server.drain_pending() is None, "async: a plan left pending")
    launches = _k12_launches()   # read just after the main path
    k12 = _k12_at_path(torch, server, kept, summary, "async")
    server.flush_stats()         # the last aggregation's queued stats
    history = server.history
    energy = list(server.energy.higher_rank_ratio)
    require(len(energy) == BUFFERED_ROUNDS // 2,
            f"async: {len(energy)} energy entries for "
            f"{BUFFERED_ROUNDS // 2} aggregations")
    require(all(np.isfinite(h.mean_client_loss) for h in history),
            "async: non-finite client loss")
    require(all(bool(torch.isfinite(t).all())
                for t in _leaves(server.global_lora)),
            "async: non-finite global factors")
    dequant = _dequant_ms(torch, kept[-1][0][0])
    # the resumed run, in a fresh server
    resumed = _buffered_server(torch, events=False)
    resumed.restore(path)
    require(resumed.round_idx == RESUME_AT and len(resumed._pending) == 1,
            "async: the restored server is not at the checkpoint")
    resumed.run(BUFFERED_ROUNDS - RESUME_AT)
    resumed.drain_pending()
    same_clients = [h.clients for h in resumed.history] == \
        [h.clients for h in history]
    loss_err = max(abs(a.mean_client_loss - b.mean_client_loss)
                   / abs(a.mean_client_loss)
                   for a, b in zip(history, resumed.history))
    e_err = float(np.max(np.abs(np.asarray(energy) - np.asarray(
        resumed.energy.higher_rank_ratio))))
    e_ok = np.allclose(resumed.energy.higher_rank_ratio, energy,
                       rtol=RESUME_TOL["rtol"], atol=RESUME_TOL["atol"])
    w_err, w_ok = _leaf_errors(torch, server.global_lora,
                               resumed.global_lora)
    resume = {"same_clients": same_clients, "loss_rel_err": loss_err,
              "energy_max_abs_err": e_err, "globals_max_abs_err": w_err,
              "tol": RESUME_TOL,
              "ok": bool(same_clients and loss_err <= RESUME_TOL["loss_rtol"]
                         and e_ok and w_ok)}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del server
    prof = _profile_one_aggregation(torch, resumed)
    emit({"phase": "round_async_vit_base", "setup_s": setup_s,
          "rounds": rounds, "dequant_ms": dequant,
          "higher_rank_energy_ratio": energy,
          "mean_client_loss": [h.mean_client_loss for h in history],
          "peak_mem_gib": peak, "launches": launches, "resume": resume,
          "k12_vs_plain": k12,
          "profile_one_aggregation": prof, "card": card_line()})
    require(resume["ok"], f"async: the resumed run is off the "
                          f"uninterrupted one: {resume}")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _event_fire_bytes(server) -> bytes:
    sched = server.event_scheduler
    return json.dumps({"fires": [vars(f) for f in sched.fire_log],
                       "state": sched.state_dict(),
                       "virtual_time": [h.virtual_time
                                        for h in server.history]},
                      sort_keys=True).encode()


def phase_round_event_vit_base(torch, summary: dict) -> dict:
    """Main path 4b: four event rounds (straggler latency, timeout
    trigger) at ViT-base width, int8 transport and momentum, then the
    drain: K1/K2 launch 3 times a fire, some fire aggregates a partial
    cohort, and a second run from the same seed writes the same fire log
    byte for byte."""
    import numpy as np
    from repro_torch.kernels import ops
    server = _buffered_server(torch, events=True)
    times, kept = {}, []
    _instrument(torch, server, times, kept)
    sched = server.event_scheduler
    rounds, peak = [], 0.0
    ops.reset_launches()          # main path 4b's count starts here
    for r in range(BUFFERED_ROUNDS + 1):      # the last pass is the drain
        before, fires0 = _k12_launches(), len(sched.fire_log)
        times.clear()
        torch.cuda.reset_peak_memory_stats()
        if r < BUFFERED_ROUNDS:
            wall = server.run_round().wall_time_s
        else:
            server.drain_pending()
            wall = None
        torch.cuda.synchronize()
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        fires = len(sched.fire_log) - fires0
        grew = {k: v - before[k] for k, v in _k12_launches().items()}
        rounds.append({"round": r if r < BUFFERED_ROUNDS else "drain",
                       "fires": fires, "launches": grew,
                       "virtual_s": wall, **times})
        require(all(g == 3 * fires for g in grew.values()),
                f"event round {r}: K1/K2 launches {grew} for {fires} fires")
    launches = _k12_launches()   # read just after the main path
    k12 = _k12_at_path(torch, server, kept, summary, "event")
    masks = [k["present"] for _, k, _ in kept]
    require(len(masks) == len(sched.fire_log) and masks,
            "event: fires and aggregations disagree")
    partial = sum(not all(m) for m in masks)
    require(partial > 0, "event: no fire aggregated a partial cohort")
    require(all(np.isfinite(h.mean_client_loss) for h in server.history),
            "event: non-finite client loss")
    dispatched = sum(len(h.clients) for h in server.history)
    consumed = sum(f.consumed for f in sched.fire_log)
    require(consumed == dispatched,
            f"event: {consumed} updates aggregated of {dispatched}")
    dequant = _dequant_ms(torch, kept[-1][0][0])
    first = _event_fire_bytes(server)
    energy = list(server.energy.higher_rank_ratio)
    del server
    gc.collect()
    again = _buffered_server(torch, events=True)
    again.run(BUFFERED_ROUNDS)
    again.drain_pending()
    same = _event_fire_bytes(again) == first
    emit({"phase": "round_event_vit_base", "rounds": rounds,
          "fire_log": [vars(f) for f in sched.fire_log],
          "partial_fires": partial, "dequant_ms": dequant,
          "higher_rank_energy_ratio": energy,
          "peak_mem_gib": peak, "launches": launches, "k12_vs_plain": k12,
          "fire_log_bytes_equal": same, "card": card_line()})
    require(same, "event: two runs from one seed wrote other fire logs")
    del again
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_straggler_contrast(torch) -> None:
    """``TestStragglerRankCollapse`` on the card (kernel backend, its own
    size: d_model 96, 12 clients, 12 rounds), f32 and int8 with error
    feedback: FlexLoRA's higher-rank energy collapses, raFLoRA's holds."""
    import numpy as np
    from repro_torch.federation import events as ev
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.federation.transport import TransportConfig
    out = {}
    for label, tx in (("f32", None),
                      ("int8-ef", TransportConfig(mode="int8",
                                                  error_feedback=True))):
        ratios = {}
        for method in ("flexlora", "raflora"):
            t0 = time.perf_counter()
            exp = build_experiment(
                method, fl_overrides={"num_rounds": 12, "num_clients": 12,
                                      "participation": 0.5},
                samples_per_class=60, num_classes=12, d_model=96,
                batches_per_round=1, round_engine="async",
                staleness_gamma=0.6, transport=tx, backend="kernel",
                device=DEV)
            high = np.flatnonzero(
                exp.registry.ranks > min(exp.server.lora_cfg.rank_levels))
            exp.server.set_event_scheduler(ev.EventScheduler(
                ev.StragglerTailLatency(median=0.8, sigma=0.15,
                                        tail_scale=2.5,
                                        straggler_clients=high, seed=5),
                ev.TimeoutTrigger(2.0), round_interval=1.0))
            exp.server.run(12)
            exp.server.drain_pending()
            ratios[method] = [float(x) for x in
                              exp.server.energy.higher_rank_ratio]
            ratios[method + "_s"] = time.perf_counter() - t0
        flex, ra = ratios["flexlora"], ratios["raflora"]
        holds = {"flexlora_collapses": flex[-1] < 0.5 * flex[0],
                 "raflora_holds": (ra[-1] > 0.8 * ra[0] if tx is None
                                   else ra[-1] >= 0.4),
                 "raflora_over_2x_flexlora": ra[-1] > 2.0 * flex[-1]}
        out[label] = {"ratios": ratios, "inequalities": holds}
    emit({"phase": "straggler_contrast", **out, "card": card_line()})
    for label, res in out.items():
        require(all(res["inequalities"].values()),
                f"straggler_contrast {label}: {res['inequalities']}")


# the training launcher and the paper benches (main paths 5 and 6)
LAUNCHER_METHODS = ("flexlora", "raflora")
LAUNCHER_BUCKETS = 3     # fedvit-tiny's q/k/v/o, up and down
LAUNCH_DIR = os.path.join(ROOT, "build", "smoke_launcher")


class _CaptureK12:
    """Within the block, each call of K1/K2 through the kernel API
    (``ops.weighted_stack_b`` ...) is counted in ``counts``, and the first
    call of each distinct (kernel, input shapes) is kept in ``calls`` as
    (name, inputs); the calls still reach the kernels (and their
    counts)."""

    def __init__(self):
        self.calls, self.counts, self.seen = [], dict.fromkeys(K12, 0), set()
        self.shapes = []          # (name, input shapes) of every call

    def __enter__(self):
        from repro_torch.kernels import ops
        self.orig = {name: getattr(ops, name) for name in K12}

        def capture(name):
            def wrapper(*x):
                self.counts[name] += 1
                key = (name,) + tuple(tuple(t.shape) for t in x
                                      if hasattr(t, "shape"))
                self.shapes.append((name, key[1:]))
                if key not in self.seen:
                    self.seen.add(key)
                    self.calls.append((name, x))
                return self.orig[name](*x)
            return wrapper
        for name in K12:
            setattr(ops, name, capture(name))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        for name, fn in self.orig.items():
            setattr(ops, name, fn)
        return False


def _check_k12_calls(torch, calls, summary: dict, label: str) -> list:
    """Each captured K1/K2 call again through the kernel and its plain
    version (``_k12_check``); called after the path's launches are read,
    so these launches count nowhere."""
    from repro_torch.kernels import rank_partition_agg as rpa
    rows = []
    for name, x in calls:
        _, err, tol = _k12_check(torch, name, label, getattr(rpa, name),
                                 getattr(rpa, name + "_plain"), x)
        rows.append({"kernel": name, "shapes": [list(t.shape) for t in x
                                                if hasattr(t, "shape")],
                     "max_abs_err": err, "tol": tol})
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                           err)
    return rows


def phase_train_launcher(torch, summary: dict) -> dict:
    """Main path 5: ``python -m repro_torch.launch.train`` in process on
    the card at its defaults (fedvit-tiny d 128, 20 clients, 20 rounds,
    rank levels 4..32, eval every 5) with ``--backend kernel``, for
    flexlora and raflora: the experiment built from the launcher's flags
    (``train.experiment_args``), its server's stages timed, then the
    launcher's round loop ``train.train``. Checks: a log row a round with
    the test accuracy at every eval, K1/K2 once per shape bucket every
    round (one call of each distinct input shape over all rounds held to
    its plain version), raFLoRA's final higher-rank energy above
    FlexLoRA's, and a server restored from ``--checkpoint`` with global
    products bit-equal to the saved one. Returns the path's K1/K2
    launches."""
    import shutil
    import numpy as np
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    os.makedirs(LAUNCH_DIR)
    t0 = time.perf_counter()
    runs, total = {}, dict.fromkeys(K12, 0)
    try:
        for method in LAUNCHER_METHODS:
            out = os.path.join(LAUNCH_DIR, f"{method}.json")
            ckpt = os.path.join(LAUNCH_DIR, f"{method}_ckpt")
            argv = ["--method", method, "--backend", "kernel", "--out", out,
                    "--checkpoint", ckpt, "--device", DEV]
            args = train.parse_args(argv)
            exp = build_experiment(args.method, device=args.device,
                                   **train.experiment_args(args))
            srv = exp.server
            per_round, round_ms, stages, times = [], [], [], {}
            timed = _stage_timer(torch, times)
            srv._plan_round = timed("plan_ms", srv._plan_round)
            srv._train_grouped = timed("train_ms", srv._train_grouped)
            srv._aggregate_grouped = timed("aggregate_ms",
                                           srv._aggregate_grouped)
            run_round = srv.run_round

            def timed_round():
                before = _k12_launches()
                torch.cuda.synchronize()
                start = time.perf_counter()
                stats = run_round()
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - start) * 1e3)
                stages.append(dict(times))
                per_round.append({n: c - before[n] for n, c in
                                  _k12_launches().items()})
                return stats
            srv.run_round = timed_round
            capture = _CaptureK12()
            ops.reset_launches()          # this run's count starts here
            with capture:
                train.train(exp, args.rounds, args.eval_every,
                            args.checkpoint, args.out)
            torch.cuda.synchronize()
            launches = _k12_launches()
            srv.run_round = run_round
            with open(out) as f:
                log = json.load(f)
            fails = []

            def check(cond, msg):
                if not cond:
                    fails.append(msg)
            check(len(log) == args.rounds, f"{len(log)} log rows")
            evals = [r["round"] for r in log if "test_accuracy" in r]
            want_evals = [r for r in range(args.rounds)
                          if (r + 1) % args.eval_every == 0
                          or r == args.rounds - 1]
            check(evals == want_evals, f"test accuracy at rounds {evals}")
            check(all(np.isfinite(r["loss"]) for r in log),
                  "non-finite loss")
            check(all(g == {n: LAUNCHER_BUCKETS for n in K12}
                      for g in per_round),
                  f"K1/K2 launches a round {per_round}")
            check(capture.counts == launches,
                  f"K1/K2 calls {capture.counts}, launches {launches}")
            k12 = _check_k12_calls(torch, capture.calls, summary,
                                   f"train_launcher {method}")
            check(len(k12) >= 4 * LAUNCHER_BUCKETS,
                  f"{len(k12)} distinct K1/K2 calls")
            fresh = build_experiment(method, device=args.device,
                                     **train.experiment_args(args))
            fresh.server.restore(ckpt)
            saved, restored = _products(srv), _products(fresh.server)
            bit_equal = saved.keys() == restored.keys() and all(
                torch.equal(restored[p], x) for p, x in saved.items())
            check(bit_equal, "restored products differ from the saved")
            # one more round under the profiler (after every check above)
            profiled = _profile(torch, srv.run_round, "gram")
            runs[method] = {
                "round_ms": round_ms,
                "median_round_ms": float(np.median(round_ms)),
                "median_stage_ms": {k: float(np.median([s[k] for s in
                                                        stages]))
                                    for k in stages[0]},
                "profiled_round": profiled,
                "final_higher_rank_energy": log[-1]["higher_rank_energy"],
                "final_test_accuracy": log[-1]["test_accuracy"],
                "loss_first_last": [log[0]["loss"], log[-1]["loss"]],
                "launches": launches, "k12_distinct_calls": k12,
                "restored_bit_equal": bit_equal}
            emit({"phase": "train_launcher", "method": method,
                  "argv": argv, "rounds": args.rounds, **runs[method]})
            require(not fails, f"train_launcher {method}: "
                    + "; ".join(fails))
            for name, n in launches.items():
                total[name] += n
            del exp, srv, fresh, capture
    finally:
        shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    flex = runs["flexlora"]["final_higher_rank_energy"]
    ra = runs["raflora"]["final_higher_rank_energy"]
    emit({"phase": "train_launcher", "final_higher_rank_energy":
          {"flexlora": flex, "raflora": ra},
          "seconds": time.perf_counter() - t0, "card": card_line()})
    require(ra > flex, f"train_launcher: raFLoRA's final higher-rank "
                       f"energy {ra} not above FlexLoRA's {flex}")
    return total


def _expected_comm_bytes(cfg, lora, method: str, m: int, rank: int) -> int:
    """Table 3's bytes by shape arithmetic on the config alone: each LoRA
    target's (d_in + d_out) per unit rank, over the layers, up and down
    (FLoRA broadcasts all m clients' stacks down)."""
    hd = cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    widths = {"q_proj": (cfg.d_model, q), "k_proj": (cfg.d_model, kv),
              "v_proj": (cfg.d_model, kv), "o_proj": (q, cfg.d_model),
              "gate_proj": (cfg.d_model, cfg.d_ff),
              "up_proj": (cfg.d_model, cfg.d_ff),
              "down_proj": (cfg.d_ff, cfg.d_model)}
    per_rank = cfg.num_layers * sum(sum(widths[t]) for t in cfg.lora_targets)
    return per_rank * rank * 4 * (2 if method != "flora" else 1 + m)


# the paper benches' kernel calls: K3 (one layer), K5 and K6 once for the
# warm-up and twice timed; K1/K2 four times on bench_cost's kernel backend
BENCH_KERNEL_CALLS = 3
BENCH_COST_CALLS = 4


def phase_paper_benches(torch) -> dict:
    """Main path 6, in the child: the paper's benches through
    ``repro_torch.benchmarks`` on the card. bench_energy_dynamics (Fig.
    2a/2b, raFLoRA's final higher-rank energy above FlexLoRA's),
    bench_accuracy (Table 2, seed 0), bench_cost (Table 3: bytes equal to
    the shape arithmetic; K1/K2 once each an ``aggregate_layer`` call on
    the kernel backend, each distinct call held to the plain versions; the
    three backends' spectra and products at round_methods' backend-parity
    tolerances), bench_kernels (K5, K3 at one layer and K6 within
    phase_kernels' tolerances) and bench_round_latency's ``run`` and
    ``run_kernel_backend`` (K1/K2 once per bucket a kernel-backend round
    of its batched and its sharded server, each distinct call held to the
    plain versions) and bench_serve_latency's ``run`` at the reference's
    grid (8 cells of the reduced gemma-2b), whose virtual rows must equal
    the same cells run on the CPU. Each bench with its counts set to 0
    just before and read just after. Its last line holds {kernel: {bench:
    launches}} and each checked kernel's largest error."""
    import numpy as np
    from repro_torch.benchmarks import (bench_accuracy, bench_cost,
                                        bench_energy_dynamics, bench_kernels,
                                        bench_round_latency, common)
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.aggregation import Aggregator
    from repro_torch.kernels import ops
    from repro_torch.kernels.lora_apply import lora_apply_plain
    from repro_torch.kernels.rank_partition_agg import \
        rank_partition_agg_plain
    eps = torch.finfo(torch.float32).eps
    by_bench = {}
    summary = {n: {"max_abs_err": 0.0} for n in
               K12 + ("lora_apply", "rank_partition_agg", "ssd_scan")}

    def bench(fn):
        common.ROWS.clear()
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in ops.KERNELS
                    if k.launches}
        rows = [{"name": r["name"], "ms": r["us_per_call"] / 1e3,
                 "derived": r["derived"]} for r in common.ROWS]
        return res, launches, rows, secs

    res, launches, rows, secs = bench(
        lambda: bench_energy_dynamics.run(device=DEV))
    final = {r["name"].split("/")[1]: float(r["derived"]) for r in rows}
    emit({"phase": "paper_benches", "bench": "energy_dynamics",
          "rows": rows, "seconds": secs, "launches": launches,
          "final_higher_rank_energy": final})
    require(final["raflora"] > final["flexlora"],
            f"bench_energy_dynamics: raFLoRA's final energy {final}")

    res, launches, rows, secs = bench(
        lambda: bench_accuracy.run(seeds=(0,), device=DEV))
    emit({"phase": "paper_benches", "bench": "accuracy", "rows": rows,
          "seconds": secs, "launches": launches, "accuracy": res})
    require(all(np.isfinite(v) for v in res.values()),
            f"bench_accuracy: {res}")

    capture = _CaptureK12()
    with capture:
        res, launches, rows, secs = bench(
            lambda: bench_cost.run(device=DEV))
    fails = []
    lora = LoRAConfig()
    rank = int(np.mean(lora.rank_levels))
    comm = {}
    for r in rows:
        if r["name"].startswith("table3_comm/"):
            _, arch, method = r["name"].split("/")
            want = _expected_comm_bytes(get_config(arch), lora, method, 10,
                                        rank)
            got = bench_cost.comm_bytes_per_client(get_config(arch), lora,
                                                   method, 10, rank)
            comm[r["name"]] = got
            if got != want or r["derived"] != f"{want / 1e6:.1f}MB":
                fails.append(f"{r['name']}: {got} bytes, {r['derived']}, "
                             f"expected {want}")
    if len(comm) != 8:
        fails.append(f"{len(comm)} table3_comm rows")
    want_k12 = {n: BENCH_COST_CALLS for n in K12}
    if {n: launches.get(n, 0) for n in K12} != want_k12:
        fails.append(f"K1/K2 launches {launches}, expected {want_k12}")
    if capture.counts != want_k12:
        fails.append(f"K1/K2 calls {capture.counts}, expected {want_k12}")
    k12 = _check_k12_calls(torch, capture.calls, summary, "bench_cost")
    # one aggregate_layer call of each backend under the profiler
    factors, ranks, n_k, gb, ga = bench_cost.layer_inputs(
        torch.device(DEV), lora)
    profiled = {backend: _profile(torch, lambda: Aggregator(
        "raflora", lora.rank_levels, backend=backend).aggregate_layer(
            factors, ranks, n_k, gb, ga), "gram")
        for backend in bench_cost.BACKENDS}
    ref = res["kernel"]
    scale = max(1.0, float(ref.sigma.max()))
    parity = {}
    for backend in ("dense", "factored"):
        other = res[backend]
        sig = _max_err(other.sigma, ref.sigma)
        prod = _max_err(other.b_g @ other.a_g, ref.b_g @ ref.a_g)
        parity[backend] = {"sigma_max_abs_err": sig,
                           "product_max_abs_err": prod}
        if sig > ROUND_TOL["sigma"] * scale or \
                prod > ROUND_TOL["product"] * scale:
            fails.append(f"{backend} off the kernel backend: {sig}, {prod}")
    emit({"phase": "paper_benches", "bench": "cost", "rows": rows,
          "seconds": secs, "launches": launches, "comm_bytes": comm,
          "k12_distinct_calls": k12, "profiled_aggregate_layer": profiled,
          "backend_parity": {
              "against": "kernel", **parity,
              "sigma_tol": ROUND_TOL["sigma"] * scale,
              "product_tol": ROUND_TOL["product"] * scale}})
    require(not fails, "bench_cost: " + "; ".join(fails))
    by_bench["bench_cost"] = {n: launches.get(n, 0) for n in K12}

    res, launches, rows, secs = bench(
        lambda: bench_kernels.run(device=DEV))
    errs = {}
    x, w, a, b, s = res["kernel/lora_apply_512"]["args"]
    mag = lora_apply_plain(x.abs(), w.abs(), a.abs(), b.abs(), abs(s))
    errs["kernel/lora_apply_512"] = (
        "lora_apply", (x.shape[1] + a.shape[0]) * eps * float(mag.max()))
    bs, as_, om = res["kernel/rank_partition_agg_768"]["args"]
    mag = rank_partition_agg_plain(bs.abs(), as_.abs(), om.abs())
    errs["kernel/rank_partition_agg_768"] = (
        "rank_partition_agg", (om.numel() + 2) * eps * float(mag.max()))
    checks = {}
    for row, (kname, tol) in errs.items():
        case = res[row]
        err = _max_err(case["got"], case["want"])
        checks[row] = {"kernel": kname, "max_abs_err": err, "atol": tol}
        require(err <= tol, f"bench_kernels {row}: {err} > {tol}")
        summary[kname]["max_abs_err"] = max(summary[kname]["max_abs_err"],
                                            err)
    case = res["kernel/ssd_scan_256"]
    close = bool(torch.allclose(case["got"], case["want"], **SCAN_TOL))
    err = _max_err(case["got"], case["want"])
    checks["kernel/ssd_scan_256"] = {"kernel": "ssd_scan",
                                     "max_abs_err": err, **SCAN_TOL}
    summary["ssd_scan"]["max_abs_err"] = max(
        summary["ssd_scan"]["max_abs_err"], err)
    emit({"phase": "paper_benches", "bench": "kernels", "rows": rows,
          "seconds": secs, "launches": launches, "checks": checks})
    require(close, f"bench_kernels kernel/ssd_scan_256: {err} beyond "
                   f"{SCAN_TOL}")
    want = {"lora_apply": BENCH_KERNEL_CALLS,
            "rank_partition_agg": BENCH_KERNEL_CALLS,
            "ssd_scan": BENCH_KERNEL_CALLS}
    require(launches == want, f"bench_kernels: launches {launches}, "
                              f"expected {want}")
    by_bench["bench_kernels"] = launches

    res, launches, rows, secs = bench(
        lambda: bench_round_latency.run(device=DEV))
    emit({"phase": "paper_benches", "bench": "round_latency.run",
          "rows": rows, "seconds": secs, "launches": launches,
          "median_s": res["median_s"]})

    # the kernel-backend study: one round = LAUNCHER_BUCKETS calls of each
    # K1/K2 on each kernel server (batched and sharded, the latter on a
    # one-rank group), over its warm-up and timed rounds
    study = inspect.signature(bench_round_latency.run_kernel_backend)
    rounds = 2 * sum(study.parameters[k].default
                     for k in ("rounds", "warmup"))
    capture = _CaptureK12()
    with capture:
        res, launches, rows, secs = bench(
            lambda: bench_round_latency.run_kernel_backend(device=DEV))
    want_k12 = {n: rounds * LAUNCHER_BUCKETS for n in K12}
    got_k12 = {n: launches.get(n, 0) for n in K12}
    k12 = _check_k12_calls(torch, capture.calls, summary,
                           "bench_round_latency")
    emit({"phase": "paper_benches", "bench": "round_latency."
          "run_kernel_backend", "rows": rows, "seconds": secs,
          "launches": launches, "median_s": res["median_s"],
          "k12_distinct_calls": k12})
    require(got_k12 == want_k12 and capture.counts == want_k12,
            f"bench_round_latency: K1/K2 launches {got_k12}, calls "
            f"{capture.counts}, expected {want_k12}")
    by_bench["bench_round_latency"] = got_k12

    # the serving latency study at the reference's grid on the card, and
    # each of its cells again on the CPU (its ``run`` would rewrite the
    # artifact): the virtual rows bit-equal
    from repro_torch.benchmarks import bench_serve_latency
    from repro_torch.core.lora import split_lora
    res, launches, rows, secs = bench(
        lambda: bench_serve_latency.run(device=DEV))
    cfg_s, _, cpu_model = bench_serve_latency._build_model("cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(0))
    _, cpu_lora = split_lora(cpu_params)
    t0 = time.perf_counter()
    differ = []
    for row in res["rows"]:
        want = bench_serve_latency._run_cell(
            cpu_model, cpu_params, cpu_lora, batch=row["batch"],
            n_adapters=row["adapters"], swap_every=row["swap_every"],
            vocab=cfg_s.vocab_size)
        virtual = [k for k in want if k != "wall_s_context_only"]
        if {k: row[k] for k in virtual} != {k: want[k] for k in virtual}:
            differ.append((row, want))
    emit({"phase": "paper_benches", "bench": "serve_latency", "rows": rows,
          "seconds": secs, "cpu_seconds": time.perf_counter() - t0,
          "launches": launches, "cells": res["rows"],
          "virtual_rows_equal_cpu": not differ, "card": card_line()})
    require(len(res["rows"]) == 8 and not differ,
            f"bench_serve_latency: {len(res['rows'])} cells, card and CPU "
            f"virtual rows differ at {differ}")
    last = {"phase": "paper_benches", "launches_by_bench": by_bench,
            "max_abs_err": {k: s["max_abs_err"] for k, s in summary.items()},
            "card": card_line()}
    emit(last)
    return last


def phase_paper_benches_child() -> dict:
    """``phase_paper_benches`` in a child process (like round_methods):
    its launch counts come back from its last ``launches_by_bench``
    line."""
    t0 = time.perf_counter()
    out = _run_child("--paper-benches", "paper_benches")
    emit({"phase": "paper_benches", "child_seconds":
          time.perf_counter() - t0})
    for line in reversed(out.splitlines()):
        if line.startswith("{") and "launches_by_bench" in line:
            return json.loads(line)
    raise SmokeFailure("paper_benches: the child printed no launch counts")


# main path 7: the sharded round engine at ViT-base width (phase 4's setup)
SHARDED_ROUNDS = 3
# all-reduces of one bucket: the kernel backend's u and v, or the
# quantized collective's two payloads and two column-weight vectors
BUCKET_ALL_REDUCES = {"f32": 2, "int8": 4}


def _vit_server(engine: str, transport=None, device=None):
    """Phase 4's ViT-base round on ``engine`` with the kernel backend,
    from the base state fl.seed draws on the card (the same in every
    process)."""
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.federation.transport import TransportConfig
    from repro_torch.models.transformer import Model
    cfg, fl, lora, shards, x_tr, y_tr, patches = _vit_base_setup()
    registry = ClientRegistry.create(fl, lora, shards)
    return FederatedLoRA(
        Model(cfg, lora, device=device or DEV, remat=False), fl, lora,
        registry,
        make_batch_fn(registry, x_tr, y_tr, fl, 2, patches),
        backend="kernel", round_engine=engine,
        transport=transport and TransportConfig(mode=transport,
                                                error_feedback=True))


class _TimedCollectives:
    """Within the block, every ``torch.distributed.all_reduce`` (the
    engine's collective, ``core.collective.all_reduce``) is bracketed by CUDA
    events on the current stream; ``take_ms()`` sums and clears their
    device time (after a synchronize)."""

    def __init__(self, torch):
        self.torch, self.pairs = torch, []

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.orig = dist, dist.all_reduce

        def timed(*a, **k):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig(*a, **k)
            end.record()
            self.pairs.append((start, end))
            return out
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig
        return False

    def take_ms(self) -> float:
        self.torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs.clear()
        return ms


def _sharded_round(torch, server, times: dict, coll) -> tuple:
    """One round of a sharded server with its stages timed (summed into
    ``times``, cleared first), the all-reduces of each bucket and of the
    round counted, the collectives' device time and the peak memory."""
    from repro_torch.core import collective
    from repro_torch.kernels import rank_partition_agg as rpa
    times.clear()
    per_bucket = []
    agg = server.aggregator
    inner = type(agg).aggregate_grouped_sharded

    def counted(*a, **k):
        before = collective.all_reduce.calls
        res = inner(agg, *a, **k)
        per_bucket.append(collective.all_reduce.calls - before)
        return res
    agg.aggregate_grouped_sharded = counted
    before = {k.__name__: k.launches for k in rpa.KERNELS}
    calls = collective.all_reduce.calls
    torch.cuda.reset_peak_memory_stats()
    stats = server.run_round()
    torch.cuda.synchronize()
    grew = {k.__name__: k.launches - before[k.__name__] for k in rpa.KERNELS}
    row = {"round": stats.round, "clients": stats.clients,
           "ranks": stats.ranks, **times,
           "collective_ms": coll.take_ms(),
           "round_wall_s": stats.wall_time_s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": grew, "bucket_all_reduces": per_bucket,
           "round_all_reduces": collective.all_reduce.calls - calls,
           "mean_client_loss": stats.mean_client_loss}
    del agg.aggregate_grouped_sharded
    return stats, row


def _timed_stages(torch, server, times: dict) -> None:
    timed = _stage_timer(torch, times, accumulate=True)
    server._plan_round = timed("plan_ms", server._plan_round)
    server._train_grouped = timed("train_ms", server._train_grouped)
    server._aggregate_grouped = timed("aggregate_ms",
                                      server._aggregate_grouped)


def _factors_of(server) -> dict:
    return {p: (b.clone(), a.clone()) for p, (b, a) in
            server._extract_factors(server.global_lora,
                                    server.lora_cfg.r_max).items()}


def _round_parity(stats, ref_stats, factors, ref_factors) -> dict:
    """``tests/test_torch_round.py``'s kernel-backend checks of one round
    against a reference round: the same clients and ranks, the loss at
    rtol 1e-4, the spectrum at 1e-3 and the products at 2e-3 of
    sigma_max."""
    import numpy as np
    scale = max(1.0, float(np.abs(ref_stats.sigma_probe).max()))
    loss_rel = abs(stats.mean_client_loss - ref_stats.mean_client_loss) \
        / abs(ref_stats.mean_client_loss)
    sig = float(np.abs(stats.sigma_probe - ref_stats.sigma_probe).max())
    prod, _ = _products_err(factors, ref_factors)
    out = {"same_clients": stats.clients == ref_stats.clients
           and stats.ranks == ref_stats.ranks,
           "loss_rel_err": loss_rel, "sigma_max_abs_err": sig,
           "product_max_abs_err": prod,
           "tol": {"loss_rtol": 1e-4,
                   "sigma_atol": ROUND_TOL["sigma"] * scale,
                   "product_atol": ROUND_TOL["product"] * scale}}
    out["ok"] = bool(out["same_clients"] and loss_rel <= 1e-4
                     and sig <= ROUND_TOL["sigma"] * scale
                     and prod <= ROUND_TOL["product"] * scale)
    return out


def _sharded_world2_rank(rank: int, world: int, bucket_all_reduces: int
                         ) -> dict:
    """Rank ``rank`` of (c): one sharded round on the card's device 0
    (both ranks share it, so the group runs gloo), K1/K2's launches read just
    after and each distinct call then held to its plain version; the
    global adapters come back as numpy for the parent's checks."""
    import torch
    from repro_torch.core.lora import flatten
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server = _vit_server("sharded")   # a fresh process: the card's device 0
    times: dict = {}
    _timed_stages(torch, server, times)
    summary = {n: {"max_abs_err": 0.0} for n in K12}
    ops.reset_launches()          # this rank's count of the path
    with _TimedCollectives(torch) as coll, _CaptureK12() as capture:
        stats, row = _sharded_round(torch, server, times, coll)
    k12 = _check_k12_calls(torch, capture.calls, summary,
                           f"round_sharded world 2 rank {rank}")
    require(row["bucket_all_reduces"] == [bucket_all_reduces] * VIT_BUCKETS,
            f"world 2 rank {rank}: all-reduces {row['bucket_all_reduces']}")
    return {"row": row, "stats": stats, "k12": k12,
            "max_abs_err": {n: v["max_abs_err"] for n, v in summary.items()},
            "lora": {p: x.cpu().numpy()
                     for p, x in flatten(server.global_lora).items()}}


def phase_round_sharded(torch) -> dict:
    """Main path 7, in the child (split-K off): the sharded round engine at
    ViT-base width (phase 4's setup, kernel backend, f32).
    (a) world 1 on NCCL, 3 rounds, against the batched engine from the same
        base state and seed, each round at the round tolerances; K1/K2
        3 launches a round, 2 all-reduces a bucket;
    (b) world 1 on NCCL with int8 and error feedback, 1 round, against the
        batched engine with the same transport (the first aggregation);
        the quantized collective runs no K1, K2 3 launches, 4 all-reduces
        a bucket;
    (c) world 2 on the one card (gloo: NCCL refuses two ranks on one
        device), 1 round: 5 clients over 2 ranks, one ghost; products held
        to (a)'s batched round 0, both ranks' global adapters bit-equal.
    The first all-reduce of (a) sets up NCCL's communicator, inside round
    0's train stage (the losses' gather).
    Each sub-phase's counts start at 0 just before its rounds and are read
    just after; every distinct K1/K2 call is then held to its plain
    version. The last line holds the path's launches."""
    import hashlib
    import numpy as np
    from repro_torch.core.lora import flatten
    from repro_torch.core import collective
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_ranks
    summary = {n: {"max_abs_err": 0.0} for n in K12}
    path_launches = dict.fromkeys(K12, 0)
    # (a)'s reference: the batched engine, 3 rounds, its stages timed in
    # this call for the comparison
    batched = _vit_server("batched")
    times: dict = {}
    _timed_stages(torch, batched, times)
    ref, batched_rows = [], []
    for _ in range(SHARDED_ROUNDS):
        times.clear()
        stats = batched.run_round()
        ref.append((stats, _factors_of(batched)))
        batched_rows.append({"round": stats.round, **times,
                             "round_wall_s": stats.wall_time_s})
    del batched
    gc.collect()
    torch.cuda.empty_cache()
    for label, transport, rounds, want_k1 in (
            ("a", None, SHARDED_ROUNDS, VIT_BUCKETS),
            ("b", "int8", 1, 0)):
        if transport:
            other = _vit_server("batched", transport=transport)
            ref = [(other.run_round(), _factors_of(other))]
            del other
        server = _vit_server("sharded", transport=transport)
        require(collective.shard_count(server.mesh) == 1
                and torch.distributed.get_backend() == "nccl",
                f"round_sharded ({label}): not a one-rank NCCL group")
        times: dict = {}
        _timed_stages(torch, server, times)
        rows, fails = [], []
        ops.reset_launches()      # the sub-phase's count starts here
        with _TimedCollectives(torch) as coll, _CaptureK12() as capture:
            for r in range(rounds):
                stats, row = _sharded_round(torch, server, times, coll)
                row["parity"] = _round_parity(stats, ref[r][0],
                                              _factors_of(server), ref[r][1])
                rows.append(row)
                want = {"weighted_stack_b": want_k1,
                        "weighted_stack_a": want_k1,
                        "gram_left": VIT_BUCKETS, "gram_right": VIT_BUCKETS}
                per = BUCKET_ALL_REDUCES[transport or "f32"]
                if row["launches"] != want:
                    fails.append(f"round {r}: launches {row['launches']}, "
                                 f"expected {want}")
                if row["bucket_all_reduces"] != [per] * VIT_BUCKETS:
                    fails.append(f"round {r}: all-reduces "
                                 f"{row['bucket_all_reduces']}")
                if not row["parity"]["ok"]:
                    fails.append(f"round {r}: off the batched engine "
                                 f"{row['parity']}")
                if not all(bool(torch.isfinite(t).all())
                           for t in _leaves(server.global_lora)):
                    fails.append(f"round {r}: non-finite global factors")
        launches = _k12_launches()   # read just after the sub-phase
        for k, n in launches.items():
            path_launches[k] += n
        k12 = _check_k12_calls(torch, capture.calls, summary,
                               f"round_sharded ({label})")
        emit({"phase": "round_sharded_vit_base", "sub": label,
              "world": 1, "backend": "nccl", "transport": transport,
              "rounds": rows, "launches": launches, "k12_vs_plain": k12,
              "batched_rounds": batched_rows if label == "a" else None,
              "card": card_line()})
        require(not fails, f"round_sharded ({label}): " + "; ".join(fails))
        if label == "a":
            ref0 = ref[0]
        server.close()        # the one-rank group it made
        del server
        gc.collect()
        torch.cuda.empty_cache()
    # (c) two ranks on the one card
    t0 = time.perf_counter()
    ranks = spawn_ranks(_sharded_world2_rank, 2, BUCKET_ALL_REDUCES["f32"],
                        backend="gloo")
    spawn_s = time.perf_counter() - t0
    dev = torch.device(DEV)
    factors = {}
    for p, x in ranks[0]["lora"].items():
        factors.setdefault(p[:-1], {})[p[-1]] = torch.from_numpy(x).to(dev)
    factors = {p: (ab["lora_a"].mT, ab["lora_b"].mT)
               for p, ab in factors.items()}
    parity = _round_parity(ranks[0]["stats"], ref0[0],
                           {p: factors[p] for p in ref0[1]}, ref0[1])
    digests = [hashlib.sha256(b"".join(
        np.ascontiguousarray(r["lora"][p]).tobytes()
        for p in sorted(r["lora"]))).hexdigest() for r in ranks]
    for r in ranks:
        for k, n in r["row"]["launches"].items():
            path_launches[k] += n
        for k, e in r["max_abs_err"].items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], e)
    members = ranks[0]["stats"].clients
    emit({"phase": "round_sharded_vit_base", "sub": "c", "world": 2,
          "backend": "gloo", "device": "the card's device 0, both ranks",
          "spawn_s": spawn_s, "rows": [r["row"] for r in ranks],
          "parity_vs_batched_round0": parity,
          "ranks_bit_equal": digests[0] == digests[1],
          "sha256": digests, "k12_vs_plain": [r["k12"] for r in ranks],
          "card": card_line()})
    require(len(members) % 2 == 1, f"world 2: {len(members)} clients, "
                                   "no ghost")
    require(parity["ok"], f"round_sharded (c): off the batched round "
                          f"{parity}")
    require(digests[0] == digests[1],
            "round_sharded (c): the two ranks' global adapters differ")
    require(all(r["row"]["launches"] == dict.fromkeys(K12, VIT_BUCKETS)
                for r in ranks),
            f"round_sharded (c): launches "
            f"{[r['row']['launches'] for r in ranks]}")
    last = {"phase": "round_sharded_vit_base", "path_launches": path_launches,
            "max_abs_err": {k: s["max_abs_err"] for k, s in summary.items()},
            "card": card_line()}
    emit(last)
    return last


def phase_round_sharded_child() -> dict:
    """``phase_round_sharded`` in a child process with cuBLAS's split-K
    off, as round_methods: the sharded and batched engines' parity needs
    it (ROADMAP.md queue 3, "Watch"). Its launches come back from its
    last line."""
    out = _run_child("--round-sharded", "round_sharded_vit_base",
                     env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0"))
    for line in reversed(out.splitlines()):
        if line.startswith("{") and "path_launches" in line:
            return json.loads(line)
    raise SmokeFailure("round_sharded_vit_base: the child printed no "
                       "launch counts")


# main path 8: the PEFT variants (paper Table 5) at ViT-base width
VARIANT_RUNS = (("dora", "flexlora"), ("dora", "raflora"),
                ("qlora", "flexlora"), ("qlora", "raflora"))
VARIANT_ROUNDS = 2
MAGNITUDE_RTOL = 1e-5     # the global magnitudes vs the host's FedAvg


def _variant_checks(torch, server, plan, lora_before, base_before) -> dict:
    """What main paths 8 and 9 check after a round, from the round's
    trained plan and the global and base trees it started from: under
    DoRA every global magnitude moved, is finite and equals the host's
    float64 FedAvg of the plan's client magnitudes (n_k / sum n_k in
    group order, ``MAGNITUDE_RTOL``); under QLoRA every adapted ``w``
    has at most 2^bits distinct values a column and the base is
    unchanged by the round."""
    import numpy as np
    from repro_torch.core.lora import flatten
    from repro_torch.federation.transport import is_magnitude
    lora = server.lora_cfg
    out = {}
    if lora.variant == "dora":
        members = [i for mem, _, _ in plan.group_factors for i in mem]
        n = np.asarray([plan.n_k[i] for i in members], np.float64)
        w = n / n.sum()
        flat = flatten(server.global_lora)
        errs, moved, finite = [], True, True
        for key in plan.group_factors[0][2]:
            if not is_magnitude(key):
                continue
            ms = torch.cat([fg[key] for _, _, fg in plan.group_factors])
            want = np.tensordot(w, ms.double().cpu().numpy(), axes=1)
            got = flat[key[0] + ("lora_m",)]
            finite &= bool(torch.isfinite(got).all())
            moved &= not torch.equal(got, lora_before[key[0] + ("lora_m",)])
            errs.append(float(np.abs(got.double().cpu().numpy() - want).max()
                              / np.abs(want).max()))
        out.update(magnitudes=len(errs), magnitude_max_rel_err=max(errs),
                   magnitudes_moved=moved, magnitudes_finite=finite)
        require(errs and max(errs) <= MAGNITUDE_RTOL and moved and finite,
                f"DoRA magnitudes: {out}")
    if lora.variant == "qlora":
        levels, same = 0, True
        adapted = flatten(server.global_lora)
        for path, x in flatten(server.base).items():
            if path[-1] == "w" and path[:-1] + ("lora_a",) in adapted:
                srt = torch.sort(x, dim=-2).values
                levels = max(levels, int(((srt[..., 1:, :] != srt[..., :-1, :])
                                          .sum(-2) + 1).max()))
            same &= torch.equal(x, base_before[path])
        out.update(max_levels_per_column=levels, base_unchanged=same)
        require(levels <= 2 ** lora.quant_bits and same,
                f"QLoRA base: {out}")
    return out


def _instrumented_round(torch, server, profile: bool = False) -> dict:
    """One round of ``server`` with its plan / train / aggregate stages
    timed (CUDA events), K1/K2's launches counted around it, each
    distinct K1/K2 call captured, every aggregated spectrum kept, the
    trained plan and the trees the round started from; ``profile`` runs
    the round under torch.profiler (device idle share)."""
    from repro_torch.core.lora import flatten
    from repro_torch.kernels import rank_partition_agg as rpa
    times, kept, agg, sigmas = {}, {}, {}, []
    timed = _stage_timer(torch, times)
    live = {name: getattr(server, name) for name in
            ("_plan_round", "_train_stage", "_aggregate_grouped")}
    server._plan_round = timed("plan_ms", live["_plan_round"])
    server._train_stage = timed("train_ms", live["_train_stage"], kept)
    server._aggregate_grouped = timed("aggregate_ms",
                                      live["_aggregate_grouped"], agg)
    inner = server.aggregator.aggregate_grouped

    def capture(*a, **k):
        res = inner(*a, **k)
        if res.sigma is not None:
            sigmas.append(res.sigma)
        return res
    server.aggregator.aggregate_grouped = capture
    lora_before = flatten(server.global_lora)
    base_before = {p: x.clone() for p, x in flatten(server.base).items()} \
        if server.lora_cfg.variant == "qlora" else {}
    before = [k.launches for k in rpa.KERNELS]
    torch.cuda.reset_peak_memory_stats()
    prof = None
    try:
        with _CaptureK12() as k12:
            if profile:
                box = {}
                prof = _profile(torch, lambda: box.update(
                    stats=server.run_round()), "gram")
                stats = box["stats"]
            else:
                stats = server.run_round()
            torch.cuda.synchronize()
    finally:
        for name, fn in live.items():
            setattr(server, name, fn)
        server.aggregator.aggregate_grouped = inner
    return {"stats": stats, "plan": kept["args"][0], "times": times,
            "agg_args": agg["args"], "sigmas": sigmas,
            "launches": {k.__name__: k.launches - b
                         for k, b in zip(rpa.KERNELS, before)},
            "k12_calls": k12.calls, "k12_shapes": k12.shapes,
            "profile": prof,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "lora_before": lora_before, "base_before": base_before}


def phase_round_variants_vit_base(torch, summary: dict) -> dict:
    """Main path 8: the PEFT variants of Table 5 at ViT-base width
    (phase 4's setup: 20 clients, participation 0.25, batch 32, rank
    levels 4..32, batched engine, kernel backend, f32), DoRA and QLoRA
    (4 bits) x FlexLoRA and raFLoRA, ``VARIANT_ROUNDS`` rounds each
    from the base state fl.seed draws, and one more DoRA raFLoRA round
    under torch.profiler. K1/K2 launch once per bucket (3) every round
    (the magnitudes enter no bucket); ``_variant_checks`` after each
    round; every distinct K1/K2 call of the path is then held to its
    plain version. Returns the path's launches."""
    import dataclasses
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.models.transformer import Model
    cfg, fl0, lora0, shards, x_tr, y_tr, patches = _vit_base_setup()
    path_launches = dict.fromkeys(K12, 0)
    calls, seen = [], set()
    for variant, method in VARIANT_RUNS:
        lora = dataclasses.replace(lora0, variant=variant, quant_bits=4)
        fl = dataclasses.replace(fl0, aggregator=method)
        registry = ClientRegistry.create(fl, lora, shards)
        server = FederatedLoRA(
            Model(cfg, lora, device=DEV, remat=False), fl, lora, registry,
            make_batch_fn(registry, x_tr, y_tr, fl, 2, patches),
            backend="kernel")
        profiled = (variant, method) == ("dora", "raflora")
        for rnd in range(VARIANT_ROUNDS + profiled):
            run = _instrumented_round(torch, server,
                                      profile=rnd == VARIANT_ROUNDS)
            stats = run["stats"]
            require(run["launches"] == dict.fromkeys(K12, VIT_BUCKETS),
                    f"round_variants {variant}/{method} round {rnd}: "
                    f"launches {run['launches']}")
            for k, n in run["launches"].items():
                path_launches[k] += n
            for name, x in run["k12_calls"]:
                key = (name,) + tuple(tuple(t.shape) for t in x
                                      if hasattr(t, "shape"))
                if key not in seen:
                    seen.add(key)
                    calls.append((name, x))
            checks = _variant_checks(torch, server, run["plan"],
                                     run["lora_before"], run["base_before"])
            finite = all(bool(torch.isfinite(t).all())
                         for t in _leaves(server.global_lora))
            require(finite, f"round_variants {variant}/{method}: non-finite "
                            "global adapters")
            emit({"phase": "round_variants_vit_base", "variant": variant,
                  "method": method, "round": stats.round,
                  "clients": stats.clients, "ranks": stats.ranks,
                  **run["times"], "round_wall_s": stats.wall_time_s,
                  "mean_client_loss": stats.mean_client_loss,
                  "higher_rank_energy_ratio":
                      float(server.energy.higher_rank_ratio[-1]),
                  "peak_mem_gib": run["peak_mem_gib"],
                  "launches": run["launches"], **checks,
                  "profile": run["profile"], "card": card_line()})
        del server
        gc.collect()
        torch.cuda.empty_cache()
    rows = _check_k12_calls(torch, calls, summary, "round_variants")
    emit({"phase": "round_variants_vit_base", "k12_vs_plain": rows,
          "path_launches": path_launches})
    return path_launches


# main path 9: the paper's language models at full width, in a child
LM_LEVELS = (8, 16, 32)
LM_CLIENTS, LM_BATCH, LM_SEQ = 5, 2, 64
LM_RUNS = (("llama3.2-3b", "lora", 2), ("roberta-base", "dora", 3),
           ("hubert-xlarge", "lora", 1))
# HuBERT-XLarge's frames: ClusterClassification at the frontend's width,
# 64 frames (1.28 s at its 20 ms frame rate), 20 classes of 8 clips; the
# label is read at position 0 (federation/experiment.py's ``to_batch``)
AUDIO_FRAMES, AUDIO_CLASSES, AUDIO_CLIPS = 64, 20, 8


def _lm_server(cfg, variant: str, method: str = "raflora"):
    """A batched kernel-backend server over ``cfg`` at full width: 5
    clients a round (all of them) at rank levels 8/16/32 on
    ``SequenceCopy`` token data in the model's vocabulary, 64 tokens,
    batches of 2, one local step; the base state fl.seed draws on the
    card. An audio encoder takes frame embeddings instead
    (``ClusterClassification``, ``AUDIO_*``), partitioned by class."""
    from repro_torch.configs import FLConfig, LoRAConfig
    from repro_torch.data import (ClusterClassification, SequenceCopy,
                                  batches, make_partition)
    from repro_torch.federation.experiment import make_batch_fn
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.topology import ClientRegistry
    from repro_torch.models.transformer import Model
    fl = FLConfig(aggregator=method, num_clients=LM_CLIENTS,
                  participation=1.0, num_rounds=1, local_batch_size=LM_BATCH,
                  learning_rate=2e-3, partition="pathological",
                  labels_per_client=4)
    lora = LoRAConfig(rank_levels=LM_LEVELS,
                      rank_probs=(1 / 3, 1 / 3, 1 / 3), variant=variant)
    audio = cfg.frontend.kind == "audio"
    if audio:
        frames, family = ClusterClassification(
            num_classes=AUDIO_CLASSES, dim=cfg.frontend.embed_dim,
            patches=AUDIO_FRAMES, samples_per_class=AUDIO_CLIPS,
            seed=0).generate()
    else:
        data = SequenceCopy(vocab_size=cfg.vocab_size, seq_len=LM_SEQ,
                            num_families=10, samples_per_family=8, seed=0)
        tokens, targets, family = data.generate()
    shards = make_partition(fl.partition, family, fl.num_clients,
                            labels_per_client=fl.labels_per_client,
                            seed=fl.seed)
    registry = ClientRegistry.create(fl, lora, shards)

    def batch_fn(cid, rng):
        idx = registry.shards[cid]
        bx, by = next(batches(tokens[idx], targets[idx], LM_BATCH, rng))
        return [{"tokens": bx, "targets": by}]
    if audio:
        batch_fn = make_batch_fn(registry, frames, family, fl, 1,
                                 AUDIO_FRAMES)
    return FederatedLoRA(Model(cfg, lora, device=DEV, remat=False), fl,
                         lora, registry, batch_fn, backend="kernel")


def _factored_check(torch, server, run) -> tuple:
    """The round ``run`` of ``_instrumented_round`` aggregated again on the
    factored backend, from its trained factors and the global state it
    started from: (the largest |B_g A_g| difference to the kernel
    backend's, whether every product and spectrum is finite, max(1,
    sigma_max) of the round's spectra)."""
    from repro_torch.core.aggregation import Aggregator
    from repro_torch.core.lora import unflatten
    from repro_torch.federation.server import FederatedLoRA
    from repro_torch.federation.transport import is_magnitude
    levels = server.lora_cfg.rank_levels
    finite = all(bool(torch.isfinite(s).all()) for s in run["sigmas"])
    scale = max([1.0] + [float(s.max()) for s in run["sigmas"]])
    live = server.global_lora, server.aggregator
    server.global_lora = unflatten(run["lora_before"])
    server.aggregator = Aggregator(server.fl.aggregator, levels,
                                   backend="factored")
    try:
        ref, _, _ = FederatedLoRA._aggregate_grouped(server,
                                                     *run["agg_args"])
    finally:
        server.global_lora, server.aggregator = live
    got = server._extract_factors(server.global_lora, max(levels))
    err = 0.0
    for parent, val in ref.items():
        if is_magnitude(parent):
            continue
        b, a = got[parent]
        prod = b @ a
        finite &= bool(torch.isfinite(prod).all())
        err = max(err, float((prod - val[0] @ val[1]).abs().max()))
        del prod
    return err, finite, scale


def phase_round_paper_lms(torch) -> dict:
    """Main path 9, in the child (split-K off): one raFLoRA round of the
    batched engine on the kernel backend, after one untimed round, for
    each of the paper's language models at full width in f32: (a) LLaMA-3.2-3B (28 layers, d 3072, GQA
    24/8, vocab 128256, tied head, LoRA on q/v: 2 buckets), (b)
    RoBERTa-base under DoRA (12 layers, d 768, vocab 50265, untied head,
    LoRA on q/k/v/o/up/down: 3 buckets), (c) HuBERT-XLarge (48 layers, d
    1280, MHA 16 x 80 with qkv bias, the audio frontend, encoder-only,
    LoRA on q/k/v/o: one bucket of 4 x 48 = 192 adapters) on frame
    embeddings. Each round runs under
    torch.profiler with its stages timed; K1/K2 launch once per bucket,
    and the buckets' layers L (each K1 call's leading axis) add up to the
    model's adapters; the spectra and products are finite; the aggregate's
    products equal
    the factored backend's on the same trained factors and global state
    at ``ROUND_TOL`` (products 2e-3 of max(1, sigma_max)); DoRA's
    ``_variant_checks``; every distinct K1/K2 call held to its plain
    version; K2's plan at each bucket. The last line holds the path's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.gemm_plan import plan_gram
    summary = {n: {"max_abs_err": 0.0} for n in K12}
    path_launches = dict.fromkeys(K12, 0)
    for name, variant, n_buckets in LM_RUNS:
        cfg = get_config(name)
        t0 = t_model = time.perf_counter()
        server = _lm_server(cfg, variant)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # one untimed round first: the process's first cuBLAS, cuSOLVER
        # and lazily loaded kernels at these shapes (1.4 s of llama's
        # first train stage) would otherwise land in the measured round
        t0 = time.perf_counter()
        first = server.run_round()
        torch.cuda.synchronize()
        first_round_s = time.perf_counter() - t0
        run = _instrumented_round(torch, server, profile=True)
        stats = run["stats"]
        require(run["launches"] == dict.fromkeys(K12, n_buckets),
                f"round_paper_lms {name}: launches {run['launches']}")
        for k, n in run["launches"].items():
            path_launches[k] += n
        err, finite, scale = _factored_check(torch, server, run)
        checks = _variant_checks(torch, server, run["plan"],
                                 run["lora_before"], run["base_before"])
        k12 = _check_k12_calls(torch, run["k12_calls"], summary, name)
        # a bucket's K2 calls: U_c (L, d, R) and V_c (L, R, n)
        grams = {g: [shapes[0] for kname, shapes in run["k12_shapes"]
                     if kname == g] for g in ("gram_left", "gram_right")}
        buckets = [{"layers": ll, "d": d, "n": n, "rank_cols": rr,
                    "k2_plans": {"gram_left": plan_gram(ll, rr, d).report(),
                                 "gram_right": plan_gram(ll, rr,
                                                         n).report()}}
                   for (ll, d, rr), (_, _, n) in zip(grams["gram_left"],
                                                     grams["gram_right"])]
        adapters = len(cfg.lora_targets) * cfg.num_layers
        tol = ROUND_TOL["product"] * scale
        emit({"phase": "round_paper_lms", "model": name, "variant": variant,
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "vocab": cfg.vocab_size, "clients": stats.clients,
              "ranks": stats.ranks, "batch": LM_BATCH, "seq": LM_SEQ,
              "setup_s": setup_s, "untimed_round_s": first_round_s,
              "untimed_round_loss": first.mean_client_loss,
              **run["times"],
              "round_wall_s": stats.wall_time_s,
              "mean_client_loss": stats.mean_client_loss,
              "peak_mem_gib": run["peak_mem_gib"],
              "launches": run["launches"], "finite": finite,
              "factored_product_max_abs_err": err, "tol": tol,
              "sigma_max": scale, **checks, "k12_vs_plain": k12,
              "buckets": buckets, "adapters": adapters,
              "profile": run["profile"],
              "model_seconds": time.perf_counter() - t_model,
              "card": card_line()})
        require(sum(b["layers"] for b in buckets) == adapters,
                f"round_paper_lms {name}: buckets {buckets} do not hold "
                f"its {adapters} adapters")
        require(finite, f"round_paper_lms {name}: non-finite spectra or "
                        "products")
        require(err <= tol, f"round_paper_lms {name}: products {err} off "
                            f"the factored backend's (tol {tol})")
        del server, run
        gc.collect()
        torch.cuda.empty_cache()
    last = {"phase": "round_paper_lms", "path_launches": path_launches,
            "max_abs_err": {k: s["max_abs_err"] for k, s in summary.items()},
            "card": card_line()}
    emit(last)
    return last


def phase_round_paper_lms_child() -> dict:
    """``phase_round_paper_lms`` in a child process with cuBLAS's split-K
    off, as round_methods (it frees the 13 GB model with the process).
    Its launches come back from its last line."""
    out = _run_child("--round-paper-lms", "round_paper_lms",
                     env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0"))
    for line in reversed(out.splitlines()):
        if line.startswith("{") and "path_launches" in line:
            return json.loads(line)
    raise SmokeFailure("round_paper_lms: the child printed no launch "
                       "counts")


# main paths 13 and 14: DeepSeek-V2 at full width, f32, its depth cut to 2
# of 60 layers (35.97 GB of weights: routed experts 15.10 GB a layer, MLA
# 0.60, shared experts 0.19, embedding and untied head 4.19)
DEEPSEEK_LAYERS = 2
DS_LATE_PROMPT = 20      # the late slot's shorter prompt
DS_LATE_AFTER = 3        # decode steps of slots 0-2 before it is admitted
DS_SWAP_AFTER = 8        # decode steps before the hot swap (tenant t4)


def _deepseek_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v2-236b"),
                               num_layers=DEEPSEEK_LAYERS)


def _watch_train_loss(server, fn):
    """``fn()`` with the server model's ``train_loss_clients`` watched:
    (fn's result, the last training step's per-client (loss, metrics))."""
    model, seen = server.model, []
    inner = model.train_loss_clients

    def watched(*a, **k):
        loss, metrics = inner(*a, **k)
        seen.append((loss.detach(), {n: v.detach()
                                     for n, v in metrics.items()}))
        return loss, metrics
    model.train_loss_clients = watched
    try:
        out = fn()
    finally:
        del model.train_loss_clients
    return out, seen[-1]


def phase_round_deepseek_v2(torch) -> dict:
    """Main path 14, in the child (split-K off): one raFLoRA round of the
    batched engine on the kernel backend, after one untimed round, for
    DeepSeek-V2 at full width with 2 layers (``_lm_server``: 5 clients at
    rank levels 8/16/32, batch 2 x 64 ``SequenceCopy`` tokens, one local
    step; LoRA on q_a, kv_a and o). Under torch.profiler with its stages
    timed: K1/K2 launch once per shape bucket (the bucketing's count: q_a
    5120 -> 1536, kv_a 5120 -> 576 and o 16384 -> 5120 give 3), the
    products equal the factored backend's on the same trained factors at
    ``ROUND_TOL``, the spectra are finite, each client's MoE aux loss is
    finite, positive and part of its training loss; every distinct K1/K2
    call held to its plain version. The last line holds the path's
    launches."""
    from repro_torch.models.layers import moe
    cfg = _deepseek_cfg()
    summary = {n: {"max_abs_err": 0.0} for n in K12}
    t0 = time.perf_counter()
    server = _lm_server(cfg, "lora")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    factors = server._extract_factors(server.global_lora,
                                      max(LM_LEVELS)).values()
    buckets = len({(tuple(b.shape), tuple(a.shape)) for b, a in factors})
    require(buckets == 3, f"round_deepseek_v2: {buckets} shape buckets, "
                          "expected 3 (q_a, kv_a, o)")
    t0 = time.perf_counter()
    first = server.run_round()
    torch.cuda.synchronize()
    first_round_s = time.perf_counter() - t0
    syncs = moe.moe_apply.host_syncs
    run, (loss, metrics) = _watch_train_loss(
        server, lambda: _instrumented_round(torch, server, profile=True))
    syncs = moe.moe_apply.host_syncs - syncs
    stats = run["stats"]
    require(run["launches"] == dict.fromkeys(K12, buckets),
            f"round_deepseek_v2: launches {run['launches']}")
    aux = metrics["aux_loss"]
    aux_ok = bool(torch.isfinite(aux).all() and (aux > 0).all()
                  and torch.allclose(loss, metrics["loss"] + aux,
                                     rtol=1e-6, atol=0))
    err, finite, scale = _factored_check(torch, server, run)
    k12 = _check_k12_calls(torch, run["k12_calls"], summary,
                           "deepseek-v2-236b")
    tol = ROUND_TOL["product"] * scale
    emit({"phase": "round_deepseek_v2", "model": cfg.name,
          "layers": f"{cfg.num_layers} of 60", "d_model": cfg.d_model,
          "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k,
          "vocab": cfg.vocab_size, "clients": stats.clients,
          "ranks": stats.ranks, "batch": LM_BATCH, "seq": LM_SEQ,
          "buckets": buckets, "setup_s": setup_s,
          "untimed_round_s": first_round_s,
          "untimed_round_loss": first.mean_client_loss, **run["times"],
          "round_wall_s": stats.wall_time_s,
          "mean_client_loss": stats.mean_client_loss,
          "aux_loss": aux.tolist(), "aux_in_loss": aux_ok,
          "moe_host_syncs": syncs,
          "peak_mem_gib": run["peak_mem_gib"],
          "launches": run["launches"], "finite": finite,
          "factored_product_max_abs_err": err, "tol": tol,
          "sigma_max": scale, "k12_vs_plain": k12,
          "profile": run["profile"], "card": card_line()})
    require(finite, "round_deepseek_v2: non-finite spectra or products")
    require(err <= tol, f"round_deepseek_v2: products {err} off the "
                        f"factored backend's (tol {tol})")
    require(aux_ok, f"round_deepseek_v2: aux loss {aux.tolist()} not "
                    f"finite, positive and in the loss")
    last = {"phase": "round_deepseek_v2", "path_launches": run["launches"],
            "max_abs_err": {k: s["max_abs_err"] for k, s in summary.items()},
            "card": card_line()}
    emit(last)
    return last


def phase_round_deepseek_v2_child() -> dict:
    """``phase_round_deepseek_v2`` in a child process with cuBLAS's
    split-K off, as round_paper_lms (the 36 GB model goes with the
    process). Its launches come back from its last line."""
    out = _run_child("--round-deepseek-v2", "round_deepseek_v2",
                     env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":0:0"))
    for line in reversed(out.splitlines()):
        if line.startswith("{") and "path_launches" in line:
            return json.loads(line)
    raise SmokeFailure("round_deepseek_v2: the child printed no launch "
                       "counts")


def phase_profile(torch, server) -> None:
    """One more vit-base round under torch.profiler: device time by
    kernel, K2's share and the device's idle share of the round."""
    emit({"phase": "profile", **_profile(torch, server.run_round, "gram")})


def _tenant_tree(torch, params, gen, device):
    """Random nonzero factors shaped like the model's adapter leaves, in
    their dtype."""
    from repro_torch.core.lora import flatten, unflatten
    flat = {}
    for path, t in flatten(params).items():
        if path[-1] == "lora_a":
            flat[path] = (torch.randn(t.shape, generator=gen, device=device)
                          * t.shape[-1] ** -0.5).to(t.dtype)
        elif path[-1] == "lora_b":
            flat[path] = (torch.randn(t.shape, generator=gen, device=device)
                          * 0.1 * t.shape[-1] ** -0.5).to(t.dtype)
    return unflatten(flat)


def _move(tree, dev):
    from repro_torch.core.lora import flatten, unflatten
    return unflatten({p: t.to(dev) for p, t in flatten(tree).items()})


def _serve_small(torch, phase: str, cfg, prompt_len: int, tol: dict,
                 admit_launches: dict):
    """A reduced engine on cuda with ``use_kernels`` and on cpu with the
    plain path, from the same weights and tenants (ranks 16 and 4): equal
    greedy tokens over 5 steps, first-step logits within ``tol``, and each
    kernel of ``admit_launches`` ({wrapper: launches}) launched that many
    times by the card's admit."""
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
        before = {k: k.launches for k in admit_launches}
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        launches = {k: k.launches - n for k, n in before.items()}
        first_logits = eng.last_logits.cpu()
        for _ in range(4):
            toks.append(eng.decode([True, True]).cpu())
        runs.append((torch.stack(toks, dim=1), first_logits, launches))
    (tc, lc, launches), (th, lh, _) = runs
    ok_tokens = bool(torch.equal(tc, th))
    emit({"phase": phase, "tokens_cuda": tc.tolist(),
          "tokens_cpu": th.tolist(), "tokens_equal": ok_tokens,
          "first_logits_max_abs_err": float((lc - lh).abs().max()),
          "tol": tol, "launches_in_admit": {k.__name__: n for k, n in
                                            launches.items()}})
    for kernel, want in admit_launches.items():
        require(launches[kernel] == want,
                f"{phase}: {kernel.__name__} launched {launches[kernel]} "
                f"times in admit, expected {want}")
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
                 {la.batched_lora_apply: 4 * cfg.num_layers})


def phase_serve_small_mamba2(torch):
    """A reduced mamba2, 64-token prompts so the scan carries its state
    across two chunks of 32."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("mamba2-1.3b").reduced()
    _serve_small(torch, "serve_small_mamba2", cfg, 64,
                 {"rtol": 1e-4, "atol": 1e-5}, {k6.ssd_scan: cfg.num_layers})


def phase_serve_small_hymba(torch):
    """A reduced hymba (layer 0 global, layer 1 windowed at 64; 16 SSD heads
    of P 32), 96-token prompts so the window bites in layer 1 and the scan
    carries its state across three chunks of 32; K4 on q/k/v/o and K6 on
    the SSD heads. First-step logits within the reduced SSD models'
    tolerance in tests/test_torch_ssd.py (atol 1e-4: the dual form's
    decays amplify GEMM rounding)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("hymba-1.5b").reduced()
    _serve_small(torch, "serve_small_hymba", cfg, 96,
                 {"rtol": 1e-4, "atol": 1e-4},
                 {la.batched_lora_apply: 4 * cfg.num_layers,
                  k6.ssd_scan: cfg.num_layers})


def _profile(torch, fn, match) -> dict:
    """One call of ``fn`` under torch.profiler: wall and device time, the
    device time of the kernels whose name contains ``match`` (a string, or
    a tuple of them: then also each one's ms and share under
    ``by_match``) and their share, the device's idle share, the top 8
    kernels."""
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
    matches = (match,) if isinstance(match, str) else tuple(match)
    by_match = {m: sum(e.self_device_time_total for e in kern
                       if m in e.key) / 1e3 for m in matches}
    match_ms = sum(e.self_device_time_total for e in kern
                   if any(m in e.key for m in matches)) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    extra = {} if isinstance(match, str) else {"by_match": {
        m: {"device_ms": ms, "share_of_device": ms / dev_ms if dev_ms
            else None} for m, ms in by_match.items()}}
    return {"wall_ms": wall, "device_ms": dev_ms, **extra,
            "kernel_device_ms": match_ms,
            # None: the profiler saw no device time
            "kernel_share_of_device": match_ms / dev_ms if dev_ms else None,
            "device_idle_share": 1 - dev_ms / wall,
            "top_kernels": [{"name": e.key[:90], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _top2_rule(torch, label: str, got, want) -> dict:
    """The serve phases' rule on last-position logits (S, V): every slot's
    greedy token equals the plain path's, or differs where the plain
    path's top-2 gap is within twice that slot's largest logit change."""
    from repro_torch.serving.engine import greedy
    got, want = got.float(), want.float()
    dl = (got - want).abs()
    flips = []
    for slot in (greedy(got) != greedy(want)).nonzero().flatten().tolist():
        top2 = want[slot].topk(2).values
        gap, tol = float(top2[0] - top2[1]), 2 * float(dl[slot].max())
        flips.append({"slot": slot, "top2_gap": gap, "tol": tol})
        require(gap <= tol, f"{label}: tokens differ at slot {slot} with "
                            f"top-2 gap {gap} > {tol}")
    return {"logits_max_abs_diff": float(dl.max()), "flips": flips}


def _serve_full(torch, phase: str, cfg, prompt_len: int, kernels,
                match, after=None, dtype=None, teacher=False,
                host_syncs=None, init_slack_gib=None) -> dict:
    """A main serving path at full width in ``dtype`` (f32 by default; in
    bf16 every K4 launch must be a bf16 instance's, counted under
    ``batched_lora_apply_bf16``): 4 slots of ``prompt_len``
    tokens and 16 new tokens over 3 tenants at ranks 16/8/4 (slots on
    16/8/4/16), with a hot swap after 8 decode steps. The engine with
    ``use_kernels`` runs step by step against the same engine's plain path
    on the card, on one copy of the weights; each ``(wrapper, admit,
    decode)`` of ``kernels`` must launch ``admit`` times in the admit call
    and ``decode`` in each decode step. Then two more prefills of each
    engine in turns, and one more decode step and one more prefill of each
    engine under the profiler (``match``: the kernels' names, see
    ``_profile``). ``after(eng, ref, gen, params)``, if given, runs last
    and its dict joins the phase's line. Each call's MoE host syncs are
    recorded; ``init``'s seconds and peak beside the model's bytes.
    ``teacher``: each slot's greedy tokens also held to a teacher-forced
    full forward under its tenant's pages (the t16 slots up to the swap).
    ``host_syncs``: the MoE host syncs every call must make;
    ``init_slack_gib``: the most ``init``'s peak may exceed the model's
    bytes. Returns each wrapper's launches on the main path, by name."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ops
    from repro_torch.models.layers import moe
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    model = Model(cfg, lora, device=DEV, dtype=dtype, use_kernels=True)
    plain = Model(cfg, lora, device=DEV, dtype=dtype, use_kernels=False)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    init = {"seconds": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "param_gib": sum(t.nbytes for t in _leaves(params)) / 2**30}
    init["over_params_gib"] = init["peak_gib"] - init["param_gib"]
    if init_slack_gib is not None:
        require(init["over_params_gib"] <= init_slack_gib,
                f"{phase}: init peaked {init['over_params_gib']} GiB over "
                f"the model's {init['param_gib']} GiB")
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
    snap0, gen_tok, gen_logits = store.published, [], []
    for step in range(NEW_TOKENS):
        if step == 9:             # the round landing after 8 decode steps
            store.put("t16", _tenant_tree(torch, params, gen, DEV), 16)
            store.publish()
        before = [k.launches for k, _, _ in kernels]
        syncs, k4_bf16 = (moe.moe_apply.host_syncs,
                          la.batched_lora_apply.launches_bf16)
        if step == 0:
            call, args = (lambda e: e.admit), (range(SLOTS), prompts,
                                               slot_tenants)
        else:
            call, args = (lambda e: e.decode), (active,)
        _, ms = timed(call(eng), *args)
        grew = [k.launches - n for (k, _, _), n in zip(kernels, before)]
        moe_syncs = moe.moe_apply.host_syncs - syncs
        grew_bf16 = la.batched_lora_apply.launches_bf16 - k4_bf16
        if teacher:
            gen_tok.append(eng.tokens.clone())
            gen_logits.append(eng.last_logits.clone())
        _, ms_plain = timed(call(ref), *args)
        for (k, admit, dec), n, g in zip(kernels, before, grew):
            want = admit if step == 0 else dec
            require(g == want and k.launches - n == want,
                    f"{phase} step {step}: {k.__name__} launched {g} "
                    f"times, expected {want}")
        require(host_syncs is None or moe_syncs == host_syncs,
                f"{phase} step {step}: {moe_syncs} MoE host syncs, "
                f"expected {host_syncs}")
        for (k, _, _), g in zip(kernels, grew):
            if bf16 and k is la.batched_lora_apply:
                require(grew_bf16 == g, f"{phase} step {step}: {g} K4 "
                        f"launches, {grew_bf16} of them bf16")
        row = {"step": step, "ms": ms, "plain_ms": ms_plain,
               "host_syncs": moe_syncs,
               "launches": {k.__name__: g
                            for (k, _, _), g in zip(kernels, grew)}}
        if diverged is None:     # after a flip the streams differ
            rule = _top2_rule(torch, f"{phase} step {step}",
                              eng.last_logits, ref.last_logits)
            row["logits_max_abs_diff"] = rule["logits_max_abs_diff"]
            if rule["flips"]:
                diverged = {"step": step, **rule["flips"][0]}
            else:
                compared += 1
        steps.append(row)
    # read just after the main path
    launches = {k.__name__: k.launches for k, _, _ in kernels}
    if bf16:
        launches["batched_lora_apply_bf16"] = \
            la.batched_lora_apply.launches_bf16
    want_log = [1] * 9 + [2] * (NEW_TOKENS - 9)
    require(eng.version_log == want_log and ref.version_log == want_log,
            f"{phase}: version logs {eng.version_log} / {ref.version_log},"
            f" expected {want_log}")
    require(bool(torch.isfinite(eng.last_logits).all()),
            f"{phase}: non-finite logits")
    for k, admit, dec in kernels:
        want = admit + dec * (NEW_TOKENS - 1)
        require(launches[k.__name__] == want,
                f"{phase}: {k.__name__} launched {launches[k.__name__]} "
                f"times, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    checks = []
    if teacher:
        for slot, tenant in enumerate(slot_tenants):
            toks = torch.stack([t[slot] for t in gen_tok])
            lg = torch.stack([t[slot] for t in gen_logits]).float()
            snap, n = store.published, len(toks)
            if tenant == "t16":       # its pages changed at the swap
                snap, n = snap0, 9
            checks.append({"slot": slot, "tenant": tenant,
                           **_teacher_forced(torch, eng, snap, tenant,
                                             prompts[slot], toks[:n],
                                             lg[:n], phase)})
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
    extra = {} if after is None else after(eng, ref, gen, params)

    dec = [r["ms"] for r in steps[1:]]
    dec_plain = [r["plain_ms"] for r in steps[1:]]
    dec_ms = sum(dec) / len(dec)
    emit({"phase": phase, "params": n_params, "dtype": str(dtype),
          "layers": cfg.num_layers, "init": init, "setup_s": setup_s,
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
          "kernels": [k.__name__ for k, _, _ in kernels],
          "launches_per_admit": {k.__name__: a for k, a, _ in kernels},
          "launches_per_decode": {k.__name__: d for k, _, d in kernels},
          "launches": launches,
          "host_syncs_per_call": sorted({r["host_syncs"] for r in steps}),
          "teacher_forced": checks,
          "profiled_decode": prof_decode, "profiled_prefill": prof_prefill,
          "profiled_prefill_plain": prof_prefill_plain, **extra,
          "steps": steps, "card": card_line()})
    return launches


def phase_serve_qwen2_7b(torch) -> dict:
    """Main path 2: Qwen2-7B, 32-token prompts, K4 on every q/k/v/o
    projection (4 x 28 launches per engine call); then main path 15, the
    continuous batcher on the same model and weights before they are
    freed (``phase_serve_batcher_qwen2_7b``). Returns K4's launches on
    each path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = get_config("qwen2-7b")
    per_call = 4 * cfg.num_layers
    batcher = {}

    def after(eng, ref, gen, params):
        batcher.update(phase_serve_batcher_qwen2_7b(torch, eng.model, params,
                                                    gen, per_call))
        phase_serve_nan_tenant_qwen2_7b(torch, eng, params, gen, per_call)
        return {}

    served = _serve_full(torch, "serve_qwen2_7b", cfg, PROMPT_LEN,
                         [(la.batched_lora_apply, per_call, per_call)],
                         "lora_", after=after)["batched_lora_apply"]
    return {"serve_qwen2_7b": served, **batcher}


def phase_serve_nan_tenant_qwen2_7b(torch, eng, params, gen,
                                    per_call: int) -> None:
    """Main path 2's K4 engine (Qwen2-7B at full width in f32) with one
    tenant poisoned: t8 republished with fresh factors, then with a NaN at
    [0, 0, 0] of its first ``lora_b`` leaf; on each snapshot, admit (4
    slots over t16/t8/t4/t16, fresh 32-token prompts) plus two decode
    steps. Required: the card synchronizes after every step (a token
    past the vocabulary would have fired a device assert there), every
    token is in [0, V), the clean slots' tokens equal the clean run's,
    the poisoned slot's logits hold a NaN and its token is ``np.argmax``
    (the first NaN) of its logits on the host, and K4 launches 4 x 28
    times a call. Then t8 clean again and slot 1's prompt holding V and
    -V - 1 (the reference's ``jnp.take`` gives their rows NaN): slot 1's
    logits all NaN and its token 0 at every step, the other slots' tokens
    the clean run's, with no device assert."""
    import numpy as np
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.kernels import lora_apply as la
    v = eng.model.cfg.vocab_size
    flat = flatten(_tenant_tree(torch, params, gen, DEV))
    path = next(p for p in flat if p[-1] == "lora_b")
    poisoned = dict(flat)
    poisoned[path] = flat[path].clone()
    poisoned[path][(0,) * flat[path].ndim] = NAN
    prompts = torch.randint(0, v, (SLOTS, PROMPT_LEN), generator=gen,
                            device=DEV)
    tenants = ["t16", "t8", "t4", "t16"]
    active = torch.ones(SLOTS, dtype=torch.bool, device=DEV)
    bad_prompts = prompts.clone()
    bad_prompts[NAN_SLOT, [5, 20]] = torch.tensor([v, -v - 1], device=DEV)
    runs = {}
    for label, tree, ask in (("clean", flat, prompts),
                             ("nan", poisoned, prompts),
                             ("bad_token", flat, bad_prompts)):
        eng.store.put("t8", unflatten(tree), 8)
        eng.store.publish()
        toks, logits, launches, ms = [], [], [], []
        for step in range(NAN_STEPS):
            n, t = la.batched_lora_apply.launches, time.perf_counter()
            if step == 0:
                eng.admit(range(SLOTS), ask, tenants)
            else:
                eng.decode(active)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            launches.append(la.batched_lora_apply.launches - n)
            toks.append(eng.tokens.cpu().numpy())
            logits.append(eng.last_logits.float().cpu().numpy())
        runs[label] = (np.stack(toks), np.stack(logits), launches, ms)
    (ct, _, cl, cms), (nt, nl, nlaunch, nms) = runs["clean"], runs["nan"]
    bt, bl, blaunch, bms = runs["bad_token"]
    clean = [s for s in range(SLOTS) if s != NAN_SLOT]
    first_nan = np.argmax(nl[:, NAN_SLOT], axis=-1)
    emit({"phase": "serve_nan_tenant_qwen2_7b", "vocab": v,
          "poisoned": {"tenant": "t8", "slot": NAN_SLOT,
                       "leaf": "/".join(map(str, path))},
          "tokens_clean": ct.tolist(), "tokens_nan": nt.tolist(),
          "nan_slot_logits_nan_share": float(
              np.isnan(nl[:, NAN_SLOT]).mean()),
          "k4_launches": {"clean": cl, "nan": nlaunch,
                          "bad_token": blaunch},
          "step_ms": {"clean": cms, "nan": nms, "bad_token": bms},
          "bad_token": {"slot": NAN_SLOT, "ids": [v, -v - 1],
                        "positions": [5, 20], "tokens": bt.tolist(),
                        "slot_logits_nan_share": float(
                            np.isnan(bl[:, NAN_SLOT]).mean())},
          "synchronized": True, "card": card_line()})
    require(np.array_equal(bt[:, clean], ct[:, clean])
            and (bt[:, NAN_SLOT] == 0).all()
            and bool(np.isnan(bl[:, NAN_SLOT]).all())
            and not np.isnan(bl[:, clean]).any(),
            f"serve_nan_tenant: a prompt holding {v} and {-v - 1} in slot "
            f"{NAN_SLOT}: tokens {bt.tolist()} against the clean run's "
            f"{ct.tolist()}")
    require(blaunch == [per_call] * NAN_STEPS,
            f"serve_nan_tenant: K4 launched {blaunch} with the bad token")
    require(((nt >= 0) & (nt < v)).all() and ((ct >= 0) & (ct < v)).all(),
            f"serve_nan_tenant: a token outside [0, {v}): {nt.tolist()}")
    require(np.array_equal(nt[:, clean], ct[:, clean]),
            f"serve_nan_tenant: the clean slots' tokens moved: "
            f"{ct.tolist()} -> {nt.tolist()}")
    require(bool(np.isnan(nl[:, NAN_SLOT]).any(axis=-1).all())
            and not np.isnan(nl[:, clean]).any(),
            "serve_nan_tenant: the NaN did not stay in its slot's logits")
    require(np.array_equal(nt[:, NAN_SLOT], first_nan),
            f"serve_nan_tenant: the poisoned slot's tokens "
            f"{nt[:, NAN_SLOT].tolist()}, its logits' first NaN "
            f"{first_nan.tolist()}")
    require(cl == nlaunch == [per_call] * NAN_STEPS,
            f"serve_nan_tenant: K4 launched {cl} / {nlaunch}, expected "
            f"{per_call} a call")


# main path 15: the continuous batcher over the Qwen2-7B engine
BATCH_REQUESTS = 10        # requests of PROMPT_LEN tokens, NEW_TOKENS each
BATCH_ARRIVAL = 0.02       # virtual seconds between arrivals
BATCH_SWAP_AFTER = 8       # scheduler steps before the hot swap of run (b)
BATCH_ISOLATED = (0, 4, 8, 9)   # requests held to an isolated engine


class _StubEngine:
    """A host engine of ``slots`` slots whose tokens are all 0: the
    batcher's virtual time depends only on arrivals, latency draws and
    lengths, so its stats replay without the model."""

    def __init__(self, slots: int):
        self.slots = slots

    def admit(self, slot_idx, prompts, adapter_ids):
        return [0] * len(list(slot_idx))

    def decode(self, active_mask):
        return [0] * self.slots


def phase_serve_batcher_qwen2_7b(torch, model, params, gen,
                                 per_call: int) -> dict:
    """Main path 15: ``ContinuousBatcher`` over a 4-slot ``ServingEngine``
    on Qwen2-7B at full width in f32 (the model and weights of
    serve_qwen2_7b, K4 on q/k/v/o): 10 requests of 32-token prompts and 16
    new tokens over 3 tenants at ranks 16/8/4 (cycled), arrivals at 0.02 i
    virtual s, lognormal(0.02, 0.25) latency draws, step and prefill costs
    0.01 / 0.05. (a) No swap: all 10 complete, and requests 0, 4, 8 and 9
    give the tokens of an isolated engine (4 slots, slot 0) on the card.
    (b) Tenant t16 republished after 8 scheduler steps: one version per
    engine call, both seen, none old after the publish. (c) Both runs'
    ``stats()`` bit-equal to the same scenario over a host stub engine.
    (d) K4 launches 4 x 28 times in every engine call (the main path's
    count: run (a), reset just before and read just after). Steps, the
    virtual p50 / p95 / TTFT, wall ms per step (context only), peak
    GiB."""
    import numpy as np
    from repro_torch.federation.events import LognormalLatency
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ops
    from repro_torch.serving import (AdapterStore, ContinuousBatcher,
                                     ServeRequest, ServingEngine)
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    store = AdapterStore((4, 8, 16))
    tenants = ("t16", "t8", "t4")
    for name, rank in zip(tenants, (16, 8, 4)):
        store.put(name, _tenant_tree(torch, params, gen, DEV), rank)
    store.publish()
    prompts = torch.randint(0, cfg.vocab_size,
                            (BATCH_REQUESTS, PROMPT_LEN), generator=gen,
                            device=DEV)
    max_len = PROMPT_LEN + NEW_TOKENS

    def requests():
        return [ServeRequest(rid=i, prompt=prompts[i],
                             adapter_id=tenants[i % len(tenants)],
                             max_new_tokens=NEW_TOKENS,
                             arrival=BATCH_ARRIVAL * i)
                for i in range(BATCH_REQUESTS)]

    def run(engine, swap: bool):
        """The scenario over ``engine``; each engine call's K4 launches
        and the scheduler steps' wall ms."""
        batcher = ContinuousBatcher(
            engine, latency=LognormalLatency(0.02, 0.25, seed=0),
            step_cost=0.01, prefill_cost=0.05)
        for r in requests():
            batcher.submit(r)
        calls = []
        for kind in ("admit", "decode"):
            inner = getattr(engine, kind)

            def logged(*a, _inner=inner, **k):
                before = la.batched_lora_apply.launches
                out = _inner(*a, **k)
                calls.append(la.batched_lora_apply.launches - before)
                return out
            setattr(engine, kind, logged)
        step_ms, publish_at = [], None
        while batcher.queue or any(batcher.slots):
            if swap and batcher.steps == BATCH_SWAP_AFTER:
                store.put("t16", _tenant_tree(torch, params, gen, DEV), 16)
                store.publish()
                publish_at = len(calls)
            if batcher.queue and not any(batcher.slots) \
                    and batcher.queue[0].arrival > batcher.clock.now:
                batcher.clock.advance(batcher.queue[0].arrival)
            torch.cuda.synchronize()
            t = time.perf_counter()
            batcher.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        return batcher, calls, step_ms, publish_at

    eng = ServingEngine(model, params, store, max_len=max_len, slots=SLOTS)
    ops.reset_launches()          # main path 15's count starts here
    ba, calls_a, ms_a, _ = run(eng, swap=False)
    launches = la.batched_lora_apply.launches    # read just after
    stats_a = ba.stats()
    require(stats_a["completed"] == BATCH_REQUESTS and not ba.queue,
            f"serve_batcher_qwen2_7b: {stats_a['completed']} of "
            f"{BATCH_REQUESTS} requests completed")
    require(all(len(r.tokens) == NEW_TOKENS for r in ba.done),
            "serve_batcher_qwen2_7b: a request's length is off")
    require(len(calls_a) == len(eng.version_log)
            and all(n == per_call for n in calls_a)
            and launches == per_call * len(calls_a),
            f"serve_batcher_qwen2_7b: K4 launched {calls_a} per engine "
            f"call ({launches} in all), expected {per_call} each")
    # (a) requests against an isolated engine, slot 0 of 4
    done = {r.rid: r for r in ba.done}
    mask = np.zeros(SLOTS, bool)
    mask[0] = True
    isolated = {}
    for rid in BATCH_ISOLATED:
        req = done[rid]
        iso = ServingEngine(model, params, store, max_len=max_len,
                            slots=SLOTS)
        toks = [int(iso.admit([0], prompts[rid][None],
                              [req.adapter_id])[0])]
        for _ in range(NEW_TOKENS - 1):
            toks.append(int(iso.decode(mask)[0]))
        isolated[rid] = toks == req.tokens
        require(isolated[rid], f"serve_batcher_qwen2_7b: request {rid} "
                               f"gave {req.tokens} batched and {toks} alone")
    # (b) one hot swap after BATCH_SWAP_AFTER steps
    eng_b = ServingEngine(model, params, store, max_len=max_len,
                          slots=SLOTS)
    bb, calls_b, ms_b, publish_at = run(eng_b, swap=True)
    log = eng_b.version_log
    old, new = log[0], store.published.version
    require(publish_at is not None and len(log) == len(calls_b)
            and log == [old] * publish_at + [new] * (len(log) - publish_at)
            and 0 < publish_at < len(log),
            f"serve_batcher_qwen2_7b: version log {log}, publish before "
            f"call {publish_at}")
    require(all(n == per_call for n in calls_b),
            f"serve_batcher_qwen2_7b: K4 launched {calls_b} per call of "
            f"the swap run")
    stats_b = bb.stats()
    # (c) the stats replayed over a host stub engine
    for label, stats in (("no swap", stats_a), ("swap", stats_b)):
        stub = ContinuousBatcher(
            _StubEngine(SLOTS), latency=LognormalLatency(0.02, 0.25, seed=0),
            step_cost=0.01, prefill_cost=0.05)
        for r in requests():
            stub.submit(r)
        stub.run()
        require(stub.stats() == stats,
                f"serve_batcher_qwen2_7b ({label}): stats {stats} against "
                f"the stub's {stub.stats()}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "serve_batcher_qwen2_7b", "model": cfg.name,
          "slots": SLOTS, "requests": BATCH_REQUESTS,
          "prompt_len": PROMPT_LEN, "new_tokens": NEW_TOKENS,
          "steps": int(stats_a["steps"]), "engine_calls": len(calls_a),
          "k4_launches": launches, "k4_launches_per_call": per_call,
          "virtual_p50_s": stats_a["virtual_p50_s"],
          "virtual_p95_s": stats_a["virtual_p95_s"],
          "virtual_ttft_p50_s": stats_a["virtual_ttft_p50_s"],
          "virtual_throughput_tok_per_s":
              stats_a["virtual_throughput_tok_per_s"],
          "stats": stats_a, "stats_equal_stub": True,
          "wall_ms_per_step_context_only": sum(ms_a) / len(ms_a),
          "wall_ms_per_step_swap_run": sum(ms_b) / len(ms_b),
          "isolated_equal": isolated,
          "swap": {"publish_before_call": publish_at, "calls": len(log),
                   "versions": sorted(set(log))},
          "peak_mem_gib": peak, "card": card_line()})
    return {"serve_batcher_qwen2_7b": launches}


def phase_serve_mamba2_1p3b(torch) -> int:
    """Main path 3: Mamba-2 1.3B, 1024-token prompts (4 chunks of 256),
    K6 on every layer's prefill scan (48 calls per admit, none per decode
    step: decode runs the one-token recurrence). The profiled prefill's
    K6 share sums the four kernels, all named ssd_scan_*."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("mamba2-1.3b")
    return _serve_full(torch, "serve_mamba2_1p3b", cfg, MAMBA_PROMPT,
                       [(k6.ssd_scan, cfg.num_layers, 0)],
                       "ssd_scan")["ssd_scan"]


def phase_serve_gemma_2b(torch) -> int:
    """Main path 10: Gemma-2B (18 layers, d 2048, MQA 8/1 at head_dim 256,
    GeGLU, vocab 256000, tied head, embeddings scaled by sqrt(d)),
    32-token prompts, K4 on every q/k/v/o projection (4 x 18 launches per
    engine call; k/v at N 256)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = get_config("gemma-2b")
    per_call = 4 * cfg.num_layers
    return _serve_full(torch, "serve_gemma_2b", cfg, PROMPT_LEN,
                       [(la.batched_lora_apply, per_call, per_call)],
                       "lora_")["batched_lora_apply"]


def phase_serve_hymba_1p5b(torch) -> dict:
    """Main path 11: Hymba-1.5B (32 layers, d 1600, GQA 25/5, window 1024
    with layers 0 and 16 global, 64 SSD heads of P 50 beside attention in
    every layer), 2048-token prompts, so the window bites in the 30
    windowed layers at prefill and at decode and the SSD heads' scan runs
    16 chunks of 128: K4 on q/k/v/o (4 x 32 launches per engine call) and
    K6 on the SSD heads (32 calls per admit, none per decode step, which
    runs the one-token recurrence). The SSD projections take the plain
    per-slot path, as in the reference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ssd_scan as k6
    cfg = get_config("hymba-1.5b")
    return _serve_full(torch, "serve_hymba_1p5b", cfg, HYMBA_PROMPT,
                       [(la.batched_lora_apply, 4 * cfg.num_layers,
                         4 * cfg.num_layers),
                        (k6.ssd_scan, cfg.num_layers, 0)],
                       ("lora_", "ssd_scan"))


def _vl_positions(torch, grid: int, text: int):
    """Qwen2-VL's three position streams (temporal, height, width) for a
    ``grid`` x ``grid`` image followed by ``text`` tokens: patch (r, c)
    at (0, r, c), text token i at grid + i on all three: (3, grid^2 +
    text) int32."""
    rc = torch.arange(grid * grid, dtype=torch.int32, device=DEV)
    txt = grid + torch.arange(text, dtype=torch.int32, device=DEV)
    return torch.stack([torch.cat([torch.zeros_like(rc), txt]),
                        torch.cat([rc // grid, txt]),
                        torch.cat([rc % grid, txt])])


def phase_serve_qwen2_vl_7b(torch) -> int:
    """Main path 12: Qwen2-VL-7B (28 layers, d 3584, GQA 28/4, qkv bias,
    M-RoPE sections (16, 24, 24), vision frontend stub), 32-token prompts,
    K4 on every q/k/v/o projection (4 x 28 launches per engine call). Then
    one image prefill, kernel model against plain model on the card: 4
    slots of 16 x 16 patch embeddings and 32 tokens at Qwen2-VL's position
    streams (``_vl_positions``), each slot through its tenant's pages;
    the last position's logits by the top-2-gap rule, and unlike those of
    the same prefill with the three streams equal (the sections are
    live)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    from repro_torch.serving.engine import _gather
    cfg = get_config("qwen2-vl-7b")
    per_call = 4 * cfg.num_layers

    def image_prefill(eng, ref, gen, params):
        patches, text = VL_GRID * VL_GRID, PROMPT_LEN
        embeds = torch.randn(SLOTS, 1, patches, cfg.frontend.embed_dim,
                             generator=gen, device=DEV)
        tokens = torch.randint(0, cfg.vocab_size, (SLOTS, 1, text),
                               generator=gen, device=DEV)
        pos = _vl_positions(torch, VL_GRID, text)
        lora_c = _gather(eng.store.published.pages, eng.slot_pages)
        scales = torch.ones(SLOTS, device=DEV)

        def run(e, positions):
            batch = {"embeds": embeds, "tokens": tokens,
                     "positions": positions[:, None, None].expand(
                         3, SLOTS, 1, patches + text)}
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                logits = e.model.prefill_clients(e.base, lora_c, batch,
                                                 scales)[0][:, 0, -1]
            torch.cuda.synchronize()
            return logits, (time.perf_counter() - t) * 1e3

        before = la.batched_lora_apply.launches
        got, ms = run(eng, pos)
        launches = la.batched_lora_apply.launches - before
        want, ms_plain = run(ref, pos)
        require(launches == per_call, f"serve_qwen2_vl_7b image prefill: "
                                      f"K4 launched {launches} times, "
                                      f"expected {per_call}")
        require(bool(torch.isfinite(got).all()),
                "serve_qwen2_vl_7b image prefill: non-finite logits")
        rule = _top2_rule(torch, "serve_qwen2_vl_7b image prefill", got, want)
        flat = torch.arange(patches + text, dtype=torch.int32,
                            device=DEV).expand(3, -1)
        same, _ = run(eng, flat)
        moved = float((same - got).abs().max())
        require(moved > 1e-3, f"serve_qwen2_vl_7b image prefill: the "
                              f"position streams moved the logits by "
                              f"only {moved}")
        return {"image_prefill": {
            "patches": patches, "text": text, "ms": ms, "plain_ms": ms_plain,
            "launches": launches, **rule,
            "equal_streams_max_abs_diff": moved}}

    return _serve_full(torch, "serve_qwen2_vl_7b", cfg, PROMPT_LEN,
                       [(la.batched_lora_apply, per_call, per_call)],
                       "lora_", after=image_prefill)["batched_lora_apply"]


def phase_serve_small_deepseek_v2(torch):
    """A reduced deepseek-v2 (MLA at a latent of 64, 8 experts top-6 plus
    one shared), 12-token prompts: the card's engine with ``use_kernels``
    and the CPU's plain one give equal tokens, and K4 launches no time
    (MLA's projections and the experts take the plain route, as the
    reference's)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = get_config("deepseek-v2-236b").reduced(max_experts=8)
    _serve_small(torch, "serve_small_deepseek_v2", cfg, 12,
                 {"rtol": 1e-4, "atol": 1e-5}, {la.batched_lora_apply: 0})


def _teacher_forced(torch, eng, snap, tenant, prompt, tokens, logits,
                    phase="serve_deepseek_v2"):
    """A slot's greedy ``tokens`` (and the engine's logits (n, V) that
    chose them) against one full ``prefill_clients`` forward of its
    prompt and tokens under ``tenant``'s pages of ``snap``: each token the
    forward's greedy choice at its position, or, by ``_top2_rule``, where
    the forward's top-2 gap is within twice the logits' difference."""
    from repro_torch.serving.engine import _gather
    seq = torch.cat([prompt.to(torch.int32),
                     tokens[:-1].to(torch.int32)])[None, None]
    pages = _gather(snap.pages, snap.page_ids([tenant]))
    with torch.no_grad():
        full = eng.model.prefill_clients(
            eng.base, pages, {"tokens": seq},
            torch.ones(1, device=DEV))[0][0, 0]
    want = full[prompt.numel() - 1:].float()
    rule = _top2_rule(torch, f"{phase} {tenant}", logits.float(), want)
    return {"tokens": len(tokens), **rule}


def phase_serve_deepseek_v2(torch) -> dict:
    """Main path 13: DeepSeek-V2 at full width in f32 with 2 of its 60
    layers (MLA: q_lora 1536, kv_lora 512, 128 heads of 128 + 64 rope; 160
    routed experts top-6 and 2 shared in both layers), ``launch/serve.py``'s
    shape with ragged slots: slots 0-2 admit 32-token prompts (tenants at
    ranks 16/8/4 on q_a, kv_a and o) and decode 3 steps alone, then slot 3
    admits a 20-token prompt (rank 8), so the per-slot lengths differ as
    all four decode together; 16 new tokens on slots 0-2, 13 on slot 3,
    with a hot swap of tenant t4 after 8 decode steps. Checks: the cache
    holds only the latents {"ckv", "krope"}; each call runs one snapshot
    version; K4 launches no time (MLA takes the plain route, as in the
    reference); each slot's tokens equal a teacher-forced full forward
    under its tenant's pages (slot 2's up to the swap, after which its
    cache mixes two adapters). Records the calls' ms and host syncs (one
    per MoE layer a call: the expert group sizes), two more prefills,
    one profiled decode step (idle share, top device operations), the
    peak GiB."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.core.lora import flatten
    from repro_torch.kernels import lora_apply as la
    from repro_torch.kernels import ops
    from repro_torch.models.layers import moe
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = _deepseek_cfg()
    mla = cfg.mla
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    model = Model(cfg, lora, device=DEV, use_kernels=True)
    gen = torch.Generator(device=DEV).manual_seed(0)
    params = model.init(gen)
    store = AdapterStore(lora.rank_levels)
    for name, rank in {"t16": 16, "t8": 8, "t4": 4}.items():
        store.put(name, _tenant_tree(torch, params, gen, DEV), rank)
    store.publish()
    full_prompts = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT_LEN),
                                 generator=gen, device=DEV)
    prompts = [full_prompts[i] for i in range(3)] + [
        full_prompts[3, :DS_LATE_PROMPT]]
    tenants = ["t16", "t8", "t4", "t8"]
    max_len = PROMPT_LEN + NEW_TOKENS + 1
    eng = ServingEngine(model, params, store, max_len=max_len, slots=SLOTS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cache = flatten(eng.cache["layers"])
    require(sorted(p[-1] for p in cache) == ["ckv", "krope"],
            f"serve_deepseek_v2: cache leaves {sorted(cache)}")
    latent_bytes = sum(t.shape[-1] * t.element_size() for t in
                       cache.values())
    per_head_bytes = cfg.num_heads * (mla.qk_nope_head_dim
                                      + mla.qk_rope_head_dim
                                      + mla.v_head_dim) * 4

    def timed(fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    first3 = torch.tensor([True] * 3 + [False], device=DEV)
    all4 = torch.ones(SLOTS, dtype=torch.bool, device=DEV)
    calls = ([("admit", ([0, 1, 2], torch.stack(prompts[:3]),
                         tenants[:3]))]
             + [("decode", (first3,))] * DS_LATE_AFTER
             + [("admit", ([3], prompts[3][None], tenants[3:]))]
             + [("decode", (all4,))] * (NEW_TOKENS - 1 - DS_LATE_AFTER))
    ops.reset_launches()          # the main path's count starts here
    rows, decodes, swap_call, snap0 = [], 0, None, store.published
    gen_tok = [[] for _ in range(SLOTS)]
    gen_logits = [[] for _ in range(SLOTS)]
    for i, (kind, args) in enumerate(calls):
        if kind == "decode":
            if decodes == DS_SWAP_AFTER:     # the round landing
                store.put("t4", _tenant_tree(torch, params, gen, DEV), 4)
                store.publish()
                swap_call = i
            decodes += 1
        syncs, k4 = moe.moe_apply.host_syncs, la.batched_lora_apply.launches
        _, ms = timed(getattr(eng, kind), *args)
        row = {"call": i, "kind": kind, "ms": ms,
               "host_syncs": moe.moe_apply.host_syncs - syncs,
               "k4_launches": la.batched_lora_apply.launches - k4,
               "slot_len": eng.slot_len().tolist()}
        rows.append(row)
        slots = args[0] if kind == "admit" else \
            args[0].nonzero().flatten().tolist()
        for slot in slots:
            gen_tok[slot].append(eng.tokens[slot].clone())
            gen_logits[slot].append(eng.last_logits[slot].clone())
    k4_launches = la.batched_lora_apply.launches    # read just after
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_log = [1] * swap_call + [2] * (len(calls) - swap_call)
    require(eng.version_log == want_log,
            f"serve_deepseek_v2: version log {eng.version_log}, expected "
            f"{want_log}")
    require(k4_launches == 0 and all(r["k4_launches"] == 0 for r in rows),
            f"serve_deepseek_v2: K4 launched {k4_launches} times")
    ragged = rows[DS_LATE_AFTER + 2]["slot_len"]
    require(len(set(ragged)) > 1, f"serve_deepseek_v2: slot lengths "
                                  f"{ragged} are not ragged")
    require(bool(torch.isfinite(eng.last_logits).all()),
            "serve_deepseek_v2: non-finite logits")
    checks = []
    for slot in range(SLOTS):
        toks = torch.stack(gen_tok[slot])
        lg = torch.stack(gen_logits[slot])
        snap, n = store.published, len(toks)
        if tenants[slot] == "t4":    # before the swap only
            snap, n = snap0, 1 + DS_SWAP_AFTER
        checks.append({"slot": slot, "tenant": tenants[slot],
                       **_teacher_forced(torch, eng, snap, tenants[slot],
                                         prompts[slot], toks[:n], lg[:n])})
    # the first prefill again, twice (the first call above also paid the
    # engine's first allocations), then one profiled decode step
    warm = [timed(eng.admit, *calls[0][1])[1] for _ in range(2)]
    prof_decode = _profile(torch, lambda: eng.decode(all4),
                           ("gemm", "index", "sort"))
    dec = [r["ms"] for r in rows if r["kind"] == "decode"
           and r["slot_len"][3] > 0]
    dec_ms = sum(dec) / len(dec)
    ep = _deepseek_ep(torch, eng, full_prompts, tenants)
    emit({"phase": "serve_deepseek_v2", "model": cfg.name,
          "layers": f"{cfg.num_layers} of 60",
          "params": sum(t.numel() for t in _leaves(params)),
          "setup_s": setup_s, "prompt_len": PROMPT_LEN,
          "late_prompt_len": DS_LATE_PROMPT,
          "prefill_ms": rows[0]["ms"],
          "late_prefill_ms": rows[DS_LATE_AFTER + 1]["ms"],
          "prefill_warm_ms": warm, "decode_ms_per_step": dec_ms,
          "decode_ms_median": sorted(dec)[len(dec) // 2],
          "tok_per_s": SLOTS / dec_ms * 1e3,
          "host_syncs_per_call": sorted({r["host_syncs"] for r in rows}),
          "cache_leaves": sorted(p[-1] for p in cache),
          "cache_bytes_per_token_layer": latent_bytes,
          "per_head_kv_bytes_per_token_layer": per_head_bytes,
          "peak_mem_gib": peak, "version_log": eng.version_log,
          "k4_launches": k4_launches, "ragged_slot_len": ragged,
          "teacher_forced": checks, "profiled_decode": prof_decode,
          "expert_parallel": ep, "calls": rows, "card": card_line()})
    return {"k4_launches": k4_launches}


EP_TOL = 1e-5              # EP prefill logits against the "tp" path's
EP_NO_OVERFLOW = 16.0      # a capacity factor no expert overflows here
EP_CAPACITY = 1.25         # a capacity factor that drops assignments


def _deepseek_ep(torch, eng, prompts, tenants) -> dict:
    """The expert-parallel dispatch on DeepSeek-V2 at full width (the
    engine's model and weights; ``Model(moe_impl="ep")`` on a world-1
    NCCL ``make_host_mesh``, made here and destroyed): one prefill of the
    4 slots' 32-token prompts under their tenants' pages through the
    "tp" model, the dropless EP model and the capacity dispatch at
    factors 16 (no expert overflows: asserted) and 1.25. The first two EP
    prefills' logits within ``EP_TOL`` of tp's; at 1.25 finite logits,
    the dropped assignments counted, no host sync (none counted, and CUDA's
    sync debug mode set to raise inside every ``moe_apply_ep`` call).
    Then layer 0's MoE input through ``moe_apply`` and through the
    capacity dispatch at 1.25, each profiled once after a warm-up call:
    device ms, wall ms and idle share."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tr
    from repro_torch.models.layers import moe
    from repro_torch.serving.engine import _gather
    cfg = eng.model.cfg
    require(not dist.is_initialized(),
            "serve_deepseek_v2 ep: a process group exists already")
    mesh = make_host_mesh(device=DEV)
    inner_tp, inner_ep = tr.moe_apply, tr.moe_apply_ep
    inner_cap = moe._expert_ffn_capacity
    moe_inputs, groups = [], []

    def capture(p, x, *a, **k):
        moe_inputs.append((p, x))
        return inner_tp(p, x, *a, **k)

    def strict(*a, **k):
        if not k.get("capacity_factor"):
            return inner_ep(*a, **k)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner_ep(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def recording(sorted_tokens, group_sizes, params, activation, capacity):
        groups.append((group_sizes, capacity))
        return inner_cap(sorted_tokens, group_sizes, params, activation,
                         capacity)

    snap = eng.store.published
    pages = _gather(snap.pages, snap.page_ids(tenants))
    batch = {"tokens": prompts[:, None].to(torch.int32)}
    scales = torch.ones(len(tenants), device=DEV)

    def prefill(model):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            out = model.prefill_clients(eng.base, pages, batch, scales)[0]
        torch.cuda.synchronize()
        return out[:, 0], (time.perf_counter() - t) * 1e3

    out = {"mesh": list(mesh.shape), "backend": dist.get_backend(),
           "tokens": prompts.numel(), "tol": EP_TOL}
    tr.moe_apply, tr.moe_apply_ep = capture, strict
    moe._expert_ffn_capacity = recording
    try:
        want, out["tp_ms"] = prefill(eng.model)
        for label, factor in (("dropless", 0.0),
                              ("no_overflow", EP_NO_OVERFLOW),
                              ("capacity", EP_CAPACITY)):
            model = tr.Model(cfg, eng.model.lora, device=DEV,
                             use_kernels=True, moe_impl="ep", mesh=mesh,
                             moe_capacity_factor=factor)
            groups.clear()
            syncs = moe.moe_apply.host_syncs
            got, ms = prefill(model)
            row = {"capacity_factor": factor, "ms": ms,
                   "host_syncs": moe.moe_apply.host_syncs - syncs,
                   "max_abs_diff_vs_tp": float((got - want).abs().max())}
            if factor:
                row["capacity"] = groups[0][1]
                row["largest_group"] = max(int(g.max()) for g, _ in groups)
                row["dropped_assignments"] = sum(
                    int((g - c).clamp(min=0).sum()) for g, c in groups)
                require(row["host_syncs"] == 0 and len(groups) ==
                        cfg.num_layers, f"serve_deepseek_v2 ep {label}: "
                        f"{row['host_syncs']} host syncs, {len(groups)} "
                        f"capacity dispatches")
            out[label] = row
            require(bool(torch.isfinite(got).all()),
                    f"serve_deepseek_v2 ep {label}: non-finite logits")
        for label in ("dropless", "no_overflow"):
            require(out[label]["max_abs_diff_vs_tp"] <= EP_TOL,
                    f"serve_deepseek_v2 ep {label}: logits "
                    f"{out[label]['max_abs_diff_vs_tp']} off tp's")
        require(out["no_overflow"]["dropped_assignments"] == 0,
                f"serve_deepseek_v2 ep: {out['no_overflow']} overflowed")
        require(out["capacity"]["dropped_assignments"] > 0,
                f"serve_deepseek_v2 ep: nothing dropped at {EP_CAPACITY}")
        tr.moe_apply, tr.moe_apply_ep = inner_tp, inner_ep
        moe._expert_ffn_capacity = inner_cap
        # layer 0's MoE input through both dispatches, profiled
        p0, x0 = moe_inputs[0]
        calls = {"moe_apply": lambda: moe.moe_apply(p0, x0, cfg.moe,
                                                    cfg.activation),
                 "moe_apply_ep_capacity": lambda: moe.moe_apply_ep(
                     p0, x0, cfg.moe, cfg.activation, mesh,
                     capacity_factor=EP_CAPACITY)}
        out["moe_layer"] = {}
        with torch.no_grad():
            for name, fn in calls.items():
                fn()
                prof = _profile(torch, fn, ("gemm", "index", "sort"))
                out["moe_layer"][name] = {k: prof[k] for k in (
                    "wall_ms", "device_ms", "device_idle_share",
                    "by_match")}
    finally:
        tr.moe_apply, tr.moe_apply_ep = inner_tp, inner_ep
        moe._expert_ffn_capacity = inner_cap
        dist.destroy_process_group()
    return out


PHASE_SECONDS: dict = {}


# main paths 16 and 17: Llama-4 Maverick at full width in bf16, 2 of its 48
# layers (one layer group: a dense layer and an MoE layer of 128 experts)
LLAMA4_LAYERS = 2
LLAMA4_INIT_SLACK_GIB = 1.0   # init's peak over the model's own bytes
LLAMA4_TRAIN_TOKENS = 2048    # the train step's batch: 1 x 2048 tokens
LLAMA4_TRAIN_RANK = 16
LLAMA4_LOSS_RTOL = 1e-3       # remat against no remat
# the LoRA gradients of remat and no remat, as tests/test_torch_bf16.py
# holds the port's bf16 gradients to the reference's: within this many
# bf16 ulps of each leaf's largest |value|
BF16_GRAD_ULPS = 8


def _llama4_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                               num_layers=LLAMA4_LAYERS)


def phase_serve_llama4_maverick(torch) -> dict:
    """Main path 16: Llama-4 Maverick at full width in bf16 with 2 of its
    48 layers (``sub0`` dense, ``sub1`` MoE: 128 experts top-1 and one
    shared; d 5120, 40 heads and 8 KV heads of 128, vocab 202048): 37.42
    GB of weights, drawn in place (``Model.init``), its peak at most
    ``LLAMA4_INIT_SLACK_GIB`` over the model's bytes. Served as
    ``_serve_full`` serves Qwen2-7B (4 slots of 32-token prompts, 16 new
    tokens, tenants at ranks 16/8/4 on q/k/v/o, a hot swap after 8 decode
    steps), the K4 engine against the plain engine on the same weights:
    K4 8 launches a call (4 projections x 2 layers), every one a bf16
    instance's, one MoE host sync a call, each slot's tokens also held to
    a teacher-forced full forward. Then main path 17 on the same weights
    (``phase_train_step_llama4_maverick``). Returns K4's bf16 launches on
    path 16 and path 17's line."""
    from repro_torch.kernels import lora_apply as la
    cfg = _llama4_cfg()
    train = {}

    def after(eng, ref, gen, params):
        train.update(phase_train_step_llama4_maverick(torch, cfg, params,
                                                      gen))
        return {}

    launches = _serve_full(
        torch, "serve_llama4_maverick", cfg, PROMPT_LEN,
        [(la.batched_lora_apply, 4 * LLAMA4_LAYERS, 4 * LLAMA4_LAYERS)],
        ("lora_", "gemm", "index"), after=after, dtype=torch.bfloat16,
        teacher=True, host_syncs=1, init_slack_gib=LLAMA4_INIT_SLACK_GIB)
    return {"serve_llama4_maverick": launches["batched_lora_apply_bf16"],
            "train": train}


def phase_train_step_llama4_maverick(torch, cfg, params, gen) -> dict:
    """Main path 17: one client step of ``launch.steps.build_train_step``
    (LoRA-only AdamW, f32 gradient accumulation; the reference's step for
    this architecture) on the served weights in bf16, batch 1 x 2048
    ``SequenceCopy`` tokens, LoRA rank 16 on q/k/v/o (lora_b nonzero),
    once with ``remat`` (the layer group run again in the backward) and
    once without. Checks: the losses finite and equal within
    ``LLAMA4_LOSS_RTOL``; the LoRA gradients of the two (the step's own
    ``train_loss`` and ``autograd.grad``, taken again) within
    ``BF16_GRAD_ULPS`` bf16 ulps of each leaf's largest |value|; remat's
    peak the lower; no kernel launched (training runs the plain path).
    Records each run's step ms and peak GiB."""
    from repro_torch.configs import LoRAConfig
    from repro_torch.core.lora import flatten, merge_lora, split_lora, \
        unflatten
    from repro_torch.data import SequenceCopy
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.transformer import Model
    lora = LoRAConfig(rank_levels=(4, 8, LLAMA4_TRAIN_RANK))
    base, _ = split_lora(params)
    adapters = _tenant_tree(torch, params, gen, DEV)
    toks, tgts, _ = SequenceCopy(
        vocab_size=cfg.vocab_size, seq_len=LLAMA4_TRAIN_TOKENS,
        num_families=1, samples_per_family=1, seed=0).generate()
    batch = {"tokens": toks[:1].astype("int32"),
             "targets": tgts[:1].astype("int32")}
    runs = {}
    ops.reset_launches()          # main path 17's count starts here
    # one untimed step first: the first backward of the process pays
    # cuBLAS's and the allocator's set-up
    for remat in (False, True, False):
        model = Model(cfg, lora, device=DEV, dtype=torch.bfloat16,
                      remat=remat)
        step, opt = build_train_step(model, LLAMA4_TRAIN_RANK)
        state = opt.init(adapters)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        new, state, metrics = step(adapters, state, base, batch, 1e-4)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        leaves = {p: x.detach().requires_grad_(True)
                  for p, x in flatten(adapters).items()}
        loss, _ = model.train_loss(
            merge_lora(base, unflatten(leaves)), batch,
            lora_rank=LLAMA4_TRAIN_RANK,
            lora_scale=lora.scaling(LLAMA4_TRAIN_RANK))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        runs[remat] = {"ms": ms, "peak_gib": peak,
                       "loss": float(metrics["loss"]), "grads": grads}
        require(math.isfinite(runs[remat]["loss"]),
                f"train_step_llama4_maverick remat={remat}: loss "
                f"{runs[remat]['loss']}")
        del new, state, leaves, loss, model, step, opt
    launches = {k.__name__: k.launches for k in ops.KERNELS}
    require(not any(launches.values()),
            f"train_step_llama4_maverick: kernels launched {launches}")
    on, off = runs[True], runs[False]
    rel = abs(on["loss"] - off["loss"]) / abs(off["loss"])
    require(rel <= LLAMA4_LOSS_RTOL, f"train_step_llama4_maverick: loss "
            f"{on['loss']} with remat, {off['loss']} without")
    grad_ulps = {}
    for path, g in off["grads"].items():
        ulp = float(_bf16_ulp(torch, g.float().abs().max()))
        grad_ulps["/".join(path)] = float(
            (on["grads"][path].float() - g.float()).abs().max()) / ulp
    worst = max(grad_ulps.values())
    require(worst <= BF16_GRAD_ULPS, f"train_step_llama4_maverick: LoRA "
            f"gradients {worst} bf16 ulps apart with and without remat")
    require(on["peak_gib"] < off["peak_gib"], f"train_step_llama4_maverick:"
            f" remat's peak {on['peak_gib']} GiB not below "
            f"{off['peak_gib']} GiB")
    line = {"phase": "train_step_llama4_maverick", "model": cfg.name,
            "layers": f"{cfg.num_layers} of 48", "dtype": "bfloat16",
            "tokens": LLAMA4_TRAIN_TOKENS, "lora_rank": LLAMA4_TRAIN_RANK,
            **{("remat" if r else "no_remat"): {
                k: v for k, v in run.items() if k != "grads"}
               for r, run in runs.items()},
            "loss_rel_diff": rel, "grad_max_ulps": worst,
            "grad_ulps": grad_ulps, "kernel_launches": launches,
            "card": card_line()}
    emit(line)
    return line


def phase_serve_granite_3_8b(torch) -> int:
    """Main path 18: Granite-3-8B at full depth and width in f32 (40
    layers, d 4096, GQA 32/8 at head_dim 128, SwiGLU of 12800, vocab 49155,
    tied head: 32.75 GB), served as phase 6 serves Qwen2-7B: K4 on every
    q/k/v/o projection, 4 x 40 launches per engine call (k/v at N 1024),
    the tokens equal to the plain engine's on the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import lora_apply as la
    cfg = get_config("granite-3-8b")
    per_call = 4 * cfg.num_layers
    return _serve_full(torch, "serve_granite_3_8b", cfg, PROMPT_LEN,
                       [(la.batched_lora_apply, per_call, per_call)],
                       "lora_")["batched_lora_apply"]


# main path 19: Nemotron-4-340B at full width in bf16, its depth cut to 2
# of 96 layers (32.71 GB: the 256000 x 18432 embedding and untied head
# 18.87 GB, a layer 6.91 GB)
NEMOTRON_LAYERS = 2
NEMOTRON_GRAPH_ITERS = 4      # calls a graph where a W is 2.72 GB


def _nemotron_cfg():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("nemotron-4-340b"),
                               num_layers=NEMOTRON_LAYERS)


def _decode_step_bytes(params) -> int:
    """The bytes one decode step must read of the model: every weight but
    the token embedding (a step gathers 4 of its rows) and the base
    leaves' own adapters (the engine reads its pages instead)."""
    from repro_torch.core.lora import flatten
    return sum(t.nbytes for path, t in flatten(params).items()
               if path[0] != "embed" and path[-1] not in ("lora_a",
                                                          "lora_b"))


def _k4_nemotron(torch, params, gen, summary: dict) -> dict:
    """K4 alone at Nemotron-4-340B's six projections (``NEMOTRON_PROJ``)
    on the served model's own W, one argument set a layer, at 4 rows
    (decode) and 4 x 32 (prefill), through ``_k4_layers``: each held to
    its plain version (one bf16 ulp of its row's largest |value|) and a
    repeat to the first launch bit for bit, timed eagerly and from a
    graph, with its rank-0 time, byte bound, library call and plan, each
    row on one "kernels" line. Returns the layer totals, which also join
    the summary's bf16 row under ``other_layers``."""
    from repro_torch.kernels import lora_apply as la
    where = {"q": ("attn", "q"), "k": ("attn", "k"), "v": ("attn", "v"),
             "o": ("attn", "o"), "up": ("mlp", "up"),
             "down": ("mlp", "down")}
    lay = params["layers"]
    weights = {proj: [lay[a][b]["w"][i] for i in range(NEMOTRON_LAYERS)]
               for proj, (a, b) in where.items()}
    rows = []
    totals = _k4_layers(torch, la, gen, "nemotron-4-340b", NEMOTRON_PROJ,
                        SLOTS * PROMPT_LEN, rows, torch.bfloat16,
                        weights=weights, graph_iters=NEMOTRON_GRAPH_ITERS)
    emit({"phase": "kernels", "kernel": "batched_lora_apply_bf16",
          "model": "nemotron-4-340b", "on": "serve_nemotron_4_340b's W",
          "per_shape": rows, "per_layer": totals, "card": card_line()})
    row = summary.get("batched_lora_apply_bf16")
    if row is not None:
        for key in ("max_abs_err", "max_err_row_ulps"):
            row[key] = max([row[key]] + [t[key] for t in totals.values()])
        row["other_layers"]["nemotron-4-340b"] = {
            phase: {key: t[key] for key in
                    ("ms", "plain_ms", "bound_ms", "bound_route",
                     "bound_simt_f32_ms", "library_ms", "max_abs_err",
                     "max_err_row_ulps", *DEVICE_KEYS, "rank0_device_ms")}
            for phase, t in totals.items()}
    return totals


def phase_serve_nemotron_4_340b(torch, summary: dict) -> int:
    """Main path 19: Nemotron-4-340B at full width in bf16 with 2 of its
    96 layers (d 18432, GQA 96/8 at head_dim 192, squared-ReLU MLP of
    73728, vocab 256000, untied head; LoRA on q/k/v/o/up/down): 32.71 GB
    drawn in place (``Model.init``), its peak at most
    ``LLAMA4_INIT_SLACK_GIB`` over the model's bytes. Served as
    ``_serve_full`` serves Llama-4 (path 16): K4 on q/k/v/o, 4 x 2
    launches a call, every one a bf16 instance's; the MLP's up and down
    adapters take the plain per-slot path, as the reference's
    ``mlp_apply`` does (it passes no ``use_kernel``); each slot's tokens
    by the top-2 rule and against a teacher-forced full forward. A decode
    step reads the layers' W and the head, ``_decode_step_bytes``, whose
    time at the card's byte rate stands beside the profiled step's device
    time. Then K4 alone at all six projections on the same weights
    (``_k4_nemotron``). Returns K4's bf16 launches on the path."""
    from repro_torch.kernels import lora_apply as la
    cfg = _nemotron_cfg()
    per_call = 4 * NEMOTRON_LAYERS

    def after(eng, ref, gen, params):
        nbytes = _decode_step_bytes(params)
        return {"decode_step_bytes": nbytes,
                "decode_step_byte_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "k4_alone_per_layer": _k4_nemotron(torch, params, gen,
                                                   summary)}

    launches = _serve_full(
        torch, "serve_nemotron_4_340b", cfg, PROMPT_LEN,
        [(la.batched_lora_apply, per_call, per_call)],
        ("lora_", "gemm", "nvjet"), after=after, dtype=torch.bfloat16,
        teacher=True, init_slack_gib=LLAMA4_INIT_SLACK_GIB)
    return launches["batched_lora_apply_bf16"]


def _time_phases() -> None:
    """Wrap every ``phase_*`` function of this module so that main's run
    adds each call's wall seconds to ``PHASE_SECONDS`` under its name (a
    child phase's seconds include its process)."""
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            def timed(*a, _fn=fn, _name=name, **k):
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    PHASE_SECONDS[_name] = (PHASE_SECONDS.get(_name, 0.0)
                                            + time.perf_counter() - t)
            globals()[name] = timed


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
    for flag, child in (("--round-methods", phase_round_methods),
                        ("--paper-benches", phase_paper_benches),
                        ("--round-sharded", phase_round_sharded),
                        ("--round-paper-lms", phase_round_paper_lms),
                        ("--round-deepseek-v2", phase_round_deepseek_v2)):
        if flag in sys.argv[1:]:          # a phase's child process
            try:
                child(torch)
            except SmokeFailure as e:
                print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
                return 1
            return 0
    summary: dict = {}
    t_start = time.perf_counter()
    _time_phases()
    try:
        phase_build()
        phase_non_finite(torch)
        phase_kernels(torch, summary)
        phase_kernel_lora_apply(torch, summary)
        phase_kernel_ssd_scan(torch, summary)
        by_path = {k: {"kernel_ops": n}
                   for k, n in phase_kernel_ops(torch, summary).items()}
        phase_round_small(torch)
        launches, server = phase_round_vit_base(torch)
        for k, n in launches.items():
            by_path[k] = {"round_vit_base": n}
        if "--profile" in sys.argv[1:]:
            phase_profile(torch, server)
        del server                # free the round before the other methods
        gc.collect()
        torch.cuda.empty_cache()
        phase_audit(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase_round_methods_child()
        for path, phase in (("round_async_vit_base",
                             phase_round_async_vit_base),
                            ("round_event_vit_base",
                             phase_round_event_vit_base)):
            for k, n in phase(torch, summary).items():
                by_path[k][path] = n
        phase_straggler_contrast(torch)
        for k, n in phase_train_launcher(torch, summary).items():
            by_path[k]["train_launcher"] = n
        benches = phase_paper_benches_child()
        for bench, counts in benches["launches_by_bench"].items():
            for k, n in counts.items():
                by_path.setdefault(k, {})[bench] = n
        for k, err in benches["max_abs_err"].items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], err)
        sharded = phase_round_sharded_child()
        for k, n in sharded["path_launches"].items():
            by_path[k]["round_sharded_vit_base"] = n
        for k, err in sharded["max_abs_err"].items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], err)
        for k, n in phase_round_variants_vit_base(torch, summary).items():
            by_path[k]["round_variants_vit_base"] = n
        lms = phase_round_paper_lms_child()
        for k, n in lms["path_launches"].items():
            by_path[k]["round_paper_lms"] = n
        for k, err in lms["max_abs_err"].items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], err)
        phase_serve_small(torch)
        k4_paths = by_path["batched_lora_apply"] = {}
        # each full model is freed before the next (Qwen2-7B and
        # Qwen2-VL-7B hold 30.5 GB of f32 weights each)
        k4_paths.update(phase_serve_qwen2_7b(torch))
        gc.collect()
        torch.cuda.empty_cache()
        for path, phase in (("serve_qwen2_vl_7b", phase_serve_qwen2_vl_7b),
                            ("serve_gemma_2b", phase_serve_gemma_2b)):
            k4_paths[path] = phase(torch)
            gc.collect()
            torch.cuda.empty_cache()
        phase_serve_small_mamba2(torch)
        by_path["ssd_scan"]["serve_mamba2_1p3b"] = \
            phase_serve_mamba2_1p3b(torch)
        gc.collect()
        torch.cuda.empty_cache()
        phase_serve_small_hymba(torch)
        hymba = phase_serve_hymba_1p5b(torch)
        k4_paths["serve_hymba_1p5b"] = hymba["batched_lora_apply"]
        by_path["ssd_scan"]["serve_hymba_1p5b"] = hymba["ssd_scan"]
        gc.collect()
        torch.cuda.empty_cache()
        # DeepSeek-V2 served, freed, then trained in a child process
        phase_serve_small_deepseek_v2(torch)
        phase_serve_deepseek_v2(torch)
        gc.collect()
        torch.cuda.empty_cache()
        deepseek = phase_round_deepseek_v2_child()
        for k, n in deepseek["path_launches"].items():
            by_path[k]["round_deepseek_v2"] = n
        for k, err in deepseek["max_abs_err"].items():
            summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], err)
        gc.collect()
        torch.cuda.empty_cache()
        # Llama-4 Maverick served, then trained a step, on one set of
        # bf16 weights (everything before it freed)
        llama4 = phase_serve_llama4_maverick(torch)
        by_path["batched_lora_apply_bf16"] = {
            "serve_llama4_maverick": llama4["serve_llama4_maverick"]}
        gc.collect()
        torch.cuda.empty_cache()
        # Granite-3-8B at full depth in f32, freed, then Nemotron-4-340B
        # in bf16 at 2 of its 96 layers
        k4_paths["serve_granite_3_8b"] = phase_serve_granite_3_8b(torch)
        gc.collect()
        torch.cuda.empty_cache()
        by_path["batched_lora_apply_bf16"]["serve_nemotron_4_340b"] = \
            phase_serve_nemotron_4_340b(torch, summary)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    kernels = []
    for name, s in summary.items():
        paths = by_path.get(name, {})
        if sorted(paths) != sorted(PATHS[name].split(", ")) or \
                not all(paths.values()):
            print(f"chip_smoke: FAIL: {name} launched {paths} on its "
                  f"paths ({PATHS[name]})", file=sys.stderr)
            return 1
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "path": PATHS[name],
                        "launches": sum(paths.values()),
                        "launches_by_path": paths,
                        "runs_on": RUNS_ON[name], **s})
    emit({"phase": "script_seconds", "by_phase": PHASE_SECONDS,
          "total": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
