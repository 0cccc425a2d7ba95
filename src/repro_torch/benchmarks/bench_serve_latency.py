"""Multi-tenant serving latency study (a copy of
``benchmarks/bench_serve_latency.py``, DESIGN.md §11).

Runs the continuous-batching serving stack -- ``AdapterStore`` (paged,
rank-bucketed, versioned) + ``ServingEngine`` (fixed slots, per-slot
adapters gathered from the pages) + ``ContinuousBatcher`` (admit/evict on
the federation stack's ``VirtualClock``) -- over a grid of

    batch (slots)      x  adapter count (tenants, cycled rank levels)
                       x  swap rate (hot-swap a new adapter version every
                          N scheduler steps; 0 = never)

and records DETERMINISTIC virtual-time serving metrics per cell: token
throughput, request-latency p50/p95, and time-to-first-token p50. Virtual
timing replays bit for bit for a fixed scenario (seeded per-tenant
latency streams, fixed arrivals), and equals the JAX study's at the same
grid point; wall-clock per cell is recorded as CONTEXT only.

Hot-swap cells exercise the round-landing path mid-stream: every
``swap_every`` steps a perturbed adapter set is published under a bumped
version while requests are in flight, so the engine's snapshot-per-call
discipline (no version mixing within a call) is on the measured path.

Artifact: ``build/bench_torch/serve_latency.json`` (the JAX package's
``BENCH_serve_latency.json`` and ``benchmarks/artifacts/`` are never
written).

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_serve_latency \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import emit, merge_artifact, sync

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ARTIFACT = os.path.join(ROOT, "build", "bench_torch", "serve_latency.json")

ARCH = "gemma-2b"
PROMPT_LEN = 8
MAX_NEW = 6
RANK_LEVELS = (4, 8, 16)


def _build_model(device=None):
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.models.transformer import Model
    cfg = get_config(ARCH).reduced()
    lora = LoRAConfig(rank_levels=RANK_LEVELS)
    model = Model(cfg, lora, device=device, dtype=torch.float32,
                  remat=False)
    return cfg, lora, model


def _stage(store, lora_tree, n_adapters: int, *, version_salt: int = 0):
    """(Re)stage ``n_adapters`` tenants, one rank level each (cycled),
    deterministically perturbed by tenant index and ``version_salt``."""
    from repro_torch.core.lora import flatten, unflatten
    levels = sorted(RANK_LEVELS, reverse=True)
    for t in range(n_adapters):
        perturb = unflatten({p: x + 0.01 * (t + 1) + 0.001 * version_salt
                             for p, x in flatten(lora_tree).items()})
        store.put(f"tenant{t}", perturb, levels[t % len(levels)])


def _run_cell(model, params, lora_tree, *, batch: int, n_adapters: int,
              swap_every: int, vocab: int) -> dict:
    from repro_torch.federation.events import LognormalLatency
    from repro_torch.serving import AdapterStore, ContinuousBatcher, \
        ServeRequest, ServingEngine

    store = AdapterStore(RANK_LEVELS)
    _stage(store, lora_tree, n_adapters)
    store.publish()
    engine = ServingEngine(model, params, store,
                           max_len=PROMPT_LEN + MAX_NEW + 2, slots=batch)
    batcher = ContinuousBatcher(
        engine, latency=LognormalLatency(0.02, 0.25, seed=0),
        step_cost=0.01, prefill_cost=0.05)
    rng = np.random.default_rng(0)          # scenario fixture, fixed seed
    n_requests = 2 * batch
    for i in range(n_requests):
        batcher.submit(ServeRequest(
            rid=i, prompt=rng.integers(0, vocab, size=PROMPT_LEN),
            adapter_id=f"tenant{i % n_adapters}",
            max_new_tokens=MAX_NEW, arrival=0.02 * i))

    sync()
    t0 = time.perf_counter()
    swaps = 0
    for _ in range(10_000):
        if not batcher.queue and all(r is None for r in batcher.slots):
            break
        if batcher.queue and not any(batcher.slots) \
                and batcher.queue[0].arrival > batcher.clock.now:
            batcher.clock.advance(batcher.queue[0].arrival)
        if swap_every and batcher.steps and batcher.steps % swap_every == 0:
            swaps += 1                       # hot-swap mid-stream
            _stage(store, lora_tree, n_adapters, version_salt=swaps)
            store.publish()
        batcher.step()
    else:
        raise RuntimeError("serve cell did not drain")
    sync()
    wall = time.perf_counter() - t0

    stats = batcher.stats()
    assert stats["completed"] == n_requests, stats
    versions = sorted(set(engine.version_log))
    return {"batch": batch, "adapters": n_adapters,
            "swap_every": swap_every, "requests": n_requests,
            "swaps": swaps, "versions_seen": versions,
            **stats, "wall_s_context_only": wall}


def run(batches=(2, 4), adapter_counts=(1, 4), swap_rates=(0, 4),
        device=None) -> dict:
    from repro_torch.core.lora import split_lora
    cfg, lora, model = _build_model(device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    _, lora_tree = split_lora(params)

    rows = []
    for batch in batches:
        for n_adapters in adapter_counts:
            for swap_every in swap_rates:
                row = _run_cell(model, params, lora_tree, batch=batch,
                                n_adapters=n_adapters, swap_every=swap_every,
                                vocab=cfg.vocab_size)
                rows.append(row)
                name = (f"serve_latency/b{batch}_a{n_adapters}"
                        f"_sw{swap_every}")
                emit(name, row["wall_s_context_only"] * 1e6,
                     f"vp95={row['virtual_p95_s']:.3f}s "
                     f"vtp={row['virtual_throughput_tok_per_s']:.1f}tok/s")

    result = {
        "config": {"arch": ARCH, "prompt_len": PROMPT_LEN,
                   "max_new_tokens": MAX_NEW,
                   "rank_levels": list(RANK_LEVELS),
                   "latency": "lognormal(0.02, 0.25) seeded per tenant",
                   "step_cost_s": 0.01, "prefill_cost_s": 0.05,
                   "device": str(model.device),
                   "note": "virtual rows replay bit for bit; wall is "
                           "context only"},
        "rows": rows,
    }
    merge_artifact(ARTIFACT, result)
    print(f"# artifact: {ARTIFACT}")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    run(device=ap.parse_args().device)
