"""Round-engine latency studies (a copy of
``benchmarks/bench_round_latency.py``): sequential vs batched vs sharded
vs async, the kernel aggregation backend, the compressed transport and
the event engine.

Measures the ``FederatedLoRA.run_round`` hot path at
``clients_per_round=8`` (full participation of 8 heterogeneous-rank
clients, so every round has the same rank-group composition). Warmup
rounds are excluded; engines are timed INTERLEAVED, block by block, so
drifting background load biases all engines equally; the reported number
is the median over the timed blocks. Each timed block ends with the
server's ``flush_stats()`` and a device synchronize, so queued work is
charged to its own block.

Studies (all merged into one artifact, ``build/bench_torch/
round_latency.json``; the JAX package's ``BENCH_round_latency.json`` and
``benchmarks/artifacts/`` are never written):

* ``run``: sequential vs batched.
* ``run_sharded``: the sharded engine against its shard count, one
  process group of S ranks for each S that fits the visible cards (gloo
  ranks on the CPU with ``--device cpu``); rank 0's times.
* ``run_async``: the async buffered-aggregation engine swept over
  ``pipeline_depth`` (1, 2, 4) against batched, with the server-momentum
  dispatch audit (at most one bucket call per bucket per aggregation).
* ``run_kernel_backend``: the kernel aggregation backend (K1 weighted
  stacks + K2 Gram cores) on the batched and sharded engines against the
  factored backend; the sharded server runs on this process's group (a
  one-rank group made in process if there is none, and destroyed after).
* ``run_transport``: f32 uploads vs int8 and bf16 with error feedback,
  plus the analytic upload bytes a round.
* ``run_event``: the event engine on the virtual clock, trigger type x
  straggler fraction -> virtual time to a target higher-rank energy.
  Rows APPEND to the artifact's ``event.rows``.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_round_latency \
      [--engine batched|sharded|async|event|transport|all] \
      [--backend kernel] \
      [--device cpu]
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

import torch

from repro_torch.benchmarks.common import emit, merge_artifact, sync
from repro_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ARTIFACT = os.path.join(ROOT, "build", "bench_torch", "round_latency.json")


def _merge_artifact(update: dict) -> dict:
    """Read-modify-write the shared JSON artifact so the studies never
    clobber each other."""
    return merge_artifact(ARTIFACT, update)


def _make(engine: str, *, rounds: int, d_model: int, batches_per_round: int,
          local_batch_size: int, pipeline_depth: int = 1,
          server_momentum_beta: float = 0.0, backend: str = "factored",
          transport=None, mesh=None, device=None, base_params=None):
    from repro_torch.federation.experiment import build_experiment
    return build_experiment(
        "raflora",
        fl_overrides={"num_rounds": rounds, "num_clients": 8,
                      "participation": 1.0,            # clients_per_round=8
                      "local_batch_size": local_batch_size},
        lora_overrides={"rank_levels": (4, 8, 16),
                        "rank_probs": (0.34, 0.33, 0.33)},
        samples_per_class=40, num_classes=8, d_model=d_model,
        batches_per_round=batches_per_round, round_engine=engine, mesh=mesh,
        pipeline_depth=pipeline_depth, backend=backend,
        server_momentum_beta=server_momentum_beta, transport=transport,
        device=device, base_params=base_params)


def _time_blocks(servers: dict, *, blocks: int, rounds_per_block: int,
                 warmup: int) -> dict:
    """Median seconds-per-round per server, timed in interleaved blocks;
    each block ends with its server's ``flush_stats()`` and a device
    synchronize."""
    for _ in range(warmup):
        for srv in servers.values():
            for _ in range(rounds_per_block):
                srv.run_round()
            srv.flush_stats()
    sync()
    times = {k: [] for k in servers}
    for _ in range(blocks):
        for key, srv in servers.items():    # interleaved: shared load drift
            t0 = time.perf_counter()
            for _ in range(rounds_per_block):
                srv.run_round()
            srv.flush_stats()
            sync()
            times[key].append((time.perf_counter() - t0) / rounds_per_block)
    return times


def run(rounds: int = 12, warmup: int = 2, d_model: int = 64,
        batches_per_round: int = 1, local_batch_size: int = 16,
        device=None) -> dict:
    total = rounds + warmup
    servers = {eng: _make(eng, rounds=total, d_model=d_model,
                          batches_per_round=batches_per_round,
                          local_batch_size=local_batch_size,
                          device=device).server
               for eng in ("sequential", "batched")}
    times = _time_blocks(servers, blocks=rounds, rounds_per_block=1,
                         warmup=warmup)

    medians = {eng: float(np.median(ts)) for eng, ts in times.items()}
    speedup = medians["sequential"] / medians["batched"]
    result = _merge_artifact({
        "config": {"clients_per_round": 8, "rounds_timed": rounds,
                   "warmup_rounds": warmup, "d_model": d_model,
                   "batches_per_round": batches_per_round,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora"},
        "per_round_s": {eng: ts for eng, ts in times.items()},
        "median_s": medians,
        "speedup_batched_over_sequential": speedup,
    })

    for eng in servers:
        emit(f"round_latency/{eng}", medians[eng] * 1e6,
             f"median_round_ms={medians[eng] * 1e3:.1f}")
    emit("round_latency/speedup", 0.0, f"{speedup:.2f}x")
    print(f"# artifact: {ARTIFACT}")
    return result


def _sharded_rank(rank: int, world: int, kw: dict, device: str) -> list:
    """One rank of ``run_sharded``'s group of ``world``: its sharded
    server, timed like ``run``; rank r of a card group runs on card r,
    and CPU ranks share the cores (oversubscribed thread pools spin)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    rounds, warmup = kw.pop("rounds"), kw.pop("warmup")
    server = _make("sharded", rounds=rounds + warmup, device=dev,
                   **kw).server
    return _time_blocks({world: server}, blocks=rounds, rounds_per_block=1,
                        warmup=warmup)[world]


def run_sharded(rounds: int = 8, warmup: int = 2, d_model: int = 64,
                batches_per_round: int = 1, local_batch_size: int = 16,
                device=None) -> dict:
    """Sharded-engine latency against the shard count: one process group
    of S ranks (NCCL on the cards, gloo on the CPU) for each S in 1, 2,
    4, 8, 16 that fits the visible cards (S 1 and 2 with ``device``
    "cpu"), each timed like ``run``; rank 0's times are reported. Merges
    into the shared artifact."""
    from repro_torch.launch.mesh import default_backend, spawn_ranks
    dev = resolve_device(device)
    fits = torch.cuda.device_count() if dev.type == "cuda" else 2
    shard_counts = [s for s in (1, 2, 4, 8, 16) if s <= fits]
    kw = dict(rounds=rounds, warmup=warmup, d_model=d_model,
              batches_per_round=batches_per_round,
              local_batch_size=local_batch_size)
    times = {s: spawn_ranks(_sharded_rank, s, dict(kw), str(dev),
                            backend=default_backend(dev))[0]
             for s in shard_counts}

    medians = {s: float(np.median(ts)) for s, ts in times.items()}
    sharded = {
        "config": {"clients_per_round": 8, "rounds_timed": rounds,
                   "warmup_rounds": warmup, "d_model": d_model,
                   "batches_per_round": batches_per_round,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora",
                   "device": str(dev)},
        "shard_counts": shard_counts,
        "per_round_s": {str(s): ts for s, ts in times.items()},
        "median_s": {str(s): m for s, m in medians.items()},
    }
    _merge_artifact({"sharded": sharded})

    for s in shard_counts:
        emit(f"round_latency/sharded_{s}", medians[s] * 1e6,
             f"median_round_ms={medians[s] * 1e3:.1f}")
    print(f"# artifact: {ARTIFACT}")
    return sharded


def _momentum_dispatch_audit(*, d_model: int, local_batch_size: int,
                             device=None) -> dict:
    """Bucketed server momentum must add at most ONE bucket call per
    shape bucket per aggregation."""
    exp = _make("async", rounds=8, d_model=d_model, batches_per_round=1,
                local_batch_size=local_batch_size, pipeline_depth=2,
                server_momentum_beta=0.9, device=device)
    exp.server.run(6)
    mom = exp.server.server_momentum
    n_aggs = len(exp.server.energy.rho_r1)
    n_buckets = len(mom.state)              # one stacked entry per bucket
    if not (n_aggs > 0 and n_buckets > 0
            and mom.bucket_calls <= n_aggs * n_buckets):
        raise RuntimeError(f"momentum dispatch audit: {mom.bucket_calls} "
                           f"bucket calls for {n_aggs} aggregations of "
                           f"{n_buckets} buckets")
    return {"bucket_calls": mom.bucket_calls, "aggregations": n_aggs,
            "buckets": n_buckets,
            "dispatches_per_bucket_per_agg":
                mom.bucket_calls / (n_aggs * n_buckets)}


def run_async(rounds: int = 8, warmup: int = 4, d_model: int = 128,
              batches_per_round: int = 1, local_batch_size: int = 4,
              depths=(1, 2, 4), rounds_per_block: int = 4,
              backend: str = "dense", device=None) -> dict:
    """Async-engine latency vs pipeline depth: depth d runs one buffered
    aggregation per d training rounds, so blocks of ``rounds_per_block``
    rounds (a multiple of every depth) are timed. The dense backend at an
    aggregation-heavy shape (d_model 128, local batch 4), as in the
    reference: its SVD cost does not grow with the merged client count."""
    total = (rounds + warmup) * rounds_per_block
    servers = {"batched": _make("batched", rounds=total, d_model=d_model,
                                batches_per_round=batches_per_round,
                                local_batch_size=local_batch_size,
                                backend=backend, device=device).server}
    for d in depths:
        servers[f"async{d}"] = _make(
            "async", rounds=total, d_model=d_model,
            batches_per_round=batches_per_round,
            local_batch_size=local_batch_size, pipeline_depth=d,
            backend=backend, device=device).server
    times = _time_blocks(servers, blocks=rounds,
                         rounds_per_block=rounds_per_block, warmup=warmup)

    medians = {k: float(np.median(ts)) for k, ts in times.items()}
    speedups = {f"speedup_async{d}_over_batched":
                medians["batched"] / medians[f"async{d}"] for d in depths}
    audit = _momentum_dispatch_audit(d_model=d_model,
                                     local_batch_size=local_batch_size,
                                     device=device)
    async_result = {
        "config": {"clients_per_round": 8, "blocks_timed": rounds,
                   "rounds_per_block": rounds_per_block,
                   "warmup_blocks": warmup, "d_model": d_model,
                   "batches_per_round": batches_per_round,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora",
                   "backend": backend},
        "pipeline_depths": list(depths),
        "per_round_s": {k: ts for k, ts in times.items()},
        "median_s": medians,
        "momentum_dispatch_audit": audit,
        **speedups,
    }
    _merge_artifact({"async": async_result})

    for k in servers:
        emit(f"round_latency/{k}", medians[k] * 1e6,
             f"median_round_ms={medians[k] * 1e3:.1f}")
    for d in depths:
        emit(f"round_latency/speedup_async{d}", 0.0,
             f"{speedups[f'speedup_async{d}_over_batched']:.2f}x")
    print(f"# artifact: {ARTIFACT}")
    return async_result


def run_kernel_backend(rounds: int = 8, warmup: int = 2, d_model: int = 64,
                       batches_per_round: int = 1,
                       local_batch_size: int = 16, sharded: bool = True,
                       device=None) -> dict:
    """The kernel aggregation backend on the batched engine against the
    factored baseline, and (``sharded``) on the sharded engine over this
    process's group, interleaved-block-timed like every other study; a
    one-rank group the sharded server made is destroyed after."""
    total = rounds + warmup
    runs = [("batched_factored", "batched", "factored"),
            ("batched_kernel", "batched", "kernel")]
    if sharded:
        runs.append(("sharded_kernel", "sharded", "kernel"))
    servers = {
        key: _make(engine, rounds=total, d_model=d_model,
                   batches_per_round=batches_per_round,
                   local_batch_size=local_batch_size, backend=backend,
                   device=device).server
        for key, engine, backend in runs}
    try:
        times = _time_blocks(servers, blocks=rounds, rounds_per_block=1,
                             warmup=warmup)
    finally:
        for srv in servers.values():
            srv.close()

    medians = {k: float(np.median(ts)) for k, ts in times.items()}
    result = {
        "config": {"clients_per_round": 8, "rounds_timed": rounds,
                   "warmup_rounds": warmup, "d_model": d_model,
                   "batches_per_round": batches_per_round,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora"},
        "per_round_s": {k: ts for k, ts in times.items()},
        "median_s": medians,
        "kernel_over_factored_batched":
            medians["batched_factored"] / medians["batched_kernel"],
    }
    _merge_artifact({"kernel_backend": result})

    for k in servers:
        emit(f"round_latency/{k}", medians[k] * 1e6,
             f"median_round_ms={medians[k] * 1e3:.1f}")
    print(f"# artifact: {ARTIFACT}")
    return result


def _adapter_shapes(server):
    """[(parent, (d, n))] of every adapter of the global tree."""
    from repro_torch.core.lora import flatten
    got = {}
    for path, leaf in flatten(server.global_lora).items():
        if path[-1] == "lora_b":
            got.setdefault(path[:-1], [0, 0])[0] = leaf.shape[-2]
        elif path[-1] == "lora_a":
            got.setdefault(path[:-1], [0, 0])[1] = leaf.shape[-1]
    return sorted(got.items())


def _upload_bytes_per_round(server, mode) -> int:
    """Analytic client->server upload bytes for one full-participation
    round: per participating client, per LoRA adapter, the factor pair at
    the client's rank level. f32 ships raw (d*r + r*n)*4; the transport
    modes ship the QuantFactor payload + f32 per-column scales."""
    from repro_torch.federation.transport import (TransportConfig,
                                                  UpdateTransport)
    tr = None if mode == "f32" else UpdateTransport(TransportConfig(mode))
    shapes = [tuple(dn) for _, dn in _adapter_shapes(server)]
    total = 0
    for rank in server.registry.ranks:
        rank = int(rank)
        for d, n in shapes:
            if tr is None:
                total += (d * rank + rank * n) * 4
            else:
                total += tr.payload_bytes(d, n, rank)
    return int(total)


def run_transport(rounds: int = 8, warmup: int = 2, d_model: int = 64,
                  batches_per_round: int = 1, local_batch_size: int = 16,
                  device=None) -> dict:
    """Compressed-transport study: the batched engine with f32 uploads vs
    int8 and bf16 quantized transport (error feedback on), plus the
    analytic upload bytes per round for each mode (exact)."""
    from repro_torch.federation.transport import TransportConfig
    total = rounds + warmup
    modes = {"batched_f32": None,
             "batched_int8": TransportConfig(mode="int8"),
             "batched_bf16": TransportConfig(mode="bf16")}
    servers = {k: _make("batched", rounds=total, d_model=d_model,
                        batches_per_round=batches_per_round,
                        local_batch_size=local_batch_size, transport=tr,
                        device=device).server
               for k, tr in modes.items()}
    times = _time_blocks(servers, blocks=rounds, rounds_per_block=1,
                         warmup=warmup)

    medians = {k: float(np.median(ts)) for k, ts in times.items()}
    byts = {k: _upload_bytes_per_round(servers[k], k.split("_")[1])
            for k in servers}
    result = {
        "config": {"clients_per_round": 8, "rounds_timed": rounds,
                   "warmup_rounds": warmup, "d_model": d_model,
                   "batches_per_round": batches_per_round,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora",
                   "error_feedback": True},
        "per_round_s": {k: ts for k, ts in times.items()},
        "median_s": medians,
        "bytes_per_round": byts,
        "bytes_reduction_int8":
            byts["batched_f32"] / byts["batched_int8"],
        "bytes_reduction_bf16":
            byts["batched_f32"] / byts["batched_bf16"],
    }
    _merge_artifact({"transport": result})

    for k in servers:
        emit(f"round_latency/{k}", medians[k] * 1e6,
             f"median_round_ms={medians[k] * 1e3:.1f} "
             f"upload_MB={byts[k] / 1e6:.2f}")
    emit("round_latency/bytes_reduction_int8", 0.0,
         f"{result['bytes_reduction_int8']:.2f}x")
    print(f"# artifact: {ARTIFACT}")
    return result


def run_event(rounds: int = 10, d_model: int = 32,
              local_batch_size: int = 8,
              straggler_fracs=(0.0, 0.5),
              target_energy: float = 0.25, device=None) -> dict:
    """Event-driven scheduler sweep: buffer trigger type x straggler
    fraction -> simulated virtual time to a target higher-rank energy for
    raFLoRA, plus per-fire consumption stats. Virtual time is exactly
    reproducible; rows APPEND to the artifact's ``event.rows``."""
    from repro_torch.federation.events import (EventScheduler,
                                               standard_straggler_latency,
                                               standard_trigger)
    rows = []
    for trig_name in ("count", "timeout", "staleness"):
        for frac in straggler_fracs:
            exp = _make("async", rounds=rounds, d_model=d_model,
                        batches_per_round=1,
                        local_batch_size=local_batch_size, device=device)
            m = exp.server.fl.clients_per_round
            trigger = standard_trigger(trig_name, m)
            sched = EventScheduler(standard_straggler_latency(frac),
                                   trigger, round_interval=1.0)
            exp.server.set_event_scheduler(sched)
            exp.server.run(rounds)
            exp.server.drain_pending()
            energy = exp.server.energy.higher_rank_ratio
            fires = sched.fire_log
            if len(energy) != len(fires):
                raise RuntimeError(f"{len(energy)} energy entries for "
                                   f"{len(fires)} fires")
            vt = next((f.time for f, e in zip(fires, energy)
                       if e >= target_energy), None)
            rows.append({
                "trigger": trigger.describe(),
                "straggler_frac": frac,
                "virtual_time_to_target_energy": vt,
                "target_energy": target_energy,
                "final_higher_rank_energy": float(energy[-1]),
                "virtual_time_total": sched.clock.now,
                "aggregations": len(fires),
                "updates_aggregated": int(sum(f.consumed for f in fires)),
                "max_staleness": int(max(f.max_staleness for f in fires)),
                "rounds": rounds,
            })
            if vt is not None:
                emit(f"round_latency/event_{trig_name}_s{frac}", vt * 1e6,
                     f"vt_to_E>={target_energy}={vt:.1f} aggs={len(fires)}")
            else:
                # target never reached: no metric row (a 0.0 sentinel would
                # read as the BEST outcome); the JSON row records null
                print(f"# event_{trig_name}_s{frac}: target energy "
                      f"{target_energy} not reached in {rounds} rounds "
                      f"(final {float(energy[-1]):.3f})")
    existing = {}
    if os.path.exists(ARTIFACT):
        with open(ARTIFACT) as f:
            existing = json.load(f).get("event") or {}
    result = {
        "config": {"clients_per_round": 8, "d_model": d_model,
                   "local_batch_size": local_batch_size,
                   "rank_levels": [4, 8, 16], "method": "raflora",
                   "round_interval": 1.0,
                   "latency": "straggler-tail lognormal(0.9, 0.2) x6"},
        "rows": list(existing.get("rows", [])) + rows,
    }
    _merge_artifact({"event": result})
    print(f"# artifact: {ARTIFACT}")
    return result


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("batched", "sharded", "async",
                                         "event", "transport", "all"),
                    default="batched")
    ap.add_argument("--backend", choices=("factored", "kernel"),
                    default="factored",
                    help="'kernel' runs the kernel-backend sweep instead "
                         "of the engine studies")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    if args.backend == "kernel":
        run_kernel_backend(device=dev)
    elif args.engine == "sharded":
        run_sharded(device=dev)
    elif args.engine == "async":
        run_async(device=dev)
    elif args.engine == "event":
        run_event(device=dev)
    elif args.engine == "transport":
        run_transport(device=dev)
    elif args.engine == "all":
        run(device=dev)
        run_sharded(device=dev)
        run_async(device=dev)
        run_kernel_backend(device=dev)
        run_event(device=dev)
        run_transport(device=dev)
    else:
        run(device=dev)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
