"""Benchmark harness entry point: one benchmark per paper table/figure
(a copy of ``benchmarks/run.py`` with ``--device``).

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # full
  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick    # subset
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only accuracy,kernels
  PYTHONPATH=src python -m repro_torch.benchmarks.run --quick --device cpu

Prints ``name,us_per_call,derived`` CSV (``common.emit``). ``roofline``
has no counterpart by design (it reads the TPU dry runs' artifacts): it
raises NotImplementedError saying so, and counts as failed.
"""
import argparse
import importlib
import sys
import time

BENCHES = {
    "kernels": "repro_torch.benchmarks.bench_kernels",   # kernel checks
    "cost": "repro_torch.benchmarks.bench_cost",         # Table 3
    "energy": "repro_torch.benchmarks.bench_energy_dynamics",  # Fig 2a/2b
    "accuracy": "repro_torch.benchmarks.bench_accuracy",  # Table 2
    "sensitivity": "repro_torch.benchmarks.bench_sensitivity",
    # Fig 2c/2d/5a/6a-d, Tbl 4
    "variants": "repro_torch.benchmarks.bench_lora_variants",  # Table 5
    "roofline": None,       # TPU dry-run roofline table
    "round_latency": "repro_torch.benchmarks.bench_round_latency",
}

QUICK = ("kernels", "cost", "energy", "roofline", "round_latency")

NOT_PORTED = {
    "roofline": "reads TPU dry-run artifacts; no counterpart on one card, "
                "ROADMAP.md",
}


def run_bench(name: str, device=None):
    """Run one bench by its key; the unported ones raise."""
    if BENCHES[name] is None:
        raise NotImplementedError(f"{name}: {NOT_PORTED[name]}")
    return importlib.import_module(BENCHES[name]).run(device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark keys")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)

    if args.only:
        names = args.only.split(",")
    elif args.quick:
        names = list(QUICK)
    else:
        names = list(BENCHES)

    print("name,us_per_call,derived")
    t0 = time.time()
    failed = []
    for name in names:
        print(f"# --- {name} ({BENCHES[name]}) ---", flush=True)
        try:
            run_bench(name, args.device)
        except Exception as e:  # one bench's failure must not stop the rest
            failed.append(name)
            print(f"# FAILED {name}: {type(e).__name__}: {e}", flush=True)
    print(f"# total {time.time() - t0:.1f}s; failed={failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
