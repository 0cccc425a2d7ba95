#!/usr/bin/env python3
"""Readings that the check's limits are set from, for one cell, on the
card, in one process: the program's numbers on many seeds (the lower
reading), the control's (the reference in the precision below the
configuration's, in the program's place) and each planted fault's (the
upper reading).

    python3 fedbench/calibrate.py --workload <cell> --seeds 101 102 ... \\
        --control-seeds 201 202 203 [--seconds S] [--out FILE]

Each seed runs a window of ``--seconds`` at the cell's own load: a
round cell's check compares set-up's checked rounds and the window's
last; a serving cell's window has to be long enough to finish the mix's
longest requests. Faults: the
round cells' half batch (the reference, each step on the first half of
its rows, in the program's place); the serving cells' altered token (the
program's served tokens, one a request moved to the next id). One JSON
line a reading, to standard output and ``--out``.
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)


def emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from fedbench import harness
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        cell = harness.make_cell(bench, args.workload, seed, args.device)
        cell.setup()
        kind = "round" if hasattr(cell, "captured") else "serve"
        cell.window(args.seconds, False)
        cell.release()
        if seed in args.seeds:
            emit(args.out, {"workload": args.workload, "seed": seed,
                            "side": "program", "numbers": cell.check(),
                            "failures": cell.failures,
                            "seconds": time.perf_counter() - t})
        if seed in args.control_seeds:
            if kind == "round":
                refr = cell.reference()
                ctl = cell.numbers(cell.reference(tf32=True), refr)
                half = cell.numbers(cell.reference(half_batch=True), refr)
                faults = {"half_batch": half}
            else:
                reqs = cell.sample()
                served = [list(r["tokens"]) for r in reqs]
                ctl = cell.numbers_for(reqs, served, fp8=True)
                v = cell.cfg["vocab_size"]
                bad = [toks[:len(toks) // 2] + [(toks[len(toks) // 2] + 1)
                                                % v] + toks[len(toks) // 2
                                                            + 1:]
                       for toks in served]
                faults = {"token_altered": cell.numbers_for(reqs, bad)}
            emit(args.out, {"workload": args.workload, "seed": seed,
                            "side": "control", "numbers": ctl,
                            "faults": faults,
                            "seconds": time.perf_counter() - t})
        del cell
        free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
