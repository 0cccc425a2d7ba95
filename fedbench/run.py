#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 fedbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout of the repository. Loads and warms up the
cell, measures for ``--seconds``, frees the program's state, checks what
the measured path produced against the plain reference, and prints the
numbers compared with their limits as the last lines of standard error
and the result as one JSON line, the last of standard output. Exits
non-zero, printing no result, without as many CUDA devices as the cell
asks for, or where JAX, Flax or the JAX package is loaded once the window
has closed. The port's kernels build into ``build/kernels`` inside the
checkout on a checkout's first run; every other cache of the run is kept
under ``build/`` too.
"""
import argparse
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    from fedbench import harness
    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
