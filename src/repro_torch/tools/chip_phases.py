"""Run chosen phases of a checkout's ``chip_smoke.py`` on the card, so that
two trees can be timed in turns (parent, change, change, parent) on one
card in one session:

    python3 src/repro_torch/tools/chip_phases.py ROOT PHASE [PHASE ...]

ROOT is a checkout: its ``chip_smoke.py`` and the ``repro_torch`` under its
``src/`` are imported, nothing of the tree this file lies in, so run it
as a file in a process of its own for each tree. Each PHASE names a
``phase_*`` function of that script (without the prefix) that takes
``(torch)`` or ``(torch, summary)``; ``build`` always runs first. Every
phase prints its own lines as the script does; then one line
``{"phases_of": ROOT, "seconds": {...}, "summary": {...}, "card": ...}``
with each phase's wall seconds and what the phases put in the summary.
Exits 1 if a phase fails, 2 without a card.
"""
from __future__ import annotations

import gc
import importlib.util
import inspect
import json
import os
import sys
import time


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    sys.path[:0] = [os.path.join(root, "src"), root]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary, seconds = {}, {}
    try:
        for name in ["build"] + [p for p in argv[1:] if p != "build"]:
            fn = getattr(smoke, f"phase_{name}")
            args = (torch, summary)[:len(inspect.signature(fn).parameters)]
            t0 = time.perf_counter()
            fn(*args)
            seconds[name] = time.perf_counter() - t0
            gc.collect()              # a phase's model is freed before the
            torch.cuda.empty_cache()  # next, as the script's main does
    except smoke.SmokeFailure as e:
        print(f"chip_phases: FAIL in {root}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"phases_of": root, "seconds": seconds,
                      "summary": summary, "card": smoke.card_line()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
