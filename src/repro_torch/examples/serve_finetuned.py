"""Serving example (a copy of ``examples/serve_finetuned.py``): batched
greedy decoding for a decoder arch from the assigned pool, exercising
prefill -> KV-cache -> serve_step through ``repro_torch.launch.serve``.

  PYTHONPATH=src python -m repro_torch.examples.serve_finetuned \
      --arch mamba2-1.3b [--device cpu]
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    sys.exit(main())
