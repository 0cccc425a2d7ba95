"""K6 and K7 of one checkout on finite inputs at the main path's shapes,
so that two trees can be compared in turns (parent, change, change,
parent) on one card in one session:

    python3 src/repro_torch/tools/kernel_ab.py ROOT LABEL

ROOT is a checkout: its ``chip_smoke.py`` (its ``phase_build``, its
shapes ``SCAN_FULL``, ``SCAN_HYMBA`` and ``ATTN_SHAPES``, its inputs and
``time_graph_ms``) and the ``repro_torch`` under its ``src/`` are
imported, nothing of the tree this file lies in, so run it as a file in
a process of its own for each tree. For each shape: a digest of the
outputs (equal digests: bit-equal outputs across trees) and the device
ms of one call replayed from a CUDA graph, three times. Prints one JSON
line with ``LABEL`` and the card. Exits 2 without a card.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path[:0] = [os.path.join(root, "src"), root]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.phase_build()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as k6
    out = {"tree": label}
    for name, shape in (("mamba2", smoke.SCAN_FULL),
                        ("hymba", smoke.SCAN_HYMBA)):
        for init in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(7)
            args, init_state = smoke._scan_inputs(torch, shape, gen, init)

            def scan():
                return k6.ssd_scan(*args, shape[-1], init_state=init_state)
            y, s = scan()
            out[f"k6_{name}_init{int(init)}"] = {
                "digest": _digest(y, s),
                "device_ms": [smoke.time_graph_ms(torch, scan)
                              for _ in range(3)]}
            del args, init_state, y, s
    for name, b, lq, h, kvh, d, causal, window in smoke.ATTN_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(8)
        q, k, v = (torch.randn(b, lq, n, d, generator=gen, device="cuda")
                   for n in (h, kvh, kvh))

        def attend():
            return fa.flash_attention(q, k, v, causal, window)
        out[f"k7_{name}"] = {
            "digest": _digest(attend()),
            "device_ms": [smoke.time_graph_ms(torch, attend)
                          for _ in range(3)]}
        del q, k, v
    torch.cuda.empty_cache()
    out["card"] = smoke.card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
