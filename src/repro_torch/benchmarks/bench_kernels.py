"""Kernel micro-benchmarks (a copy of ``benchmarks/bench_kernels.py``):
the kernel API ``repro_torch.kernels.ops`` at realistic shapes, against
the port's plain PyTorch versions as the oracles (the counterparts of
``repro.kernels.ref``); ``derived`` reports max |err| against them. On
the card each ``ops`` call launches the hand-written kernel (K5, K3 at
one layer, K6); on the CPU it runs the plain version, so only the card's
times and errors say anything about the kernels.
"""
import torch
import torch.nn.functional as F

from repro_torch.benchmarks.common import emit, timed
from repro_torch.kernels import ops
from repro_torch.kernels.lora_apply import lora_apply_plain
from repro_torch.kernels.rank_partition_agg import rank_partition_agg_plain
from repro_torch.kernels.ssd_scan import ssd_scan_sequential_plain

LORA = (512, 512, 512, 64)                  # m, k, n, r
AGG = (10, 768, 64)                         # M, d, r
SCAN = (2, 256, 8, 32, 1, 32, 64)           # B, L, H, P, G, N, chunk
SVD = (2048, 2048, 128)                     # d, n, R


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def run(device=None):
    """Emits the reference's five rows; returns {row: {"args", "got",
    "want"}} for the three kernel rows (the ``ops`` call's inputs, its
    output and the oracle's) and the SVD rows' microseconds."""
    from repro_torch.core.svd import svd_realloc_dense, svd_realloc_factored
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    out = {}
    # fused LoRA apply at a qwen2-ish projection shape (m > 32 rows: the
    # tensor-core route on the card)
    m, k, n, r = LORA
    args = (randn(m, k), randn(k, n) * 0.05, randn(r, k) * 0.1,
            randn(n, r) * 0.1, 1.0)
    got, us = timed(lambda: ops.lora_apply(*args), repeats=2)
    want = lora_apply_plain(*args)
    out["kernel/lora_apply_512"] = {"args": args, "got": got, "want": want}
    emit("kernel/lora_apply_512", us, f"err={_err(got, want):.2e}")

    # rank-partition aggregation at vit-base layer scale
    mm, d, rm = AGG
    args = (randn(mm, d, rm), randn(mm, rm, d),
            torch.rand(mm, rm, generator=gen, device=dev))
    got, us = timed(lambda: ops.rank_partition_agg(*args), repeats=2)
    want = rank_partition_agg_plain(*args)
    out["kernel/rank_partition_agg_768"] = {"args": args, "got": got,
                                            "want": want}
    emit("kernel/rank_partition_agg_768", us, f"err={_err(got, want):.2e}")

    # SSD scan at reduced mamba2 shapes, against the sequential recurrence
    bsz, length, h, p, g, nn, chunk = SCAN
    args = (randn(bsz, length, h, p), F.softplus(randn(bsz, length, h)),
            randn(h) * 0.5, randn(bsz, length, g, nn) * 0.3,
            randn(bsz, length, g, nn) * 0.3, randn(h))
    (y, _), us = timed(lambda: ops.ssd_scan(*args, chunk=chunk), repeats=2)
    y_r, _ = ssd_scan_sequential_plain(*args)
    out["kernel/ssd_scan_256"] = {"args": args, "got": y, "want": y_r}
    emit("kernel/ssd_scan_256", us, f"err={_err(y, y_r):.2e}")

    # factored vs dense SVD reallocation (the beyond-paper optimization)
    d_big, n_big, rr = SVD
    u_c, v_c = randn(d_big, rr), randn(rr, n_big)
    dw = u_c @ v_c
    _, us_d = timed(lambda: svd_realloc_dense(dw, 64)[2], repeats=2)
    _, us_f = timed(lambda: svd_realloc_factored(u_c, v_c, 64)[2],
                    repeats=2)
    emit("svd/dense_2048", us_d, f"{us_d/1e3:.1f}ms")
    emit("svd/factored_2048", us_f,
         f"{us_f/1e3:.1f}ms ({us_d/us_f:.1f}x speedup)")
    out["svd/dense_2048"], out["svd/factored_2048"] = us_d, us_f
    return out


if __name__ == "__main__":
    run()
