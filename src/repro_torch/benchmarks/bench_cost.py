"""Table 3: communication cost per client per round + aggregation compute
(a copy of ``benchmarks/bench_cost.py``).

Communication is exact (bytes of the factors each method moves, from the
real adapter shapes of the model, ``Model.param_shapes``: nothing is
allocated); computation is the measured wall time of one server
aggregation over M=10 uploads, for the dense (paper-faithful), factored
(QR-SVD) and kernel (K1 weighted stacks + K2 Gram cores + Gram-core SVD)
backends.
"""
import numpy as np
import torch

from repro_torch.benchmarks.common import emit, timed
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.core.aggregation import Aggregator
from repro_torch.core.lora import adapter_paths
from repro_torch.models.transformer import Model


def comm_bytes_per_client(cfg, lora: LoRAConfig, method: str, m: int,
                          rank: int, dtype_bytes: int = 4) -> int:
    """Upload + download volume per client per round (Table 1 column)."""
    model = Model(cfg, lora, device="cpu",   # shapes only: no weights
                  remat=False)
    shapes = model.param_shapes()
    per_rank_elems = 0  # elements per unit rank across all adapters
    for ab in adapter_paths(shapes).values():
        r_max, d_in = ab["a"].shape[-2:]
        d_out = ab["b"].shape[-2]
        layers = int(np.prod(ab["a"].shape[:-2])) or 1
        per_rank_elems += layers * (d_in + d_out)
    up = per_rank_elems * rank * dtype_bytes
    if method == "flora":
        # stacked matrices of ALL selected clients are broadcast down
        down = per_rank_elems * rank * m * dtype_bytes
    else:
        down = per_rank_elems * rank * dtype_bytes
    return up + down


def layer_inputs(device, lora: LoRAConfig, m: int = 10, d: int = 768,
                 n: int = 768):
    """One vit-base layer's uploads: M clients at ranks drawn by
    ``default_rng(0)`` from the rank levels, factors from a seeded
    generator on ``device``, equal sample counts, zero global factors."""
    gen = torch.Generator(device=device).manual_seed(0)
    ranks = [int(r) for r in
             np.random.default_rng(0).choice(lora.rank_levels, size=m)]
    factors = [(torch.randn(d, r, generator=gen, device=device),
                torch.randn(r, n, generator=gen, device=device))
               for r in ranks]
    n_k = [100.0] * m
    gb = torch.zeros(d, lora.r_max, device=device)
    ga = torch.zeros(lora.r_max, n, device=device)
    return factors, ranks, n_k, gb, ga


BACKENDS = ("dense", "factored", "kernel")


def run(device=None):
    from repro_torch.device import resolve_device
    lora = LoRAConfig()  # paper ranks {8..64}
    m = 10
    avg_rank = int(np.mean(lora.rank_levels))
    for arch in ("vit-base", "llama3.1-8b"):
        cfg = get_config(arch)
        for method in ("hetlora", "flora", "flexlora", "raflora"):
            comm = comm_bytes_per_client(cfg, lora, method, m, avg_rank)
            emit(f"table3_comm/{arch}/{method}", 0.0,
                 f"{comm / 1e6:.1f}MB")

    # aggregation compute: one layer of vit-base scale (768x768), M=10
    factors, ranks, n_k, gb, ga = layer_inputs(resolve_device(device), lora,
                                               m)
    results = {}
    for backend in BACKENDS:
        agg = Aggregator("raflora", lora.rank_levels, backend=backend)

        def call():
            return agg.aggregate_layer(factors, ranks, n_k, gb, ga)

        results[backend], us = timed(call)
        emit(f"table3_comp/aggregate_layer_768/{backend}", us,
             f"{us / 1e3:.2f}ms")
    return results


if __name__ == "__main__":
    run()
