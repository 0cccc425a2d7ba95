"""Table 5: extension to PEFT variants (QLoRA / DoRA) (a copy of
``benchmarks/bench_lora_variants.py``).

The paper's finding: FlexLoRA-DoRA degrades sharply because magnitude
reweighting cannot recover directions attenuated by rank collapse, while
raFLoRA avoids the issue. QLoRA (quantized frozen base) is robustness to a
degraded base; AdaLoRA's budget reallocation is out of scope (its rank
schedule conflicts with fixed heterogeneous client ranks).
"""
from repro_torch.benchmarks.common import emit, quick_fl

ROUNDS = 8


def run(device=None):
    for variant in ("lora", "qlora", "dora"):
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(
                method, rounds=ROUNDS, device=device,
                lora_overrides={"variant": variant, "quant_bits": 4,
                                "rank_levels": (4, 8, 32),
                                "rank_probs": (0.34, 0.33, 0.33)})
            hr = (exp.server.energy.higher_rank_ratio[-1]
                  if exp.server.energy.rho_r1 else float("nan"))
            emit(f"table5_variants/{variant}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}", higher_rank=f"{hr:.4f}")
    return True


if __name__ == "__main__":
    run()
