"""Figure 2a/2b: energy breakdown of the global update over rounds (a copy
of ``benchmarks/bench_energy_dynamics.py``).

FlexLoRA concentrates energy in the shared-rank partition (rank collapse);
raFLoRA reshapes the energy structure and preserves higher partitions.
"""
from repro_torch.benchmarks.common import emit, quick_fl


def run(rounds: int = 12, device=None):
    for method in ("flexlora", "raflora"):
        exp, wall = quick_fl(method, rounds=rounds, seed=1, device=device)
        hr = exp.server.energy.higher_rank_ratio
        breakdown = exp.server.energy.breakdown[-1]
        emit(f"fig2_energy/{method}/higher_rank_final",
             wall / rounds * 1e6, f"{hr[-1]:.4f}",
             round0=f"{hr[0]:.4f}",
             breakdown={k: round(v, 4) for k, v in breakdown.items()})
    return True


if __name__ == "__main__":
    run()
