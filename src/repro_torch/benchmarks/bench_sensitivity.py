"""Figures 2c/2d/5a/6a-6d + Table 4: sensitivity & robustness sweeps (a
copy of ``benchmarks/bench_sensitivity.py``).

Each sub-benchmark mirrors one paper figure at CPU scale:
  noniid          -- Fig 2c/6a: Dirichlet alpha sweep
  participation   -- Fig 6b: clients per round
  rank_configs    -- Fig 2d/6c: conf-1..conf-5 (varying r_1 / r_max)
  rank_dists      -- Fig 6d: uniform / low-skew / high-skew / bimodal
  partial         -- Fig 5a: raFLoRA-a/b/c partial variants
  noisy           -- Table 4: Gaussian noise on low-rank clients
"""
from repro_torch.benchmarks.common import emit, quick_fl

ROUNDS = 8


def bench_noniid(device=None):
    for alpha in (1.0, 0.1):
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(
                method, rounds=ROUNDS, device=device,
                fl_overrides={"partition": "dirichlet",
                              "dirichlet_alpha": alpha})
            emit(f"fig6a_noniid/alpha{alpha}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}")


def bench_participation(device=None):
    for part in (0.25, 0.5):
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(method, rounds=ROUNDS, device=device,
                                 participation=part)
            emit(f"fig6b_participation/{part}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}")


RANK_CONFS = {
    "conf1": (1, 8, 32),
    "conf3": (4, 8, 32),
    "conf5": (4, 8, 48),
}


def bench_rank_configs(device=None):
    for name, levels in RANK_CONFS.items():
        probs = tuple([1 / len(levels)] * len(levels))
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(
                method, rounds=ROUNDS, device=device,
                lora_overrides={"rank_levels": levels,
                                "rank_probs": probs})
            emit(f"fig6c_rankconf/{name}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}")


RANK_DISTS = {
    "uniform": (0.34, 0.33, 0.33),
    "low_skew": (0.8, 0.1, 0.1),
    "high_skew": (0.1, 0.1, 0.8),
}


def bench_rank_dists(device=None):
    for name, probs in RANK_DISTS.items():
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(
                method, rounds=ROUNDS, device=device,
                lora_overrides={"rank_levels": (4, 8, 32),
                                "rank_probs": probs})
            emit(f"fig6d_rankdist/{name}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}")


def bench_partial_variants(device=None):
    """raFLoRA-a/b/c: rank-aware weighting up to partition k only."""
    levels = (4, 8, 16, 32)
    for name, cut in (("raflora-a", 8), ("raflora-b", 16),
                      ("raflora-full", None)):
        exp, wall = quick_fl(
            "raflora", rounds=ROUNDS, partial_up_to=cut, device=device,
            lora_overrides={"rank_levels": levels,
                            "rank_probs": (0.25,) * 4})
        hr = exp.server.energy.higher_rank_ratio[-1]
        emit(f"fig5a_partial/{name}", wall * 1e6,
             f"{exp.eval_accuracy():.4f}", higher_rank=f"{hr:.4f}")


def bench_noisy_clients(device=None):
    for nu in (0.0, 0.5):
        for method in ("flexlora", "raflora"):
            exp, wall = quick_fl(method, rounds=ROUNDS, device=device,
                                 noisy_low_rank_std=nu)
            emit(f"table4_noisy/nu{nu}/{method}", wall * 1e6,
                 f"{exp.eval_accuracy():.4f}")


SUB_BENCHES = (bench_noniid, bench_participation, bench_rank_configs,
               bench_rank_dists, bench_partial_variants, bench_noisy_clients)


def run(device=None):
    for bench in SUB_BENCHES:
        bench(device=device)
    return True


if __name__ == "__main__":
    run()
