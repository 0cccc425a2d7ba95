"""Theory demo: Theorem 1's geometric rank collapse, exactly as proved (a
copy of ``examples/rank_collapse_demo.py`` on the port's numpy theory).

Simulates the closed-form expected-energy recursion AND the Monte-Carlo
client-sampling model, prints the (C, gamma) bound, and shows raFLoRA's
corrected recursion staying flat -- no training required, pure theory.

  PYTHONPATH=src python -m repro_torch.examples.rank_collapse_demo
"""
import numpy as np

from repro_torch.core.partitions import coverage
from repro_torch.core.theory import (SampledSim, collapse_bound, rho_series,
                                     simulate_expected)

LEVELS = [8, 16, 32, 48, 64]
K, M, ROUNDS = 100, 10, 60


def bar(x, width=40):
    return "#" * int(x * width)


def main():
    ranks = np.repeat(LEVELS, K // len(LEVELS))
    p = coverage(LEVELS, ranks)
    e0 = np.ones(64)

    C, gamma = collapse_bound(e0, p, K, M, r1=8)
    print(f"Theorem 1 constants: C={C:.2f}, gamma={gamma:.4f} "
          f"(higher-rank energy <= C*gamma^t)\n")

    exact = simulate_expected(e0, p, K, M, ROUNDS)
    flex = SampledSim(ranks, M, seed=0).run(np.ones(64), ROUNDS,
                                            rule="flexlora",
                                            rank_levels=LEVELS)
    ra = SampledSim(ranks, M, seed=0).run(np.ones(64), ROUNDS,
                                          rule="raflora", rank_levels=LEVELS)
    tail_exact = 1 - rho_series(exact, 8)
    tail_flex = 1 - rho_series(flex, 8)
    tail_ra = 1 - rho_series(ra, 8)

    print(f"{'t':>3s} {'bound':>8s} {'E[flex]':>8s} {'flex-MC':>8s} "
          f"{'raFLoRA':>8s}  higher-rank energy")
    for t in range(0, ROUNDS + 1, 6):
        print(f"{t:3d} {min(C * gamma ** t, 1):8.4f} {tail_exact[t]:8.4f} "
              f"{tail_flex[t]:8.4f} {tail_ra[t]:8.4f}  "
              f"|{bar(tail_flex[t]):40s}|")
    print("\nFlexLoRA's higher-rank energy decays geometrically (rank "
          "collapse); raFLoRA's stays flat.")


if __name__ == "__main__":
    main()
