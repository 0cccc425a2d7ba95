"""Table 2: accuracy comparison across methods (synthetic non-IID proxy; a
copy of ``benchmarks/bench_accuracy.py``).

Validates the paper's ORDERING claims (raflora >= flexlora > hetlora/flora
under heterogeneous ranks + non-IID data), not absolute numbers -- there
are no CIFAR100/GSM8K or pretrained checkpoints offline (DESIGN.md §0).
"""
import numpy as np

from repro_torch.benchmarks.common import emit, quick_fl


def run(rounds: int = 12, seeds=(0, 1), device=None):
    results = {}
    for method in ("hetlora", "flora", "flexlora", "raflora"):
        accs, walls = [], []
        for seed in seeds:
            exp, wall = quick_fl(method, rounds=rounds, seed=seed,
                                 device=device)
            accs.append(exp.eval_accuracy())
            walls.append(wall)
        results[method] = float(np.mean(accs))
        emit(f"table2_accuracy/{method}",
             float(np.mean(walls)) * 1e6,
             f"{np.mean(accs):.4f}", std=f"{np.std(accs):.4f}")
    return results


if __name__ == "__main__":
    run()
