"""Quickstart: federated heterogeneous-rank LoRA with raFLoRA (a copy of
``examples/quickstart.py``).

Runs 8 federated rounds on the synthetic non-IID classification task and
prints the higher-rank energy ratio each round -- the quantity whose decay
is "rank collapse" (Definition 1) and whose preservation is the paper's
contribution.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from repro_torch.federation.experiment import build_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)
    for method in ("flexlora", "raflora"):
        exp = build_experiment(
            method,
            fl_overrides={"num_rounds": 8, "num_clients": 16,
                          "participation": 0.5},
            num_classes=10, d_model=64, samples_per_class=50,
            batches_per_round=1, device=args.device)
        print(f"\n=== {method} ===")
        acc0 = exp.eval_accuracy()
        for r in range(8):
            stats = exp.server.run_round()
            hr = exp.server.energy.higher_rank_ratio[-1]
            print(f"round {r}: client loss {stats.mean_client_loss:.3f}  "
                  f"higher-rank energy (1-rho_r1) = {hr:.3f}")
        print(f"test accuracy: {acc0:.3f} -> {exp.eval_accuracy():.3f}")


if __name__ == "__main__":
    main()
