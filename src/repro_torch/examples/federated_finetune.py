"""End-to-end run (a copy of ``examples/federated_finetune.py``):
federated fine-tuning for a few hundred client steps, comparing the four
heterogeneous-rank aggregation methods, with energy traces and a final
accuracy table.

20 rounds x 5 clients/round x 2 batches = 200 client optimization steps per
method. The model is the reduced ViT-family encoder with LoRA on all six
projection types (the paper's "all linear layers" setting).

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \
      [--rounds 20] [--device cpu]
"""
import argparse

from repro_torch.federation.experiment import build_experiment


def run(method: str, rounds: int, seed: int = 0, device=None,
        base_params=None):
    exp = build_experiment(
        method,
        fl_overrides={"num_rounds": rounds, "num_clients": 20,
                      "participation": 0.25, "seed": seed},
        num_classes=20, d_model=128, samples_per_class=100,
        batches_per_round=2, device=device, base_params=base_params)
    exp.server.run(rounds)
    return {
        "accuracy": exp.eval_accuracy(),
        "final_loss": exp.server.history[-1].mean_client_loss,
        "higher_rank_energy": (float(exp.server.energy.higher_rank_ratio[-1])
                               if exp.server.energy.rho_r1 else float("nan")),
        "collapsed": (exp.server.energy.collapsed()
                      if exp.server.energy.rho_r1 else None),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--methods", default="hetlora,flora,flexlora,raflora")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    args = ap.parse_args(argv)

    print(f"{'method':10s} {'accuracy':>9s} {'loss':>8s} "
          f"{'1-rho_r1':>9s} {'collapsed':>10s}")
    for method in args.methods.split(","):
        r = run(method, args.rounds, device=args.device)
        print(f"{method:10s} {r['accuracy']:9.3f} {r['final_loss']:8.3f} "
              f"{r['higher_rank_energy']:9.3f} {str(r['collapsed']):>10s}")


if __name__ == "__main__":
    main()
