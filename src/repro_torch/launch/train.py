"""Federated fine-tuning launcher (the end-to-end trainer), ported from
``repro/launch/train.py`` with the same flags, defaults and JSON log,
plus ``--device`` (default: the card; ``cpu`` runs the plain PyTorch
path on request, and without CUDA the default raises).

Runs heterogeneous-rank FedLoRA on the synthetic non-IID task with any of
the five aggregation methods.

  PYTHONPATH=src python -m repro_torch.launch.train --method raflora \
      --rounds 20
  PYTHONPATH=src python -m repro_torch.launch.train --method flexlora \
      --rounds 20 --noniid dirichlet --alpha 0.1 --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="raflora",
                    choices=["fedavg", "hetlora", "flora", "flexlora",
                             "raflora"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--participation", type=float, default=0.25)
    ap.add_argument("--noniid", default="pathological",
                    choices=["iid", "dirichlet", "pathological"])
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--rank-levels", default="4,8,16,24,32")
    ap.add_argument("--backend", default="factored",
                    choices=["dense", "factored", "kernel"])
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda)")
    return ap.parse_args(argv)


def experiment_args(args: argparse.Namespace) -> dict:
    """``build_experiment``'s keyword arguments for these flags (the
    reference's, so its package builds the same experiment from them)."""
    levels = tuple(int(r) for r in args.rank_levels.split(","))
    return dict(
        fl_overrides={"num_rounds": args.rounds, "num_clients": args.clients,
                      "participation": args.participation,
                      "partition": args.noniid,
                      "dirichlet_alpha": args.alpha, "seed": args.seed},
        lora_overrides={"rank_levels": levels,
                        "rank_probs": tuple([1 / len(levels)] * len(levels))},
        backend=args.backend)


def train(exp, rounds: int, eval_every: int = 5,
          checkpoint: Optional[str] = None,
          out: Optional[str] = None) -> List[dict]:
    """The round loop on a built experiment: one log row a round, test
    accuracy every ``eval_every`` rounds and at the last, then the
    checkpoint (``server.save``) and the JSON log."""
    log = []
    t0 = time.time()
    for r in range(rounds):
        stats = exp.server.run_round()
        row = {"round": r, "loss": stats.mean_client_loss,
               "higher_rank_energy": float(
                   exp.server.energy.higher_rank_ratio[-1]),
               "lr": stats.lr, "wall_s": stats.wall_time_s}
        if (r + 1) % eval_every == 0 or r == rounds - 1:
            row["test_accuracy"] = exp.eval_accuracy()
        log.append(row)
        msg = (f"round {r:3d} loss={row['loss']:.4f} "
               f"1-rho={row['higher_rank_energy']:.3f}")
        if "test_accuracy" in row:
            msg += f" acc={row['test_accuracy']:.3f}"
        print(msg, flush=True)
    print(f"done in {time.time() - t0:.1f}s; "
          f"final acc={log[-1].get('test_accuracy'):.3f}")
    if checkpoint:
        exp.server.save(checkpoint)
        print(f"checkpoint -> {checkpoint}")
    if out:
        with open(out, "w") as f:
            json.dump(log, f, indent=1)
    return log


def main(argv=None, base_params: Optional[dict] = None) -> int:
    """``base_params``: the starting weights (a full tree, e.g. another
    package's), else drawn from the seed."""
    args = parse_args(argv)
    from repro_torch.federation.experiment import build_experiment
    exp = build_experiment(args.method, device=args.device,
                           base_params=base_params, **experiment_args(args))
    train(exp, args.rounds, args.eval_every, args.checkpoint, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
