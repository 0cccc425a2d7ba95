"""The port's audit tiers of ``tools/ci.sh``: deterministic and offline.

    PYTHONPATH=src python -m repro_torch.tools.ci lint [--fast]
    PYTHONPATH=src python -m repro_torch.tools.ci certify [--fast]
    PYTHONPATH=src python -m repro_torch.tools.ci verify [--fast]

  lint     the program-audit sweep (``lint_programs``): op lint, dispatch
           audit and CUDA lint over the engine x backend x method matrix;
           ``--fast`` is ``lint-fast``: the lint without the dispatch
           audit plus the certifier on reduced ladders, in one process
  certify  the complexity-certifier sweep (``certify_scaling``);
           ``--fast`` on reduced ladders
  verify   the protocol-verification sweep (``verify_protocol``);
           ``--fast`` on reduced grids and scenarios

Full tiers write ``build/audit_torch/AUDIT_<name>.json``; ``--fast``
tiers write to a temporary directory, removed after. The lint and the
certifier's device rows run on the card unless ``--device cpu`` is
given. The exit status is the worse of the tier's sweeps: 0 green with
every control tripped, 1 otherwise.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tier", choices=("lint", "certify", "verify"))
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the lint and the certifier's device rows "
                         "run: the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    from repro_torch.tools import certify_scaling, lint_programs, \
        verify_protocol
    with tempfile.TemporaryDirectory(prefix="audit_torch_") as tmp:
        def out(name):
            return (["--out", os.path.join(tmp, f"AUDIT_{name}.json")]
                    if args.fast else [])
        fast = ["--fast"] if args.fast else []
        if args.tier == "verify":
            return verify_protocol.main(fast + out("protocol"))
        dev = [] if args.device is None else ["--device", args.device]
        if args.tier == "lint" and not args.fast:
            return lint_programs.main(dev)
        rc = 0
        if args.tier == "lint":
            rc = lint_programs.main(["--skip-dispatch"] + dev
                                    + out("program_lint"))
        return max(rc, certify_scaling.main(fast + dev + out("scaling")))


if __name__ == "__main__":
    sys.exit(main())
