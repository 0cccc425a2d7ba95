"""Command-line entry points of the port's audit and verify layer, each
run as ``python -m repro_torch.tools.<name>``:

  verify_protocol  the protocol model check, its controls and the
                   determinism lint over the round and serving sources
  lint_programs    the engine x backend x method matrix through the op
                   lint, the dispatch audit and the CUDA lint
  certify_scaling  scaling exponents over size ladders against the
                   contract catalog
  bench_trend      the trend guard over the port's bench artifacts
  ci               the ``lint``, ``certify`` and ``verify`` tiers

Each audit tool writes ``build/audit_torch/AUDIT_<name>.json`` (a
directory git ignores) and exits 1 on any finding or dead control.
"""
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
AUDIT_DIR = ROOT / "build" / "audit_torch"


def audit_path(name: str) -> str:
    """Default report path of one tool:
    ``build/audit_torch/AUDIT_<name>.json``."""
    return str(AUDIT_DIR / f"AUDIT_{name}.json")
