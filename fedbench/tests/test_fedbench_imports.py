"""What a run loads: no module whose top-level name is JAX's, Flax's or
the JAX package's (``repro``; ``repro_torch`` is the port and passes,
names being compared whole), and nothing of the port in the reference."""
import ast
import os
import subprocess
import sys

from fedbench import harness

REF = os.path.join(harness.HERE, "reference")
RUN_ALL = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
from fedbench import harness
from fedbench.tests import tiny
harness.run_cell("vit_base.local_epoch", 3, 0.01, True, device="cpu",
                 cfg=tiny.vit_config(),
                 traffic=tiny.round_traffic("paper_cohort"))
harness.run_cell("nemotron_4_340b.prefill_heavy", 3, 0.01, True,
                 device="cpu", cfg=tiny.decoder_config(),
                 traffic=tiny.serve_traffic("prefill_heavy"))
import fedbench.run, fedbench.calibrate
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = _loaded(RUN_ALL.format(root=harness.ROOT,
                                 src=os.path.join(harness.ROOT, "src")))
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys\nsys.path[:0] = [{harness.ROOT!r}]\n"
            "import fedbench.reference.vit, fedbench.reference.decoder\n"
            "import fedbench.workload, fedbench.counts\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    top = _loaded(code)
    assert not top & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_reference_sources_import_nothing_of_the_port():
    for name in sorted(os.listdir(REF)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "repro", "repro_torch"), \
                    (name, m)
                if m.split(".")[0] == "fedbench":
                    assert m in ("fedbench.reference", "fedbench.workload",
                                 "fedbench.counts") or \
                        m.startswith("fedbench.reference."), (name, m)


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxish.sub", sys)
    assert set(harness.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
