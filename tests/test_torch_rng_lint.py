"""The port's determinism lint (``repro_torch.analysis.rng_lint``): the
reference's broken host sources give the same rule ids through both
packages, every round-path and serving-path file of the port is clean,
and the port's own rule -- torch sampling without an explicit generator,
or a reseed of the global one -- trips on its controls and stays silent
on generator-driven draws and waived lines."""
import os

import pytest
import torch

from repro_torch.analysis import rng_lint
from repro_torch.analysis.rng_lint import lint_host_source
from repro_torch.tools import verify_protocol

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BROKEN = ("BROKEN_HOST_CLOCK", "BROKEN_UNSEEDED", "BROKEN_SEED_COLLISION",
          "BROKEN_SET_ITERATION", "BROKEN_HOST_KEY_REUSE")


def _rules(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("name", BROKEN)
def test_reference_controls_give_same_rules(name):
    from repro.analysis import rng_lint as ref
    src = getattr(ref, name)
    want = _rules(ref.lint_host_source("broken.py", src)[0])
    assert want
    assert _rules(lint_host_source("broken.py", src)[0]) == want
    # the port's own copy of the control is the reference's
    assert getattr(rng_lint, name) == src


@pytest.mark.parametrize(
    "path", verify_protocol.ROUND_PATH_FILES
    + verify_protocol.SERVING_PATH_FILES)
def test_port_round_and_serving_files_are_clean(path):
    with open(os.path.join(_ROOT, path)) as fh:
        findings, stats = lint_host_source(path, fh.read())
    assert findings == [], findings
    assert stats["ast_nodes"] > 0


@pytest.mark.parametrize("src", [
    rng_lint.BROKEN_TORCH_GLOBAL_RNG, rng_lint.BROKEN_TORCH_MANUAL_SEED,
    "import torch\ndef f(x):\n    return torch.cuda.manual_seed_all(3)\n",
    "import torch\ndef f(x):\n    return torch.rand_like(x)\n",
    "import torch\ndef f(x):\n    return torch.randperm(5)\n",
    "import torch\ndef f(w):\n    w.normal_(0.0, 0.02)\n",
    "import torch\ndef f(w):\n    torch.nn.init.uniform_(w)\n"],
    ids=["randn", "manual_seed", "cuda_seed_all", "rand_like", "randperm",
         "normal_", "init_uniform_"])
def test_torch_global_generator_trips(src):
    findings, _ = lint_host_source("broken.py", src)
    assert _rules(findings) == {"rng-torch-global-generator"}


def test_torch_generator_draws_are_silent():
    clean = (
        "import torch\n"
        "def f(x, seed):\n"
        "    g = torch.Generator().manual_seed(seed)\n"
        "    a = torch.randn(3, generator=g)\n"
        "    b = torch.randint(0, 9, (4,), generator=g)\n"
        "    x.normal_(0.0, 1.0, generator=g)\n"
        "    z = torch.zeros_like(x) + torch.ones_like(x)\n"
        "    return a, b, z\n"
    )
    assert lint_host_source("clean.py", clean)[0] == []


def test_torch_rule_waiver_suppresses():
    src = rng_lint.BROKEN_TORCH_GLOBAL_RNG.replace(
        "torch.randn(3)", "torch.randn(3)  # rng: ok (test fixture)")
    assert lint_host_source("waived.py", src)[0] == []
