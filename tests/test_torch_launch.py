"""The port's training launcher (``repro_torch.launch.train``) held to the
reference's (``repro.launch.train``): two rounds at the launcher's
defaults from the same weights, on the factored backend (the default) and
on the kernel backend, at the round-parity tolerances of
``test_torch_round.py`` (loss rtol 1e-4, higher-rank energy atol 1e-3 a
round) and test accuracy within one of the test samples; the rows carry
the same keys. Also the launcher's device policy, and its checkpoint."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.lora import merge_lora as j_merge
from repro.federation.experiment import build_experiment as j_build
from repro.launch import train as j_train
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as t_train
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

ROUNDS = ["--rounds", "2"]


@pytest.fixture
def jax_experiments(monkeypatch):
    """Every experiment the reference launcher builds, kept as it is
    built (before its first round)."""
    import repro.federation.experiment as j_experiment
    built = []

    def build(method, **kw):
        exp = j_build(method, **kw)
        params = jax.tree.map(np.asarray, j_merge(exp.server.base,
                                                  exp.server.global_lora))
        built.append((params_from_numpy(params, "cpu"), exp.test_batch))
        return exp
    monkeypatch.setattr(j_experiment, "build_experiment", build)
    return built


@pytest.mark.parametrize("backend", ["factored", "kernel"])
def test_launcher_matches_reference(backend, tmp_path, jax_experiments):
    argv = ROUNDS + ["--backend", backend]
    j_out, t_out = tmp_path / "jax.json", tmp_path / "torch.json"
    assert j_train.main(argv + ["--out", str(j_out)]) == 0
    (base, test_batch), = jax_experiments
    assert t_train.main(argv + ["--device", "cpu", "--out", str(t_out)],
                        base_params=base) == 0
    jrows, trows = json.loads(j_out.read_text()), json.loads(
        t_out.read_text())
    assert [list(r) for r in trows] == [list(r) for r in jrows]
    assert "test_accuracy" in trows[-1]
    n_test = len(test_batch["targets"])
    for j, t in zip(jrows, trows):
        assert t["round"] == j["round"] and t["lr"] == pytest.approx(j["lr"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["higher_rank_energy"],
                                   j["higher_rank_energy"], atol=1e-3)
        if "test_accuracy" in j:
            assert abs(t["test_accuracy"] - j["test_accuracy"]) * n_test \
                <= 1 + 1e-9


def test_checkpoint_restores_the_trained_server(tmp_path):
    """``--checkpoint`` writes ``server.save``'s files; a fresh server
    restored from them holds the same global adapters."""
    from repro_torch.core.lora import flatten
    from repro_torch.federation.experiment import build_experiment
    ckpt = str(tmp_path / "ckpt")
    argv = ["--rounds", "1", "--clients", "8", "--rank-levels", "4,8",
            "--device", "cpu"]
    args = t_train.parse_args(argv)
    exp = build_experiment(args.method, device="cpu", d_model=32,
                           samples_per_class=10, num_classes=4,
                           **t_train.experiment_args(args))
    log = t_train.train(exp, args.rounds, checkpoint=ckpt)
    assert len(log) == 1 and "test_accuracy" in log[0]
    fresh = build_experiment(args.method, device="cpu", d_model=32,
                             samples_per_class=10, num_classes=4,
                             **t_train.experiment_args(args))
    fresh.server.restore(ckpt)
    want, got = flatten(exp.server.global_lora), flatten(
        fresh.server.global_lora)
    assert want.keys() == got.keys()
    for path, x in want.items():
        assert torch.equal(got[path], x), path


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--rounds", "1"])
