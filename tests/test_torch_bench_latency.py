"""The port's round-latency studies (``repro_torch.benchmarks.
bench_round_latency``) held to the JAX package's on the CPU, one timed
round a study from the weights of the JAX study's own experiments (see
``test_torch_benches.py``): the same rows and artifact keys, the
transport's bytes and the momentum audit exactly, the event sweep's fires
and virtual times exactly and its final energies at atol 1e-3. Times are
not compared; both packages write their artifacts into a temporary
directory. The engines' studies are here, the buffered server's (async,
transport, event) in ``test_torch_bench_latency_buffered.py``."""
import json

import pytest
import torch
import torch.distributed as dist

import benchmarks.bench_round_latency as j_latency
import benchmarks.common as j_common
from repro_torch.benchmarks import bench_round_latency as t_latency
from repro_torch.benchmarks import common as t_common
from test_torch_benches import recorder  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.fixture
def latency(recorder, monkeypatch, tmp_path):
    """Both packages' round-latency benches writing into ``tmp_path``, the
    port's ``_make`` starting from the JAX ``_make``'s weights."""
    monkeypatch.setattr(j_latency, "ARTIFACT", str(tmp_path / "j.json"))
    monkeypatch.setattr(j_latency, "ROOT_ARTIFACT",
                        str(tmp_path / "j_root.json"))
    monkeypatch.setattr(t_latency, "ARTIFACT", str(tmp_path / "t.json"))
    real = t_latency._make

    def make(engine, **kw):
        return real(engine, **{**kw, "device": "cpu",
                               "base_params": recorder.pop()})
    monkeypatch.setattr(t_latency, "_make", make)
    return tmp_path


def _names():
    return ([r["name"] for r in t_common.ROWS],
            [r["name"] for r in j_common.ROWS])


# where each study's result lands in the artifact (None: the top level)
SECTIONS = {"run": None, "run_kernel_backend": "kernel_backend",
            "run_sharded": "sharded", "run_async": "async",
            "run_transport": "transport"}


@pytest.mark.parametrize("study,kw", [
    ("run", dict(rounds=1, warmup=0)),
    ("run_kernel_backend", dict(rounds=1, warmup=0)),
    ("run_sharded", dict(rounds=1, warmup=0)),
], ids=["engines", "kernel_backend", "sharded"])
def test_round_latency_study_matches_reference(study, kw, latency):
    """One timed round per engine: the same rows and artifact keys.
    ``run_kernel_backend`` includes its sharded half on both sides: the
    reference on its one-device mesh, the port on a one-rank group, which
    it destroys after. ``run_sharded``: the reference sweeps the devices
    this process sees (one); the port spawns a gloo group of S ranks for
    each S that fits, 1 and 2 on the CPU, so it adds the S 2 row. The
    buffered server's studies are in ``test_torch_bench_latency_buffered.py``
    (one file a worker under the tier-1 run's ``--dist loadfile``)."""
    check_study(study, kw, latency)


def check_study(study, kw, latency):
    """Runs ``study`` of both packages with ``kw``: the same rows and
    artifact keys; the transport's bytes exactly; the momentum audit's
    counts equal."""
    j_res = getattr(j_latency, study)(**kw)
    t_res = getattr(t_latency, study)(device="cpu", **kw)
    assert not dist.is_initialized()       # no study leaves a group behind
    t_names, j_names = _names()
    j_keys = set(j_res["median_s"])
    if study == "run_sharded":
        assert j_res["shard_counts"] == [1]
        assert t_res["shard_counts"] == [1, 2]
        assert t_res.keys() == j_res.keys()
        assert t_res["config"].keys() - {"device"} == \
            j_res["config"].keys() - {"device_count"}
        j_names = j_names + ["round_latency/sharded_2"]
        j_keys.add("2")
    assert t_names == j_names
    assert t_res["median_s"].keys() == j_keys
    if study == "run_transport":
        assert t_res["bytes_per_round"] == j_res["bytes_per_round"]
    if study == "run_async":
        assert t_res["momentum_dispatch_audit"] == \
            j_res["momentum_dispatch_audit"]
    saved = json.loads((latency / "t.json").read_text())
    section = SECTIONS[study]
    assert (saved[section] if section else saved)["median_s"] == \
        t_res["median_s"]
