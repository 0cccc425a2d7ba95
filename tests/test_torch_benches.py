"""The port's paper benchmarks (``repro_torch.benchmarks``) and examples
held to the JAX package's (``benchmarks``, ``examples``) on the CPU: each
bench at one round, from the weights of the JAX bench's own experiment
(recorded as the JAX bench builds it), row names letter for letter,
energy ratios at atol 1e-3 (round parity, ``test_torch_round.py``) and
accuracies within one test sample; wall-clock times are not compared.
The sweeps run one case a sub-bench (the round-latency studies:
``test_torch_bench_latency.py``). Table 3's communication rows are
exactly equal; ``Model.param_shapes`` equals the reference's leaf for
leaf; the theory demo prints the reference's table."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import benchmarks.bench_accuracy as j_accuracy
import benchmarks.bench_cost as j_cost
import benchmarks.bench_energy_dynamics as j_energy
import benchmarks.bench_kernels as j_kernels
import benchmarks.bench_sensitivity as j_sensitivity
import benchmarks.common as j_common
import repro.federation.experiment as j_experiment
from repro.core.lora import merge_lora as j_merge
from repro.kernels import ref as j_ref
from repro_torch.benchmarks import bench_accuracy as t_accuracy
from repro_torch.benchmarks import bench_cost as t_cost
from repro_torch.benchmarks import bench_energy_dynamics as t_energy
from repro_torch.benchmarks import bench_kernels as t_kernels
from repro_torch.benchmarks import bench_sensitivity as t_sensitivity
from repro_torch.benchmarks import common as t_common
from repro_torch.benchmarks import run as t_run
from repro_torch.convert import params_from_numpy
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

ENERGY_ATOL = 1e-3 + 1e-4        # round parity, plus the rows' 4 decimals


class Recorder:
    """Records the starting weights of every experiment the JAX package
    builds (in build order), and hands them to the port's builds in the
    same order."""

    def __init__(self, monkeypatch):
        self.weights = []
        self.n_test = []
        real = j_experiment.build_experiment

        def build(method, **kw):
            exp = real(method, **kw)
            params = jax.tree.map(np.asarray, j_merge(
                exp.server.base, exp.server.global_lora))
            self.weights.append(params_from_numpy(params, "cpu"))
            self.n_test.append(len(exp.test_batch["targets"]))
            return exp
        monkeypatch.setattr(j_experiment, "build_experiment", build)

    def pop(self) -> dict:
        return self.weights.pop(0)

    def quick_fl(self, method, **kw):
        """The port's ``quick_fl`` from the next recorded JAX weights."""
        return t_common.quick_fl(
            method, **{**kw, "device": "cpu", "base_params": self.pop()})


@pytest.fixture
def recorder(monkeypatch):
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    yield Recorder(monkeypatch)
    j_common.ROWS.clear()
    t_common.ROWS.clear()


def _rows(rows):
    return {r["name"]: r for r in rows}


def _check_accuracy(t_row, j_row, n_test):
    """Accuracies within one test sample (plus the rows' 4 decimals)."""
    diff = abs(float(t_row["derived"]) - float(j_row["derived"]))
    assert diff <= 1.0 / n_test + 1e-4, (t_row, j_row)


def test_energy_dynamics_matches_reference(recorder, monkeypatch):
    monkeypatch.setattr(t_energy, "quick_fl", recorder.quick_fl)
    j_energy.run(rounds=1)
    t_energy.run(rounds=1, device="cpu")
    jr, tr = _rows(j_common.ROWS), _rows(t_common.ROWS)
    assert list(tr) == list(jr)
    for name, j in jr.items():
        t = tr[name]
        for key in ("derived", "round0"):
            assert abs(float(t[key]) - float(j[key])) <= ENERGY_ATOL
        assert t["breakdown"].keys() == j["breakdown"].keys()
        for part, v in j["breakdown"].items():
            assert abs(t["breakdown"][part] - v) <= ENERGY_ATOL


def test_accuracy_matches_reference(recorder, monkeypatch):
    monkeypatch.setattr(t_accuracy, "quick_fl", recorder.quick_fl)
    j_res = j_accuracy.run(rounds=1, seeds=(0,))
    n_test = recorder.n_test[0]
    t_res = t_accuracy.run(rounds=1, seeds=(0,), device="cpu")
    assert list(t_res) == list(j_res)
    jr, tr = _rows(j_common.ROWS), _rows(t_common.ROWS)
    assert list(tr) == list(jr)
    for name, j in jr.items():
        _check_accuracy(tr[name], j, n_test)


class _Skipped:
    """Stands in for an experiment a sweep's other cases would build."""

    def eval_accuracy(self):
        return float("nan")

    class server:
        class energy:
            higher_rank_ratio = [float("nan")]


# the one case run of each sub-bench (its index in the sweep's loop)
SENSITIVITY_CASES = {
    "bench_noniid": 3,             # alpha 0.1, raflora
    "bench_participation": 3,      # participation 0.5, raflora
    "bench_rank_configs": 1,       # conf1 (rank levels 1, 8, 32), raflora
    "bench_rank_dists": 5,         # high_skew, raflora
    "bench_partial_variants": 0,   # raflora-a (partial up to 8)
    "bench_noisy_clients": 3,      # nu 0.5, raflora
}


def _one_case(quick_fl, index):
    calls = []

    def wrapped(method, **kw):
        calls.append(method)
        if len(calls) - 1 != index:
            return _Skipped(), 0.0
        return quick_fl(method, **kw)
    return wrapped


@pytest.mark.parametrize("sub", list(SENSITIVITY_CASES))
def test_sensitivity_case_matches_reference(sub, recorder, monkeypatch):
    index = SENSITIVITY_CASES[sub]
    monkeypatch.setattr(j_sensitivity, "ROUNDS", 1)
    monkeypatch.setattr(t_sensitivity, "ROUNDS", 1)
    monkeypatch.setattr(j_sensitivity, "quick_fl",
                        _one_case(j_common.quick_fl, index))
    monkeypatch.setattr(t_sensitivity, "quick_fl",
                        _one_case(recorder.quick_fl, index))
    getattr(j_sensitivity, sub)()
    n_test = recorder.n_test[0]
    getattr(t_sensitivity, sub)(device="cpu")
    assert [r["name"] for r in t_common.ROWS] == \
        [r["name"] for r in j_common.ROWS]
    j, t = j_common.ROWS[index], t_common.ROWS[index]
    _check_accuracy(t, j, n_test)
    if "higher_rank" in j:
        assert abs(float(t["higher_rank"]) - float(j["higher_rank"])) \
            <= ENERGY_ATOL


def test_sensitivity_runs_every_sub_bench():
    assert [f.__name__ for f in t_sensitivity.SUB_BENCHES] == \
        list(SENSITIVITY_CASES)


def test_cost_matches_reference(monkeypatch):
    """Table 3's bytes exactly equal at vit-base and llama3.1-8b for all
    four methods; the aggregation rows named alike (one untimed call a
    backend on both sides), and the kernel
    backend's aggregate (its plain versions on the CPU) held to the dense
    and factored backends and to the JAX factored backend on the same
    factors (spectra at 1e-3, products at 2e-3 of sigma_max)."""
    from repro.core import Aggregator as JAggregator
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    monkeypatch.setattr(j_cost, "timed", lambda fn, **kw: (None, 0.0))
    monkeypatch.setattr(t_cost, "timed", lambda fn, **kw: (fn(), 1.0))
    j_cost.run()
    results = t_cost.run(device="cpu")
    j_rows, t_rows = list(j_common.ROWS), list(t_common.ROWS)
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    assert [r["name"] for r in t_rows] == [r["name"] for r in j_rows]
    comm = [(r["name"], r["us_per_call"], r["derived"]) for r in j_rows
            if r["name"].startswith("table3_comm/")]
    assert len(comm) == 8
    assert [(r["name"], r["us_per_call"], r["derived"]) for r in t_rows
            if r["name"].startswith("table3_comm/")] == comm
    factors, ranks, n_k, gb, ga = t_cost.layer_inputs(
        torch.device("cpu"), t_cost.LoRAConfig())
    want = JAggregator("raflora", t_cost.LoRAConfig().rank_levels,
                       backend="factored").aggregate_layer(
        [(x.numpy(), y.numpy()) for x, y in factors], ranks, n_k,
        gb.numpy(), ga.numpy())
    sigma = np.asarray(want.sigma)
    scale = float(sigma.max())
    product = np.asarray(want.b_g) @ np.asarray(want.a_g)
    for backend, res in results.items():
        np.testing.assert_allclose(res.sigma.numpy(), sigma,
                                   atol=1e-3 * scale)
        np.testing.assert_allclose((res.b_g @ res.a_g).numpy(), product,
                                   atol=2e-3 * scale)


@pytest.mark.parametrize("arch", ["vit-base", "llama3.1-8b"])
def test_param_shapes_match_reference(arch):
    """Leaf for leaf (path, shape, dtype), and all on the meta device:
    nothing is allocated, even at llama3.1-8b's 8 B parameters."""
    import jax.numpy as jnp
    from repro.configs import LoRAConfig as JLoRA
    from repro.configs import get_config as j_get
    from repro.models import build_model
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten
    from repro_torch.models.transformer import Model
    want = {tuple(str(getattr(k, "key", k)) for k in p): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(
                build_model(j_get(arch), JLoRA(), dtype=jnp.float32,
                            remat=False).param_shapes())}
    got = flatten(Model(get_config(arch), LoRAConfig(),
                        device="cpu").param_shapes())
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        assert got[path].device.type == "meta", path


def test_kernels_bench_matches_reference(monkeypatch):
    """The reference's five rows by name (its entries swapped for its
    oracles and its SVD reallocations stubbed, one call a row: only the
    names are compared), and each of the port's kernel rows (the kernel
    API on the CPU) held, on the row's own inputs as numpy, to the
    reference's oracles ``ref.lora_apply_ref``,
    ``ref.rank_partition_agg_ref`` and ``ref.ssd_scan_sequential_ref``
    within ``chip_smoke.py``'s tolerances for that kernel: K5 and K3 at
    (depth + slack) f32 roundings of the products' magnitude, K6 (the
    chunked scan against the sequential recurrence) atol 2e-4, rtol
    1e-3. The row's own oracle (the port's plain version) is held to the
    same."""
    import types
    j_common.ROWS.clear()
    t_common.ROWS.clear()

    def once(fn, *a, repeats=1, **kw):
        return fn(*a, **kw), 1.0
    monkeypatch.setattr(j_kernels, "timed", once)
    monkeypatch.setattr(j_kernels, "ops", types.SimpleNamespace(
        lora_apply=j_ref.lora_apply_ref,
        rank_partition_agg=j_ref.rank_partition_agg_ref,
        ssd_scan=lambda *a, chunk: j_ref.ssd_scan_sequential_ref(*a)))
    import repro.core.svd as j_svd
    for name in ("svd_realloc_dense", "svd_realloc_factored"):
        monkeypatch.setattr(j_svd, name, lambda *a: (None, None, None))
    # the SVD rows report times only: a small shape on the CPU
    monkeypatch.setattr(t_kernels, "SVD", (256, 256, 32))
    j_kernels.run()
    out = t_kernels.run(device="cpu")
    j_names = [r["name"] for r in j_common.ROWS]
    t_names = [r["name"] for r in t_common.ROWS]
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    assert t_names == j_names

    def jax_args(row):
        return [v.numpy() if isinstance(v, torch.Tensor) else v
                for v in out[row]["args"]]

    def within(row, want, atol):
        case = out[row]
        for got in (case["got"], case["want"]):
            assert float(np.abs(got.numpy() - want).max()) <= atol, row
    eps = torch.finfo(torch.float32).eps
    x, w, a, b, s = out["kernel/lora_apply_512"]["args"]
    mag = t_kernels.lora_apply_plain(x.abs(), w.abs(), a.abs(), b.abs(), s)
    within("kernel/lora_apply_512",
           np.asarray(j_ref.lora_apply_ref(*jax_args(
               "kernel/lora_apply_512"))),
           (x.shape[1] + a.shape[0]) * eps * float(mag.max()))
    bs, as_, om = out["kernel/rank_partition_agg_768"]["args"]
    mag = t_kernels.rank_partition_agg_plain(bs.abs(), as_.abs(), om.abs())
    within("kernel/rank_partition_agg_768",
           np.asarray(j_ref.rank_partition_agg_ref(*jax_args(
               "kernel/rank_partition_agg_768"))),
           (om.numel() + 2) * eps * float(mag.max()))
    y_ref, _ = j_ref.ssd_scan_sequential_ref(*jax_args("kernel/ssd_scan_256"))
    case = out["kernel/ssd_scan_256"]
    for got in (case["got"], case["want"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(y_ref),
                                   atol=2e-4, rtol=1e-3)


def test_sequential_scan_matches_reference_oracle():
    """``ssd_scan_sequential_plain`` (bench_kernels' K6 oracle) against
    ``ref.ssd_scan_sequential_ref`` on the same inputs, groups and an
    initial state included."""
    import jax.numpy as jnp
    from repro_torch.kernels.ssd_scan import ssd_scan_sequential_plain
    rng = np.random.default_rng(0)
    bsz, length, h, p, g, n = 2, 24, 4, 6, 2, 5
    arrs = [rng.normal(size=(bsz, length, h, p)),
            np.log1p(np.exp(rng.normal(size=(bsz, length, h)))),
            0.5 * rng.normal(size=(h,)),
            0.3 * rng.normal(size=(bsz, length, g, n)),
            0.3 * rng.normal(size=(bsz, length, g, n)),
            rng.normal(size=(h,)), rng.normal(size=(bsz, h, p, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    y_j, s_j = j_ref.ssd_scan_sequential_ref(
        *[jnp.asarray(a) for a in arrs[:6]], init_state=jnp.asarray(arrs[6]))
    y_t, s_t = ssd_scan_sequential_plain(
        *[torch.from_numpy(a) for a in arrs[:6]],
        init_state=torch.from_numpy(arrs[6]))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5,
                               rtol=1e-5)


def test_run_keeps_reference_bench_keys():
    """The same ``BENCHES`` keys and ``QUICK`` subset as ``benchmarks.run``
    (the unported two refuse: ``test_torch_imports.py``)."""
    import benchmarks.run as j_run
    assert t_run.BENCHES.keys() == j_run.BENCHES.keys()
    assert t_run.QUICK == j_run.QUICK


def test_rank_collapse_demo_prints_reference_table():
    import examples.rank_collapse_demo as j_demo
    from repro_torch.examples import rank_collapse_demo as t_demo
    outs = []
    for demo in (j_demo, t_demo):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            demo.main()
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    assert "Theorem 1 constants" in outs[0]


def test_federated_finetune_matches_reference(recorder):
    """``examples/federated_finetune.run`` at one round from the JAX
    run's weights: loss rtol 1e-4, higher-rank energy atol 1e-3, accuracy
    within one test sample, the same collapse verdict."""
    import examples.federated_finetune as j_ft
    from repro_torch.examples import federated_finetune as t_ft
    want = j_ft.run("raflora", 1)
    got = t_ft.run("raflora", 1, device="cpu", base_params=recorder.pop())
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    assert abs(got["higher_rank_energy"] - want["higher_rank_energy"]) \
        <= 1e-3
    assert abs(got["accuracy"] - want["accuracy"]) * recorder.n_test[0] \
        <= 1 + 1e-9
    assert got["collapsed"] == want["collapsed"]


@pytest.mark.parametrize("example,argv,expect", [
    ("quickstart", ["--device", "cpu"], "test accuracy"),
    ("federated_finetune",
     ["--device", "cpu", "--rounds", "1", "--methods", "flexlora"],
     "collapsed")], ids=["quickstart", "federated_finetune"])
def test_example_runs_on_cpu_on_request(example, argv, expect):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    assert expect in buf.getvalue()
