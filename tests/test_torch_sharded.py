"""The port's sharded round engine (``round_engine="sharded"`` on
``torch.distributed``) and the kernel API's leading-axis entries of K1
and K2, held to the reference on the CPU.

* ``ops.factored_stack_lead`` / ``ops.factored_gram_lead`` against the
  reference's ``svd.factored_stack_batched`` and its Gram oracle, with
  batch axes (P, L) and with none.
* The sharded engine without a group makes a one-rank group and
  ``close`` destroys it; ``make_fl_mesh`` refuses a group whose backend
  does not fit the device.
* A world-1 gloo group in this process (a module fixture, destroyed at
  teardown): the port's sharded engine against the JAX sharded engine on
  its one-device mesh, one round of each method, at
  ``test_torch_round.py``'s tolerances; against the port's sequential and
  batched engines at ``tests/test_sharded_engine.py::_assert_round_equal``'s;
  the reference's ``TestShardedFallbackPath`` on every backend, with junk
  ghost rows; and ``TestZeroBatchClient``.
* ONE two-rank gloo spawn (a module fixture; ``_torch_sharded_ranks.py``
  is what each rank runs), 5 sampled clients over 2 ranks so every round
  pads one ghost: four cases against the JAX sharded engine on a
  two-device host mesh (a subprocess, as ``tests/test_sharded_engine.py``
  runs it) and against the port's batched engine, the error-feedback
  residuals following clients across ranks, an async save / restore
  equal to the uninterrupted run, the all-reduces of a bucket, and the
  expert-parallel MoE over the ranks' model axis against one rank.

The reference's ``TestDoRAMagnitudeEquivalence`` runs at world 1 in
``test_torch_variants.py``; its two-rank case is the spawn's DoRA case
here, magnitudes at rtol 1e-4."""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharded_ranks as ranks2
from repro.core.lora import merge_lora as j_merge
from repro.core.svd import factored_stack_batched as j_stack_batched
from repro.federation.experiment import build_experiment as j_build
from repro.kernels.ref import gram_cores_ref
from repro_torch.core import collective
from repro_torch.core.aggregation import Aggregator, pad_stack
from repro_torch.core.lora import flatten
from repro_torch.federation.experiment import build_experiment as t_build
from repro_torch.kernels import ops
from repro_torch.launch import mesh as fl_mesh
from test_torch_round import (HOMOGENEOUS, SMALL, _base_leaves, _factors,
                              _magnitudes, _pair)

torch.set_num_threads(1)

# tests/test_sharded_engine.py's size: 10 clients at participation 0.5
SHARDED_SMALL = dict(SMALL, fl_overrides={"num_rounds": 1,
                                          "num_clients": 10,
                                          "participation": 0.5})


# -- K1 / K2 over any leading axes ------------------------------------------

@pytest.mark.parametrize("lead,m,d,r,n", [((2, 3), 3, 24, 8, 40),
                                          ((), 4, 30, 6, 17)],
                         ids=["PL", "none"])
def test_stack_gram_lead_match_reference(lead, m, d, r, n):
    """K1 over the batch axes equals the reference's
    ``factored_stack_batched`` bit for bit (r zero-padded to 8 on both
    sides: the entry pads r to 8), and K2 its ``gram_cores_ref`` per
    slice within 1e-5 of the largest entry."""
    rng = np.random.default_rng(3)
    bs = rng.normal(size=(m,) + lead + (d, r)).astype(np.float32)
    as_ = rng.normal(size=(m,) + lead + (r, n)).astype(np.float32)
    om = rng.uniform(size=(m, r)).astype(np.float32)
    om[0, r // 2:] = 0.0
    om[-1, 0] = -0.5
    u, v = ops.factored_stack_lead(torch.from_numpy(bs),
                                   torch.from_numpy(as_),
                                   torch.from_numpy(om))
    r8 = -(-r // 8) * 8
    pad = r8 - r
    j_u, j_v = j_stack_batched(
        np.pad(bs, [(0, 0)] * (bs.ndim - 1) + [(0, pad)]),
        np.pad(as_, [(0, 0)] * (as_.ndim - 2) + [(0, pad), (0, 0)]),
        np.pad(om, [(0, 0), (0, pad)]))
    assert u.shape == lead + (d, m * r8) and v.shape == lead + (m * r8, n)
    np.testing.assert_array_equal(u.numpy(), np.asarray(j_u))
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_v))
    g_u, g_v = ops.factored_gram_lead(u, v)
    assert g_u.shape == g_v.shape == lead + (m * r8, m * r8)
    for idx in np.ndindex(*lead):
        want_u, want_v = gram_cores_ref(np.asarray(j_u)[idx],
                                        np.asarray(j_v)[idx])
        for got, want in ((g_u[idx], want_u), (g_v[idx], want_v)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())


def test_stack_lead_dequantizes_transport_factors():
    """A ``QuantFactor`` enters K1 dequantized, as a plain stack would."""
    from repro_torch.federation.transport import TransportConfig, \
        UpdateTransport
    rng = np.random.default_rng(4)
    b = torch.from_numpy(rng.normal(size=(3, 2, 16, 8)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(3, 2, 8, 12)).astype(np.float32))
    om = torch.from_numpy(rng.uniform(size=(3, 8)).astype(np.float32))
    tr = UpdateTransport(TransportConfig(mode="int8", error_feedback=False))
    qb, qa = tr.encode_group([0, 1, 2], {("x",): (b, a)})[("x",)]
    got = ops.factored_stack_lead(qb, qa, om)
    want = ops.factored_stack_lead(ops.dequantize(qb), ops.dequantize(qa),
                                   om)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the one-rank group the engine makes -------------------------------------
# (before any test that takes ``world1``: the module fixture holds its
# group until the module ends)

def test_sharded_server_makes_and_closes_its_group():
    """Without a group, the sharded engine makes a one-rank gloo group in
    this process for the CPU, runs on it, and ``close`` destroys it; a
    server that made none leaves the group alone."""
    assert not dist.is_initialized()
    exp = t_build("raflora", device="cpu", round_engine="sharded",
                  **SHARDED_SMALL)
    other = t_build("raflora", device="cpu", round_engine="sharded",
                    **SHARDED_SMALL)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    exp.server.run(1)
    other.server.close()
    assert dist.is_initialized()
    exp.server.close()
    assert not dist.is_initialized()


# -- world 1: a one-rank gloo group in this process --------------------------

@pytest.fixture(scope="module")
def world1():
    """A one-rank gloo group over a local store, the engines' meshes
    (``make_fl_mesh``) made over it; destroyed at teardown."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_refuses_a_group_that_does_not_fit_the_device(world1,
                                                           monkeypatch):
    """A one-rank gloo group (left from a CPU run) is refused for a mesh
    on the card, which needs NCCL: gloo on CUDA tensors is taken only
    from a group of several ranks sharing the card."""
    monkeypatch.setattr(fl_mesh, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="needs nccl"):
        fl_mesh.make_fl_mesh(device="cuda")


JAX_CASES = [
    pytest.param(m, {"lora_overrides": HOMOGENEOUS} if m == "fedavg" else {},
                 id=m)
    for m in ("fedavg", "hetlora", "flora", "flexlora", "raflora", "ffa")
] + [pytest.param("raflora", {"backend": "dense"}, id="raflora-dense"),
     pytest.param("raflora", {"backend": "factored"},
                  id="raflora-factored")]


@pytest.mark.parametrize("method,kw", JAX_CASES)
def test_sharded_round_matches_jax_sharded(world1, method, kw):
    """One round of the sharded engine in both packages from the same
    weights (the reference on its one-device mesh, the port on the
    one-rank group): same clients and ranks, loss at rtol 1e-4, spectra
    and products at the kernel path's tolerances (1e-4 of the largest
    product on the dense and factored backends and the averaging family),
    base weights -- which FLoRA moves -- at rtol 1e-4, atol 1e-5."""
    kw = {**SHARDED_SMALL, **kw, "round_engine": "sharded"}
    je, te, _ = _pair(method, **kw)
    (sj,), (st,) = je.server.run(1), te.server.run(1)
    assert st.clients == sj.clients and st.ranks == sj.ranks
    np.testing.assert_allclose(st.mean_client_loss, sj.mean_client_loss,
                               rtol=1e-4)
    kernel = kw["backend"] == "kernel"
    scale = 1.0
    if sj.sigma_probe is None:
        assert st.sigma_probe is None
    else:
        scale = max(1.0, float(np.abs(sj.sigma_probe).max()))
        np.testing.assert_allclose(st.sigma_probe, sj.sigma_probe,
                                   atol=(1e-3 if kernel else 1e-4) * scale)
    fj, ft = _factors(je.server), _factors(te.server)
    assert list(ft) == list(fj)
    for parent, (b, a) in fj.items():
        want = b @ a
        tol = (2e-3 * scale if kernel and sj.sigma_probe is not None
               else 1e-4 * max(1.0, np.abs(want).max()))
        np.testing.assert_allclose(ft[parent][0] @ ft[parent][1], want,
                                   atol=tol)
    tbase, jbase = _base_leaves(te.server), _base_leaves(je.server)
    for path, x in jbase.items():
        np.testing.assert_allclose(tbase[path], x, rtol=1e-4, atol=1e-5)


def _assert_round_equal(run_a, run_b):
    """``tests/test_sharded_engine.py::_assert_round_equal``'s checks and
    tolerances on two (server, stats) runs of the port."""
    (s1, h1), (s2, h2) = run_a, run_b
    assert h1.clients == h2.clients and h1.ranks == h2.ranks
    np.testing.assert_allclose(h1.mean_client_loss, h2.mean_client_loss,
                               rtol=1e-4)
    assert (h1.sigma_probe is None) == (h2.sigma_probe is None)
    if h1.sigma_probe is not None:
        np.testing.assert_allclose(h1.sigma_probe, h2.sigma_probe,
                                   rtol=1e-4, atol=1e-4)
    f1, f2 = _factors(s1), _factors(s2)
    for parent, (b, a) in f1.items():
        d1, d2 = b @ a, f2[parent][0] @ f2[parent][1]
        np.testing.assert_allclose(d1, d2,
                                   atol=1e-4 * max(1.0, np.abs(d1).max()))
    b1, b2 = _base_leaves(s1), _base_leaves(s2)
    for path, x in b1.items():
        np.testing.assert_allclose(x, b2[path], rtol=1e-4, atol=1e-5)


def _port_rounds(method, engines, batch_fn=None, **kw):
    """{engine: (server, stats)}: one round of each engine from the
    weights the first one drew."""
    args = {**SHARDED_SMALL, "backend": "factored", **kw}
    runs, base = {}, None
    for engine in engines:
        exp = t_build(method, device="cpu", round_engine=engine,
                      base_params=base, **args)
        base = base or exp.server.global_params()
        if batch_fn is not None:
            exp.server.batch_fn = batch_fn(exp.server.batch_fn)
        runs[engine] = (exp.server, exp.server.run(1)[0])
    return runs


@pytest.mark.parametrize("other", ["sequential", "batched"])
@pytest.mark.parametrize("backend", ["factored", "kernel"])
def test_sharded_matches_port_engines(world1, other, backend):
    """raFLoRA's sharded round against the port's sequential and batched
    rounds from the same weights."""
    runs = _port_rounds("raflora", (other, "sharded"), backend=backend)
    _assert_round_equal(runs[other], runs["sharded"])


@pytest.mark.parametrize("backend", ["dense", "factored", "kernel"])
def test_sharded_fallback_matches_eager_reference(world1, backend):
    """``TestShardedFallbackPath``: the Eq. 8 fallback through
    ``aggregate_grouped_sharded`` is appended once, after the reduction.
    One real client (rank 4 of levels (4, 8)) and a ghost of junk factor
    rows at n_k = 0, which the zero weights must cancel exactly, against
    ``aggregate_layer`` on the real client alone."""
    gen = torch.Generator().manual_seed(0)
    b4 = torch.randn(16, 4, generator=gen)
    a4 = torch.randn(4, 16, generator=gen)
    g_b = torch.randn(16, 8, generator=gen)
    g_a = torch.randn(8, 16, generator=gen)
    agg = Aggregator("raflora", (4, 8), backend=backend)
    ref = agg.aggregate_layer([(b4, a4)], [4], [1.0], global_b=g_b,
                              global_a=g_a)
    bs, as_ = pad_stack([(b4, a4)], 8)
    junk_b = torch.randn(1, 16, 8, generator=gen) * 1e3
    junk_a = torch.randn(1, 8, 16, generator=gen) * 1e3
    res = agg.aggregate_grouped_sharded(
        [[torch.cat([bs, junk_b])]], [[torch.cat([as_, junk_a])]],
        [4, 4], [1.0, 0.0], fl_mesh.make_fl_mesh(device="cpu"),
        global_bs=[g_b], global_as=[g_a])
    np.testing.assert_allclose((res.b_g[0] @ res.a_g[0]).numpy(),
                               (ref.b_g @ ref.a_g).numpy(), atol=1e-4)


def _zero_batch(inner):
    return lambda cid, rng: [] if cid == 1 else inner(cid, rng)


ZERO_BATCH = dict(fl_overrides={"num_rounds": 1, "num_clients": 4,
                                "participation": 1.0},
                  lora_overrides={"rank_levels": (4, 8),
                                  "rank_probs": (0.5, 0.5)},
                  samples_per_class=20, num_classes=4)


def test_zero_batch_client_round_stat_and_engines(world1):
    """``TestZeroBatchClient``: a client with zero batches trains no step
    and reports NaN; the round's mean loss stays finite, and its untrained
    global factors enter with its data weight alike in the sharded and
    sequential engines."""
    runs = _port_rounds("raflora", ("sequential", "sharded"),
                        batch_fn=_zero_batch, **ZERO_BATCH)
    stats = runs["sharded"][1]
    assert 1 in stats.clients and np.isfinite(stats.mean_client_loss)
    _assert_round_equal(runs["sequential"], runs["sharded"])


# -- world 2: one two-rank gloo spawn ----------------------------------------

def jax_world2_main(out: str) -> None:
    """Run in a process that sees two host devices: one round of each
    world-2 case on the reference's sharded engine over a two-device mesh,
    with the weights its experiment drew, pickled to ``out``."""
    from repro.federation.transport import TransportConfig
    from repro.launch.mesh import make_fl_mesh
    assert jax.device_count() == 2
    args = {k: v for k, v in ranks2.SMALL.items() if k != "device"}
    res = {}
    for label, (method, kw) in ranks2.CASES.items():
        kw = {**args, **kw}
        if kw.get("transport") == "int8":
            kw["transport"] = TransportConfig(mode="int8")
        je = j_build(method, round_engine="sharded", mesh=make_fl_mesh(2),
                     **kw)
        weights = jax.tree.map(np.asarray, j_merge(je.server.base,
                                                   je.server.global_lora))
        (st,) = je.server.run(1)
        res[label] = {"weights": weights, "clients": st.clients,
                      "ranks": st.ranks, "loss": st.mean_client_loss,
                      "sigma": st.sigma_probe,
                      "products": {p: b @ a for p, (b, a) in
                                   _factors(je.server).items()},
                      "mags": _magnitudes(je.server),
                      "base": _base_leaves(je.server)}
    with open(out, "wb") as f:
        pickle.dump(res, f)


@pytest.fixture(scope="module", autouse=True)
def jax_world2(tmp_path_factory):
    """``jax_world2_main`` in a subprocess with a forced two-device host
    platform (``tests/test_sharded_engine.py``'s way), started when the
    module starts so that it compiles beside the world-1 tests; the
    fixture is a function that waits for it and returns its results."""
    tmp = tmp_path_factory.mktemp("jax_world2")
    out, log = str(tmp / "ref.pkl"), tmp / "stderr.txt"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), os.path.join(root, "tests"), root,
         env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    code = f"import test_torch_sharded as t; t.jax_world2_main({out!r})"
    with open(log, "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                stdout=subprocess.DEVNULL, stderr=err)

    def result() -> dict:
        assert proc.wait(timeout=600) == 0, log.read_text()[-4000:]
        with open(out, "rb") as f:
            return pickle.load(f)
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_world2):
    """Both ranks' results of ``_torch_sharded_ranks.rank_main``, the
    port's batched rounds of the same cases and the reference's sharded
    rounds at two shards, all from the reference's weights."""
    ref = jax_world2()
    weights = {label: r["weights"] for label, r in ref.items()}
    ckpt = str(tmp_path_factory.mktemp("sharded") / "ckpt")
    results = fl_mesh.spawn_ranks(ranks2.rank_main, 2, ckpt, weights)
    batched = {label: ranks2.one_round(label, "batched", weights[label])
               for label in ranks2.CASES}
    return results, batched, ref


def _check_round(got, want):
    """One round against another: same clients, loss at rtol 1e-4,
    spectra at atol 1e-3 of sigma_max and products at 2e-3 of it (1e-4
    of the largest product without a spectrum), base weights at rtol
    1e-4, atol 1e-5."""
    assert got["clients"] == want["clients"] and len(got["clients"]) == 5
    assert got["ranks"] == want["ranks"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    scale = 1.0
    if want["sigma"] is not None:
        scale = max(1.0, float(np.abs(want["sigma"]).max()))
        np.testing.assert_allclose(got["sigma"], want["sigma"],
                                   atol=1e-3 * scale)
    assert sorted(got["products"]) == sorted(want["products"])
    for parent, w in want["products"].items():
        tol = (2e-3 * scale if want["sigma"] is not None
               else 1e-4 * max(1.0, np.abs(w).max()))
        np.testing.assert_allclose(got["products"][parent], w, atol=tol)
    assert sorted(got["base"]) == sorted(want["base"])
    for path, x in want["base"].items():
        np.testing.assert_allclose(got["base"][path], x, rtol=1e-4,
                                   atol=1e-5)
    assert sorted(got["mags"]) == sorted(want["mags"])
    for parent, m in want["mags"].items():
        np.testing.assert_allclose(got["mags"][parent], m, rtol=1e-4)


@pytest.mark.parametrize("label", sorted(ranks2.CASES))
def test_world2_round_matches_jax_sharded(world2, label):
    """5 clients over 2 ranks (one ghost) against the reference's sharded
    engine over two host devices (one ghost too), from the same weights:
    rank 0's round at ``_check_round``'s tolerances. Ghost padding,
    round-robin placement, the cross-rank reductions and the quantized
    collective are held to the reference here."""
    (r0, _), _, ref = world2
    _check_round(r0[label], ref[label])


@pytest.mark.parametrize("label", sorted(ranks2.CASES))
def test_world2_round_matches_batched(world2, label):
    """5 clients over 2 ranks (one ghost) against the port's batched
    engine at ``_check_round``'s tolerances; both ranks end the round
    with bit-equal global adapters and base."""
    (r0, r1), batched, _ = world2
    got, want = r0[label], batched[label]
    _check_round(got, want)
    for parent, x in got["products"].items():
        np.testing.assert_array_equal(r1[label]["products"][parent], x)
    for path, x in got["base"].items():
        np.testing.assert_array_equal(r1[label]["base"][path], x)
    for parent, m in got["mags"].items():
        np.testing.assert_array_equal(r1[label]["mags"][parent], m)


def test_world2_residuals_follow_clients_across_ranks(world2):
    """int8 with error feedback: after the round every rank holds the
    residual of every sampled client -- those trained on the other rank
    too, bit-equal on both ranks -- and each equals the batched engine's
    within float noise: at most 1% of the elements move, by at most one
    quantization step (an element near a grid boundary may round the
    other way)."""
    (r0, r1), batched, _ = world2
    label = "raflora-factored-int8"
    got, other, want = (r0[label]["residuals"], r1[label]["residuals"],
                        batched[label]["residuals"])
    assert sorted(got) == sorted(other) == sorted(want) == \
        sorted(r0[label]["clients"])
    for cid, pairs in want.items():
        for parent, (wb, wa) in pairs.items():
            for g, o, w in zip(got[cid][parent], other[cid][parent],
                               (wb, wa)):
                np.testing.assert_array_equal(g, o)
                assert np.mean(np.abs(g - w) > 1e-6) <= 0.01


def test_world2_async_save_restore_equals_uninterrupted(world2):
    """The async engine at depth 2 (int8 with error feedback, momentum
    0.9) on the two-rank mesh: saved after round 1 (mid-buffer), restored
    on both ranks into fresh servers and run on, equal to the
    uninterrupted run at
    ``test_torch_buffered.py::test_save_restore_run_equals_uninterrupted``'s
    tolerances (loss rtol 1e-6; energies and adapters rtol 1e-5, atol
    1e-6), on each rank."""
    (r0, r1), _, _ = world2
    for res in (r0["async"], r1["async"]):
        assert res["mid_buffer"]
        full, resumed = res["full"], res["resumed"]
        assert len(full["history"]) == len(resumed["history"]) == 3
        for (c1, k1, l1), (c2, k2, l2) in zip(full["history"],
                                              resumed["history"]):
            assert c1 == c2 and k1 == k2
            np.testing.assert_allclose(l2, l1, rtol=1e-6)
        np.testing.assert_allclose(resumed["energy"], full["energy"],
                                   rtol=1e-5, atol=1e-6)
        for p, x in full["lora"].items():
            np.testing.assert_allclose(resumed["lora"][p], x, rtol=1e-5,
                                       atol=1e-6)
    for p, x in r0["async"]["resumed"]["lora"].items():
        np.testing.assert_array_equal(r1["async"]["resumed"]["lora"][p], x)


def test_world2_all_reduces_per_bucket(world2):
    """One all-reduce per reduced tensor of a bucket, on both ranks, for
    each of the 3 buckets; a round adds one for the losses, with the
    transport one for the residuals, and under DoRA one a magnitude."""
    (r0, r1), _, _ = world2
    for label, per in ranks2.BUCKET_ALL_REDUCES.items():
        for res in (r0, r1):
            assert res[label]["bucket_all_reduces"] == [per] * 3, label
            extra = (1 + ("int8" in label)
                     + ranks2.MAGNITUDE_ALL_REDUCES.get(label, 0))
            assert res[label]["round_all_reduces"] == 3 * per + extra


def test_world2_moe_ep_equals_world1(world1, world2):
    """The expert-parallel MoE with its 4 experts split 2 + 2 over the two
    ranks' model axis equals the one-rank layer (this process's group)
    within 1e-6, dropless and at capacity 0.5, on both ranks (one
    all-reduce a call), and so does its gradient into x on both ranks
    (one more all-reduce a call, in the backward); the expert weights'
    gradients summed over the two ranks equal the one-rank layer's."""
    (r0, r1), _, _ = world2
    want = ranks2.moe_ep_outputs(fl_mesh.make_host_mesh(device="cpu"))
    assert want["mesh"] == (1, 1)
    for res in (r0["moe_ep"], r1["moe_ep"]):
        assert res["mesh"] == (1, 2)
        assert res["all_reduces"] == len(ranks2.EP_FACTORS)
        assert res["grad_all_reduces"] == 2 * len(ranks2.EP_FACTORS)
        for factor in ranks2.EP_FACTORS:
            (y, aux), (wy, waux) = res[factor], want[factor]
            np.testing.assert_allclose(y, wy, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(aux, waux)
            np.testing.assert_allclose(res["grad"][factor][0],
                                       want["grad"][factor][0], rtol=0,
                                       atol=1e-6)
    for factor in ranks2.EP_FACTORS:
        for name, w in want["grad"][factor][1].items():
            got = (r0["moe_ep"]["grad"][factor][1][name]
                   + r1["moe_ep"]["grad"][factor][1][name])
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6,
                                       err_msg=f"{factor} {name}")


def test_world2_llama4_ep_lora_gradients_equal_tp(world1, world2):
    """The reduced Llama-4 with ``moe_impl="ep"``, its 8 experts split 4 +
    4 over the two ranks: on each rank the LoRA gradients of its training
    loss equal the ``"tp"`` model's within 1e-5, as do the one-rank EP
    model's."""
    (r0, r1), _, _ = world2
    want = ranks2.llama4_lora_grads("tp")
    one = ranks2.llama4_lora_grads("ep", fl_mesh.make_host_mesh(
        device="cpu"))
    assert ("layers", "sub1", "attn", "q", "lora_a") in want
    for got in (r0["llama4_ep"], r1["llama4_ep"], one):
        assert set(got) == set(want)
        for path, w in want.items():
            np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5,
                                       err_msg=str(path))


def _buffered(kind, mesh):
    from repro_torch.federation import events
    kw = dict(SHARDED_SMALL, fl_overrides={"num_rounds": 4,
                                           "num_clients": 10,
                                           "participation": 0.5})
    exp = t_build("raflora", device="cpu", round_engine="async",
                  pipeline_depth=2 if kind == "async" else 1,
                  staleness_gamma=0.8, server_momentum_beta=0.9, mesh=mesh,
                  **kw)
    if kind == "event":
        exp.server.set_event_scheduler(events.EventScheduler(
            events.StragglerTailLatency(
                median=0.8, sigma=0.15, tail_scale=2.5,
                straggler_clients=np.flatnonzero(exp.registry.ranks > 4),
                seed=5),
            events.TimeoutTrigger(2.0), round_interval=1.0))
    exp.server.run(4)
    exp.server.drain_pending()
    return exp.server


@pytest.mark.parametrize("kind", ["async", "event"])
def test_buffered_engines_on_a_one_rank_mesh_equal_without(world1, kind):
    """The async engine (depth 2) and the event engine (straggling
    high-rank clients, partial cohorts) with ``mesh=`` run the sharded
    dispatches; on a one-rank mesh every all-reduce is an identity, so
    four rounds and the drain equal the runs without a mesh bit for
    bit."""
    mesh = fl_mesh.make_fl_mesh(device="cpu")
    calls = collective.all_reduce.calls
    got = _buffered(kind, mesh)
    assert collective.all_reduce.calls > calls
    want = _buffered(kind, None)
    assert [(h.clients, h.mean_client_loss) for h in got.history] == \
        [(h.clients, h.mean_client_loss) for h in want.history]
    np.testing.assert_array_equal(got.energy.higher_rank_ratio,
                                  want.energy.higher_rank_ratio)
    for p, x in flatten(want.global_lora).items():
        torch.testing.assert_close(flatten(got.global_lora)[p], x, rtol=0,
                                   atol=0)
