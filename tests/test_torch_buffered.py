"""The port's buffered, stateful server: the async engine, server
momentum, noisy low-rank clients and checkpoints, held to the JAX package
and to itself.

Tolerances: the async engine at depth 1 equals the batched engine bit for
bit (zero staleness is an arithmetic no-op); against JAX from the same
weights, the first buffered aggregation (identical state, staleness mixed
0 and 1) meets the round tolerances of ``tests/test_torch_round.py``
(losses rtol 1e-4, spectra 1e-3 * sigma_max, products
2e-3 * max(1, sigma_max)); momentum's products (the SVD's gauge freedom
rules out raw factors) within 1e-5 of the largest product; noisy client
data and checkpoint arrays bit-equal; save -> restore -> run against the
uninterrupted run at the reference's ``TestTransportCheckpoint``
tolerances (losses rtol 1e-6, energy and adapters rtol 1e-5 / atol 1e-6);
a JAX event checkpoint (momentum, int8 with error feedback, mid-buffer)
restored into the port drains to JAX's aggregate at the round
tolerances."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jck
from repro.core.lora import merge_lora as j_merge
from repro.core.server_opt import FactoredServerMomentum as JMom
from repro.federation import events as jev
from repro.federation.experiment import build_experiment as j_build
from repro.federation.transport import TransportConfig as JTx
from repro_torch.checkpointing import checkpoint as tck
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten
from repro_torch.core.server_opt import FactoredServerMomentum as TMom
from repro_torch.federation import events as tev
from repro_torch.federation.experiment import build_experiment as t_build
from repro_torch.federation.transport import TransportConfig as TTx
from repro_torch.federation.transport import is_quantized

torch.set_num_threads(1)

SMALL = dict(fl_overrides={"num_rounds": 5, "num_clients": 8,
                           "participation": 0.5},
             lora_overrides={"rank_levels": (4, 8, 16),
                             "rank_probs": (0.34, 0.33, 0.33)},
             samples_per_class=20, num_classes=4, d_model=32,
             batches_per_round=1, backend="kernel")
ASYNC = dict(round_engine="async", pipeline_depth=2, staleness_gamma=0.8)


def _products(server):
    return {p: np.asarray(b) @ np.asarray(a) for p, (b, a) in
            server._extract_factors(server.global_lora,
                                    server.lora_cfg.r_max).items()}


def _pair(method="raflora", jkw=None, tkw=None, **kw):
    """The JAX experiment and the port's, from the JAX weights."""
    args = {**SMALL, **kw}
    je = j_build(method, **args, **(jkw or {}))
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    te = t_build(method, device="cpu",
                 base_params=params_from_numpy(params, "cpu"), **args,
                 **(tkw or {}))
    return je, te


def _assert_round_parity(hj, ht, sj, st):
    assert [h.clients for h in ht] == [h.clients for h in hj]
    assert [h.ranks for h in ht] == [h.ranks for h in hj]
    np.testing.assert_allclose([h.mean_client_loss for h in ht],
                               [h.mean_client_loss for h in hj], rtol=1e-4)
    j_sig = np.asarray(hj[-1].sigma_probe)
    scale = max(1.0, float(np.abs(j_sig).max()))
    np.testing.assert_allclose(ht[-1].sigma_probe, j_sig, atol=1e-3 * scale)
    np.testing.assert_allclose(st.energy.rho_r1, sj.energy.rho_r1, atol=1e-3)
    pj, pt = _products(sj), _products(st)
    assert list(pt) == list(pj)
    for p, want in pj.items():
        np.testing.assert_allclose(pt[p], want, atol=2e-3 * scale)


def test_async_depth1_equals_batched():
    """``pipeline_depth=1`` is the batched engine, bit for bit."""
    bat = t_build("raflora", device="cpu", **SMALL)
    asy = t_build("raflora", device="cpu", round_engine="async",
                  base_params=bat.server.global_params(), **SMALL)
    hb, ha = bat.server.run(3), asy.server.run(3)
    assert [h.clients for h in ha] == [h.clients for h in hb]
    assert [h.mean_client_loss for h in ha] == \
        [h.mean_client_loss for h in hb]
    assert asy.server.energy.rho_r1 == bat.server.energy.rho_r1
    assert asy.server.drain_pending() is None
    for path, x in flatten(bat.server.global_lora).items():
        assert torch.equal(flatten(asy.server.global_lora)[path], x)


CASES = [pytest.param({}, id="f32"),
         pytest.param({"transport": "bf16"}, id="bf16"),
         pytest.param({"server_momentum_beta": 0.9}, id="f32-momentum")]


@pytest.mark.parametrize("case", CASES)
def test_async_depth2_matches_jax(case):
    """The cadence engine at depth 2 (staleness gamma 0.8) in both
    packages: round parity at the first buffered aggregation (rounds 0
    and 1 from identical state); then two more rounds and the drain with
    the same clients, an aggregation every second round, and finite
    globals."""
    case = dict(case)
    mode = case.pop("transport", None)
    je, te = _pair(jkw={"transport": mode and JTx(mode=mode)},
                   tkw={"transport": mode and TTx(mode=mode)},
                   **ASYNC, **case)
    hj, ht = je.server.run(2), te.server.run(2)
    assert ht[0].sigma_probe is None and len(te.server.energy.rho_r1) == 1
    _assert_round_parity(hj, ht, je.server, te.server)
    hj, ht = je.server.run(2), te.server.run(2)
    assert [h.clients for h in ht] == [h.clients for h in hj]
    assert len(te.server.energy.rho_r1) == 2
    assert te.server.drain_pending() is None
    if case:
        assert te.server.server_momentum.bucket_calls == 2 * 3
    assert all(torch.isfinite(x).all()
               for x in flatten(te.server.global_lora).values())


def _mom_inputs(seed, lead, d=24, n=20, r=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=lead + shape).astype(np.float32) * 0.3
            for shape in ((d, r), (r, n), (d, r), (r, n))]


def test_momentum_products_match_jax():
    """``apply`` (three steps on one adapter) and ``apply_bucket`` (two
    steps on a two-adapter, two-layer bucket, after a per-adapter step
    that it migrates) on the same numpy inputs: the products of the new
    globals and of the momentum state against JAX's; the checkpointed
    state is per adapter under the reference's keys."""
    jm, tm = JMom(beta=0.9), TMom(beta=0.9)
    old_b, old_a = np.zeros((24, 8), np.float32), np.zeros((8, 20),
                                                           np.float32)
    jold = told = (old_b, old_a)
    for t in range(3):
        _, _, nb, na = _mom_inputs(t, ())
        jold = jm.apply(("a", "q"), tuple(jnp.asarray(x) for x in jold),
                        (jnp.asarray(nb), jnp.asarray(na)), 8)
        told = tm.apply(("a", "q"), tuple(torch.as_tensor(np.asarray(x))
                                          for x in told),
                        (torch.from_numpy(nb), torch.from_numpy(na)), 8)
        want = np.asarray(jold[0]) @ np.asarray(jold[1])
        np.testing.assert_allclose((told[0] @ told[1]).numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
    keys = (("b", "k"), ("b", "v"))
    ob, oa, _, _ = _mom_inputs(10, (2, 2))
    for j, k in enumerate(keys):                 # one per-adapter step
        jm.apply(k, (jnp.asarray(ob[j]), jnp.asarray(oa[j])),
                 (jnp.asarray(2 * ob[j]), jnp.asarray(oa[j])), 8)
        tm.apply(k, (torch.from_numpy(ob[j]), torch.from_numpy(oa[j])),
                 (torch.from_numpy(2 * ob[j]), torch.from_numpy(oa[j])), 8)
    for t in range(2):
        _, _, nb, na = _mom_inputs(20 + t, (2, 2))
        jr = jm.apply_bucket(keys, [(jnp.asarray(ob[j]), jnp.asarray(oa[j]))
                                    for j in range(2)],
                             jnp.asarray(nb), jnp.asarray(na), 8)
        tr = tm.apply_bucket(keys, [(torch.from_numpy(ob[j]),
                                     torch.from_numpy(oa[j]))
                                    for j in range(2)],
                             torch.from_numpy(nb), torch.from_numpy(na), 8)
        want = np.asarray(jr[0]) @ np.asarray(jr[1])
        np.testing.assert_allclose((tr[0] @ tr[1]).numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
    assert all(k not in tm.state for k in keys) and keys in tm.state
    js, ts = jm.state_arrays(), tm.state_arrays()
    assert sorted(ts) == sorted(js)
    for k in js:
        if k.endswith("/B_m"):
            a_k = k[:-4] + "/A_m"
            want = js[k] @ js[a_k]
            np.testing.assert_allclose(ts[k] @ ts[a_k], want,
                                       atol=1e-5 * np.abs(want).max())
    back = TMom(beta=0.9)
    back.load_state_arrays(ts)
    for k, v in back.state_arrays().items():
        np.testing.assert_array_equal(v, ts[k])


def test_noisy_low_rank_data_matches_jax():
    """``noisy_low_rank_std``: every client's batches (noised for the
    minimum-rank ones) equal JAX's for the same rng."""
    kw = dict(SMALL, noisy_low_rank_std=0.5)
    je, te = j_build("raflora", **kw), t_build("raflora", device="cpu", **kw)
    low = np.flatnonzero(je.registry.ranks == 4)
    assert low.size > 0
    for cid in range(8):
        jb = je.server.batch_fn(cid, np.random.default_rng(cid))
        tb = te.server.batch_fn(cid, np.random.default_rng(cid))
        assert len(jb) == len(tb)
        for x, y in zip(jb, tb):
            for k in x:
                np.testing.assert_array_equal(np.asarray(y[k]),
                                              np.asarray(x[k]))
    clean = t_build("raflora", device="cpu", **SMALL)
    diff = [not np.array_equal(
        clean.server.batch_fn(c, np.random.default_rng(0))[0]["embeds"],
        te.server.batch_fn(c, np.random.default_rng(0))[0]["embeds"])
        for c in range(8)]
    # the minimum-rank clients' shards are noised (a shard overlapping
    # theirs shares the noised samples, as in the reference)
    assert all(diff[c] for c in low)


def _sched(ev, high):
    return ev.EventScheduler(
        ev.StragglerTailLatency(median=0.8, sigma=0.15, tail_scale=2.5,
                                straggler_clients=high, seed=5),
        ev.TimeoutTrigger(2.0), round_interval=1.0)


RESUME = {
    "async-int8-momentum": dict(ASYNC, server_momentum_beta=0.9,
                                transport="int8"),
    "event-int8-momentum": dict(round_engine="async", staleness_gamma=0.8,
                                server_momentum_beta=0.9, transport="int8",
                                events=True),
    "sequential-momentum": dict(round_engine="sequential",
                                server_momentum_beta=0.9),
}


def _resume_exp(case, base):
    kw = dict(RESUME[case])
    mode, events = kw.pop("transport", None), kw.pop("events", False)
    exp = t_build("raflora", device="cpu", base_params=base,
                  transport=mode and TTx(mode=mode), **SMALL, **kw)
    if events:
        exp.server.set_event_scheduler(_sched(
            tev, np.flatnonzero(exp.registry.ranks > 4)))
    return exp


@pytest.mark.parametrize("case", sorted(RESUME))
def test_save_restore_run_equals_uninterrupted(case, tmp_path):
    """Save mid-run (mid-buffer for the buffered engines: pending plans,
    error-feedback residuals and momentum in flight), restore into a fresh
    server, continue: equal to the uninterrupted run."""
    full = _resume_exp(case, None)
    base = full.server.global_params()
    full.server.run(5)
    full.server.drain_pending()
    part = _resume_exp(case, base)
    part.server.run(3)
    if case != "sequential-momentum":
        assert part.server._pending and part.server.transport.has_state()
    assert part.server.server_momentum.state
    path = str(tmp_path / "ckpt")
    part.server.save(path)
    resumed = _resume_exp(case, base)
    resumed.server.restore(path)
    assert resumed.server.round_idx == 3 and len(resumed.server.history) == 3
    resumed.server.run(2)
    resumed.server.drain_pending()
    for sf, sr in zip(full.server.history, resumed.server.history):
        assert sf.clients == sr.clients and sf.ranks == sr.ranks
        assert sf.virtual_time == sr.virtual_time
        np.testing.assert_allclose(sf.mean_client_loss, sr.mean_client_loss,
                                   rtol=1e-6)
    np.testing.assert_allclose(full.server.energy.higher_rank_ratio,
                               resumed.server.energy.higher_rank_ratio,
                               rtol=1e-5, atol=1e-6)
    for p, x in flatten(full.server.global_lora).items():
        np.testing.assert_allclose(
            flatten(resumed.server.global_lora)[p].numpy(), x.numpy(),
            rtol=1e-5, atol=1e-6)


def _jax_event_exp(base=None):
    kw = dict(SMALL, round_engine="async", staleness_gamma=0.8,
              server_momentum_beta=0.9)
    exp = j_build("raflora", transport=JTx(mode="int8"), **kw)
    exp.server.set_event_scheduler(_sched(
        jev, np.flatnonzero(exp.registry.ranks > 4)))
    return exp


def _torch_event_exp(base):
    exp = t_build("raflora", device="cpu", transport=TTx(mode="int8"),
                  base_params=base, round_engine="async",
                  staleness_gamma=0.8, server_momentum_beta=0.9, **SMALL)
    exp.server.set_event_scheduler(_sched(
        tev, np.flatnonzero(exp.registry.ranks > 4)))
    return exp


def _assert_same_aggregate(sj, st, pj):
    """JAX's and the port's servers after draining the same checkpoint."""
    scale = max(1.0, float(np.abs(pj).max()))
    np.testing.assert_allclose(st.history[-1].sigma_probe, pj,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(st.energy.rho_r1, sj.energy.rho_r1, atol=1e-3)
    want, got = _products(sj), _products(st)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], atol=2e-3 * scale)
    assert [vars(f) for f in st.event_scheduler.fire_log] == \
        [vars(f) for f in sj.event_scheduler.fire_log]


def test_cross_package_event_checkpoint(tmp_path):
    """A mid-buffer event checkpoint written by the JAX server (momentum
    on, int8 with error feedback) restores into the port: the same files,
    the same state (history, residuals, momentum, scheduler, quantized
    pending plans bit for bit), and the drain's fires aggregate to JAX's
    result. The port's own checkpoint of that state restores into a JAX
    server and drains to the same result."""
    je = _jax_event_exp()
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    je.server.run(3)
    assert je.server._pending and je.server.server_momentum.state
    jpath = str(tmp_path / "jax")
    je.server.save(jpath)
    te = _torch_event_exp(params_from_numpy(params, "cpu"))
    te.server.restore(jpath)
    assert [s.clients for s in te.server.history] == \
        [s.clients for s in je.server.history]
    assert (te.server.event_scheduler.state_dict()
            == je.server.event_scheduler.state_dict())
    for t_state, j_state in (
            (te.server.transport.state_arrays(),
             je.server.transport.state_arrays()),
            (te.server.server_momentum.state_arrays(),
             je.server.server_momentum.state_arrays())):
        assert sorted(t_state) == sorted(j_state)
        for k, v in j_state.items():
            np.testing.assert_array_equal(t_state[k], v)
    for jp, tp in zip(je.server._pending, te.server._pending):
        assert (jp.round, jp.version, jp.clients) == (tp.round, tp.version,
                                                      tp.clients)
        for (_, _, jf), (_, _, tf) in zip(jp.group_factors,
                                          tp.group_factors):
            for parent, pair in jf.items():
                for jq, tq in zip(pair, tf[parent]):
                    assert is_quantized(tq) and tq.q.dtype == torch.int8
                    np.testing.assert_array_equal(tq.q.numpy(),
                                                  np.asarray(jq.q))
                    np.testing.assert_array_equal(tq.scale.numpy(),
                                                  np.asarray(jq.scale))
    tpath = str(tmp_path / "torch")
    te.server.save(tpath)
    pj = je.server.drain_pending()
    assert te.server.drain_pending() is not None
    _assert_same_aggregate(je.server, te.server, pj)
    back = _jax_event_exp()
    back.server.restore(tpath)
    assert back.server.drain_pending() is not None
    _assert_same_aggregate(back.server, te.server, pj)


def test_checkpoint_files_match_jax(tmp_path):
    """``save_pytree`` of the same weights in both packages: the same
    "/"-joined keys in the same order and the same arrays; either file
    loads in the other package; both path spellings; no temp files left;
    ``save_flat`` round-trips int8 payloads and raw bf16 words."""
    je = j_build("raflora", **SMALL)
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    tparams = params_from_numpy(params, "cpu")
    jck.save_pytree(str(tmp_path / "j"), params, metadata={"x": np.int64(3)})
    tck.save_pytree(str(tmp_path / "t.npz"), tparams,
                    metadata={"x": np.int64(3)})
    with np.load(tmp_path / "j.npz") as jf, np.load(tmp_path / "t.npz") as tf:
        assert jf.files == tf.files
        for k in jf.files:
            np.testing.assert_array_equal(tf[k], jf[k])
    assert tck.load_metadata(str(tmp_path / "t")) == {"x": 3}
    assert tck.load_metadata(str(tmp_path / "j.npz")) == {"x": 3}
    back = tck.load_pytree(str(tmp_path / "j.npz"), tparams)
    for p, x in flatten(tparams).items():
        assert torch.equal(flatten(back)[p], x)
    jback = jck.load_pytree(str(tmp_path / "t"), params)
    for x, y in zip(jax.tree.leaves(jback), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), y)
    assert sorted(os.listdir(tmp_path)) == ["j.meta.json", "j.npz",
                                            "t.meta.json", "t.npz"]
    te = t_build("raflora", device="cpu", transport=TTx(mode="bf16"),
                 base_params=tparams, **ASYNC, **SMALL)
    te.server.run(1)
    plan = te.server._pending[0]
    arrays = te.server._plan_arrays(plan)
    assert any(v.dtype == np.dtype("V2") for v in arrays.values())
    tck.save_flat(str(tmp_path / "plan"), arrays)
    again = te.server._plan_from_arrays(te.server._plan_meta(plan),
                                        tck.load_flat(str(tmp_path / "plan")))
    for (_, _, f0), (_, _, f1) in zip(plan.group_factors,
                                      again.group_factors):
        for parent, pair in f0.items():
            for q0, q1 in zip(pair, f1[parent]):
                assert q1.q.dtype == torch.bfloat16
                assert torch.equal(q0.q, q1.q)
                assert torch.equal(q0.scale, q1.scale)


def test_restore_guards(tmp_path):
    """A checkpoint from before the transport restores with a warning and
    zero residuals; an event checkpoint refuses a server without a
    scheduler."""
    old = t_build("raflora", device="cpu", **SMALL)
    old.server.run(1)
    old.server.save(str(tmp_path / "plain"))
    new = t_build("raflora", device="cpu", transport=TTx(mode="int8"),
                  base_params=old.server.global_params(), **SMALL)
    with pytest.warns(RuntimeWarning,
                      match="predates the compressed update transport"):
        new.server.restore(str(tmp_path / "plain"))
    assert not new.server.transport.has_state()
    new.server.run(1)
    assert new.server.transport.has_state()
    evt = _torch_event_exp(None)
    evt.server.run(1)
    evt.server.save(str(tmp_path / "event"))
    bare = t_build("raflora", device="cpu", round_engine="async", **SMALL)
    with pytest.raises(AssertionError, match="event-scheduler state"):
        bare.server.restore(str(tmp_path / "event"))
