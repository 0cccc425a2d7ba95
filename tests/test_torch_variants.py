"""The PEFT variants of the paper's Table 5 (DoRA and QLoRA) in the port,
held to the JAX package on the CPU from the same numpy inputs:

* DoRA's apply against the reference's ``dense_apply`` with a magnitude,
  single and over a client axis, full and truncated (1e-5);
  ``dora_magnitude_init`` and ``quantize_dequantize`` bit-equal;
* the model's variants on qwen2-7b reduced: the magnitude leaves and the
  quantized ``w`` bit-equal from the same plain weights, the forward and
  ``train_loss`` with copied weights (1e-5);
* ``launch/steps.py``: three train steps with two microbatches (the
  factors and magnitudes to 1e-4), the prefill and serve steps;
* a DoRA and a QLoRA round (sequential and batched engines) against the
  JAX server: products and spectra at ``test_torch_round.py``'s
  tolerances, magnitudes at rtol 1e-4, and the magnitudes moved
  (``TestVariantFederation::test_dora_magnitudes_fedavg``); the
  reference's ``TestDoRAMagnitudeEquivalence`` on the port's batched and
  sharded (world 1) engines;
* DoRA under the async and event engines with int8 and error feedback
  (magnitudes ship uncompressed), at the first buffered aggregation;
* a mid-buffer DoRA checkpoint crossing packages both ways;
* a DoRA run with a bound ``AdapterStore`` skips and warns;
* the ``variants`` bench's FlexLoRA-DoRA row against the JAX bench's at
  one round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.bench_lora_variants as j_variants
import benchmarks.common as j_common
from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.core.lora import merge_lora as j_merge
from repro.core.lora import split_lora as j_split
from repro.federation import events as jev
from repro.federation.experiment import build_experiment as j_build
from repro.federation.transport import TransportConfig as JTx
from repro.launch import steps as j_steps
from repro.models import build_model
from repro.models.layers import dense as jd
from repro_torch.benchmarks import bench_lora_variants as t_variants
from repro_torch.benchmarks import common as t_common
from repro_torch.configs import LoRAConfig as TLoRA
from repro_torch.configs import get_config as t_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, split_lora
from repro_torch.federation import events as tev
from repro_torch.federation.experiment import build_experiment as t_build
from repro_torch.federation.transport import TransportConfig as TTx
from repro_torch.federation.transport import is_quantized
from repro_torch.launch import steps as t_steps
from repro_torch.models.layers import dense as td
from repro_torch.models.transformer import Model
from repro_torch.serving.adapter_store import AdapterStore
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

LEVELS = {"rank_levels": (4, 8, 16), "rank_probs": (0.34, 0.33, 0.33)}
SMALL = dict(fl_overrides={"num_rounds": 4, "num_clients": 8,
                           "participation": 0.5},
             samples_per_class=20, num_classes=4, d_model=32,
             batches_per_round=1, backend="kernel")


def _variant(variant):
    return {"lora_overrides": dict(LEVELS, variant=variant)}


# -- the dense layer ----------------------------------------------------------

def _dora_layer(rng, c, d_in=24, d_out=20, r=8):
    w = rng.normal(size=(d_in, d_out)).astype(np.float32) * 0.3
    p = {"w": w, "b": rng.normal(size=(d_out,)).astype(np.float32),
         "lora_a": rng.normal(size=(c, r, d_in)).astype(np.float32) * 0.3,
         "lora_b": rng.normal(size=(c, d_out, r)).astype(np.float32) * 0.3,
         "lora_m": (np.asarray(jd.dora_magnitude_init(jnp.asarray(w)))[None]
                    * rng.uniform(0.5, 1.5, size=(c, d_out))
                    ).astype(np.float32)}
    return p


@pytest.mark.parametrize("lora_rank", [-1, 4], ids=["full", "truncated"])
@pytest.mark.parametrize("c", [1, 3], ids=["single", "clients"])
def test_dora_apply_matches_reference(c, lora_rank):
    """Client c's rows through the port's client-axis DoRA equal the
    reference's ``dense_apply`` with client c's factors, magnitude and
    scale."""
    rng = np.random.default_rng(c)
    p = _dora_layer(rng, c)
    x = rng.normal(size=(c, 2, 5, 24)).astype(np.float32)
    scales = np.asarray([1.0, 0.5, 2.0][:c], np.float32)
    got = td.dense_apply({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x),
                         lora_scale=torch.from_numpy(scales),
                         lora_rank=lora_rank).numpy()
    assert got.shape == (c, 2, 5, 20)
    for i in range(c):
        pi = {k: jnp.asarray(v[i] if k.startswith("lora") else v)
              for k, v in p.items()}
        want = np.asarray(jd.dense_apply(pi, jnp.asarray(x[i]),
                                         lora_rank=lora_rank,
                                         lora_scale=float(scales[i])))
        np.testing.assert_allclose(got[i], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
def test_magnitude_init_and_quantize_bit_equal(bits):
    """Layer-stacked weights, one in dim over XLA's 32-row windows and
    one that pads them: the magnitudes and the fake-quantized weights
    equal the reference's bit for bit, with at most 2^bits levels a
    column."""
    rng = np.random.default_rng(bits)
    for shape in ((3, 96, 40), (2, 70, 33)):
        w = rng.normal(size=shape).astype(np.float32) * 0.2
        np.testing.assert_array_equal(
            td.dora_magnitude_init(torch.from_numpy(w)).numpy(),
            np.asarray(jd.dora_magnitude_init(jnp.asarray(w))))
        q = td.quantize_dequantize(torch.from_numpy(w), bits).numpy()
        np.testing.assert_array_equal(
            q, np.asarray(jd.quantize_dequantize(jnp.asarray(w), bits)))
        assert max(len(np.unique(q[0, :, j])) for j in range(shape[-1])) \
            <= 2 ** bits


# -- the model -----------------------------------------------------------------

def _qwen_pair(variant):
    cfg = j_config("qwen2-7b").reduced(d_model=64)
    lora = dict(rank_levels=(4, 8), rank_probs=(0.5, 0.5), variant=variant)
    jm = build_model(cfg, JLoRA(**lora), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16)
    tm = Model(t_config("qwen2-7b").reduced(d_model=64), TLoRA(**lora),
               device="cpu")
    return jm, tm


def _batch(vocab, b=4, t=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "targets": rng.integers(0, vocab, (b, t)).astype(np.int32)}


def _nonzero_b(params):
    """lora_b drawn away from 0, so the adapters act in the forward."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                                   x.shape)
                      if str(getattr(p[-1], "key", "")) == "lora_b" else x),
        params)


@pytest.mark.parametrize("variant", ["dora", "qlora"])
def test_model_variant_matches_reference(variant):
    """qwen2-7b reduced: the port's init has the reference's tree; from
    the same plain weights both packages' variant pass gives bit-equal
    magnitudes and quantized ``w`` (only on adapted layers); the forward
    and ``train_loss`` with copied weights agree to 1e-5."""
    jm, tm = _qwen_pair(variant)
    plain = jax.tree.map(np.asarray, _nonzero_b(
        build_model(jm.cfg, JLoRA(rank_levels=(4, 8), rank_probs=(0.5, 0.5)),
                    dtype=jnp.float32).init(jax.random.PRNGKey(0))))
    jp = jax.tree.map(np.asarray, jm._apply_peft_variant(plain))
    tp = tm._apply_peft_variant(params_from_numpy(plain, "cpu"))
    want = flatten(params_from_numpy(jp, "cpu"))
    assert list(flatten(tp)) == list(want)
    assert {p: tuple(x.shape) for p, x in flatten(tm.param_shapes()).items()} \
        == {p: tuple(x.shape) for p, x in want.items()}
    plain_t = flatten(params_from_numpy(plain, "cpu"))
    mags = [p for p in want if p[-1] == "lora_m"]
    assert len(mags) == (4 if variant == "dora" else 0)
    for p, x in flatten(tp).items():
        torch.testing.assert_close(x, want[p], rtol=0, atol=0)
        moved = not torch.equal(x, plain_t[p]) if p in plain_t else True
        quantized = (variant == "qlora" and p[-1] == "w"
                     and p[:-1] + ("lora_a",) in want)
        assert moved == (quantized or p[-1] == "lora_m"), p
    batch = _batch(jm.cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, _ = jm.train_loss(jp, jb, lora_rank=4)
    lt, _ = tm.train_loss(tp, batch, lora_rank=4)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    gj = np.asarray(jm.forward_seq(jp, jb)[0])
    np.testing.assert_allclose(tm.forward_seq(tp, batch)[0].numpy(), gj,
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("variant", ["lora", "dora"])
def test_train_step_matches_reference(variant):
    """Three steps of ``build_train_step`` with two microbatches in both
    packages from the same weights: the loss falls, and the factors and
    magnitudes agree to 1e-4; the prefill and serve steps agree too."""
    jm, tm = _qwen_pair(variant)
    params = _nonzero_b(jm.init(jax.random.PRNGKey(0)))
    base, lo = j_split(params)
    tbase, tlo = split_lora(params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu"))
    batch = _batch(jm.cfg.vocab_size)
    jstep, jopt = j_steps.build_train_step(jm, 8, num_microbatches=2)
    jstep = jax.jit(jstep)           # one compile for the three steps
    tstep, topt = t_steps.build_train_step(tm, 8, num_microbatches=2)
    jst, tst = jopt.init(lo), topt.init(tlo)
    losses = []
    for _ in range(3):
        lo, jst, jmet = jstep(lo, jst, base,
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.float32(1e-2))
        tlo, tst, tmet = tstep(tlo, tst, tbase, batch, 1e-2)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        losses.append(float(tmet["loss"]))
    assert losses[-1] < losses[0]
    want = flatten(params_from_numpy(jax.tree.map(np.asarray, lo), "cpu"))
    got = flatten(tlo)
    assert list(got) == list(want)
    assert any(p[-1] == "lora_m" for p in got) == (variant == "dora")
    for p, x in want.items():
        np.testing.assert_allclose(got[p].numpy(), x.numpy(), atol=1e-4,
                                   rtol=1e-4)
    jfull = jax.tree.map(np.asarray, j_merge(base, lo))
    tfull = params_from_numpy(jfull, "cpu")
    prompt = {"tokens": batch["tokens"][:2, :8]}
    jl, jcache = j_steps.build_prefill_step(jm, 8)(
        jfull, {"tokens": jnp.asarray(prompt["tokens"])})
    tl, tcache = t_steps.build_prefill_step(tm, 8)(tfull, prompt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-4)
    cache = tm.init_cache(2, 16)
    for name in ("k", "v"):
        cache["layers"][name][:, :, :8] = tcache[name]
    cache["len"] = torch.tensor(8, dtype=torch.int32)
    jcache_full = jm.init_cache(2, 16)
    jcache_full = {"layers": {n: jcache_full["layers"][n].at[:, :, :8].set(
        jcache[n]) for n in ("k", "v")}, "len": jnp.int32(8)}
    tok = tl[:, -1].argmax(-1).to(torch.int32)[:, None]
    jtok, _ = j_steps.build_serve_step(jm, 8)(
        jfull, {"token": jnp.asarray(tok.numpy())}, jcache_full)
    ttok, new = t_steps.build_serve_step(tm, 8)(tfull, {"token": tok}, cache)
    assert ttok.dtype == torch.int32 and int(new["len"]) == 9
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# -- rounds ----------------------------------------------------------------------

def _split_factors(server):
    """({parent: B @ A}, {parent: magnitude}) of a JAX or port server's
    global adapters, numpy."""
    prods, mags = {}, {}
    for key, val in server._extract_factors(
            server.global_lora, server.lora_cfg.r_max).items():
        if isinstance(key[0], tuple):
            mags[tuple(key[0])] = np.asarray(val)
        else:
            prods[tuple(key)] = np.asarray(val[0]) @ np.asarray(val[1])
    return prods, mags


def _pair(method="raflora", jkw=None, tkw=None, **kw):
    args = {**SMALL, **kw}
    je = j_build(method, **args, **(jkw or {}))
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    te = t_build(method, device="cpu",
                 base_params=params_from_numpy(params, "cpu"), **args,
                 **(tkw or {}))
    return je, te, params


def _assert_parity(hj, ht, sj, st):
    """Round parity: clients, loss rtol 1e-4, spectra 1e-3 and products
    2e-3 of sigma_max, magnitudes rtol 1e-4."""
    assert [h.clients for h in ht] == [h.clients for h in hj]
    np.testing.assert_allclose([h.mean_client_loss for h in ht],
                               [h.mean_client_loss for h in hj], rtol=1e-4)
    j_sig = np.asarray(hj[-1].sigma_probe)
    scale = max(1.0, float(np.abs(j_sig).max()))
    np.testing.assert_allclose(ht[-1].sigma_probe, j_sig, atol=1e-3 * scale)
    (pj, mj), (pt, mt) = _split_factors(sj), _split_factors(st)
    assert list(pt) == list(pj) and list(mt) == list(mj)
    for p, want in pj.items():
        np.testing.assert_allclose(pt[p], want, atol=2e-3 * scale)
    for p, want in mj.items():
        np.testing.assert_allclose(mt[p], want, rtol=1e-4)


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("variant", ["dora", "qlora"])
def test_variant_round_matches_jax(variant, engine):
    """One raFLoRA round in both packages from the same weights; under
    DoRA every magnitude moved by the FedAvg and stays finite, under
    QLoRA the quantized base stays as it was."""
    je, te, params = _pair(round_engine=engine, **_variant(variant))
    _, m0 = _split_factors(te.server)
    base0 = {p: x.clone() for p, x in flatten(te.server.base).items()}
    _assert_parity(je.server.run(1), te.server.run(1), je.server, te.server)
    _, m1 = _split_factors(te.server)
    assert len(m1) == (6 if variant == "dora" else 0)
    for p, m in m1.items():
        assert np.isfinite(m).all() and not np.allclose(m, m0[p])
    for p, x in flatten(te.server.base).items():
        assert torch.equal(x, base0[p])


def _hetero_steps(server):
    """Odd clients train one local step, even clients two: two step-count
    groups, so the grouped engines stack clients in group order."""
    inner = server.batch_fn
    server.batch_fn = lambda cid, rng: inner(cid, rng)[:1 + cid % 2]


@pytest.mark.parametrize("other", ["batched", "sharded"])
def test_dora_magnitudes_follow_group_order(other):
    """``TestDoRAMagnitudeEquivalence`` on the port: with heterogeneous
    step-count groups the batched engine and the sharded engine (a
    one-rank group it makes and closes) permute the magnitude weights
    into group order and equal the sequential engine (products 1e-4 of
    the largest, magnitudes rtol 1e-5)."""
    kw = dict(fl_overrides={"num_rounds": 1, "num_clients": 4,
                            "participation": 1.0, "local_batch_size": 4,
                            "partition": "iid"},
              samples_per_class=16, num_classes=4, d_model=32,
              batches_per_round=2, device="cpu", backend="factored",
              **_variant("dora"))
    runs, base = {}, None
    for engine in ("sequential", other):
        exp = t_build("raflora", round_engine=engine, base_params=base, **kw)
        base = base or exp.server.global_params()
        _hetero_steps(exp.server)
        try:
            stats = exp.server.run(1)[0]
            runs[engine] = (stats, _split_factors(exp.server))
        finally:
            exp.server.close()
    (s1, (p1, m1)), (s2, (p2, m2)) = runs["sequential"], runs[other]
    assert s1.clients == s2.clients and len(set(
        1 + c % 2 for c in s1.clients)) == 2
    np.testing.assert_allclose(s2.mean_client_loss, s1.mean_client_loss,
                               rtol=1e-4)
    for p, x in p1.items():
        np.testing.assert_allclose(p2[p], x,
                                   atol=1e-4 * max(1.0, np.abs(x).max()))
    assert len(m1) == 6
    for p, x in m1.items():
        np.testing.assert_allclose(m2[p], x, rtol=1e-5)


def _sched(ev, high):
    return ev.EventScheduler(
        ev.StragglerTailLatency(median=0.8, sigma=0.15, tail_scale=2.5,
                                straggler_clients=high, seed=5),
        ev.TimeoutTrigger(2.0), round_interval=1.0)


BUFFERED = {"async": dict(round_engine="async", pipeline_depth=2,
                          staleness_gamma=0.8),
            "event": dict(round_engine="async", staleness_gamma=0.8)}


def _buffered_pair(kind, **extra):
    je, te, params = _pair(jkw={"transport": JTx(mode="int8")},
                           tkw={"transport": TTx(mode="int8")},
                           **BUFFERED[kind], **_variant("dora"), **extra)
    if kind == "event":
        high = np.flatnonzero(je.registry.ranks > 4)
        je.server.set_event_scheduler(_sched(jev, high))
        te.server.set_event_scheduler(_sched(tev, high))
    return je, te, params


@pytest.mark.parametrize("kind", ["async", "event"])
def test_dora_buffered_first_aggregation_matches_jax(kind):
    """DoRA under the async engine (depth 2) and the event engine, with
    int8 and error feedback: the magnitudes ship uncompressed and keep
    no residual; at the first buffered aggregation (round 1) both
    packages agree at the round tolerances, magnitudes at rtol 1e-4."""
    je, te, _ = _buffered_pair(kind)
    hj, ht = je.server.run(2), te.server.run(2)
    assert len(te.server.energy.rho_r1) == 1
    _assert_parity(hj, ht, je.server, te.server)
    for acc in te.server.transport._acc.values():
        assert acc and all(not isinstance(p[0], tuple) for p in acc)


def test_dora_checkpoint_crosses_packages(tmp_path):
    """A mid-buffer DoRA checkpoint of the async engine (int8 with error
    feedback) written by the JAX server restores into the port with the
    pending plan's magnitudes (``g{gi}/M/...``) bit for bit beside its
    quantized factors, and the drain aggregates to JAX's; the port's own
    checkpoint of that state restores into a JAX server and drains to the
    same result."""
    je, te, _ = _buffered_pair("async")
    je.server.run(1)
    assert je.server._pending
    jpath = str(tmp_path / "jax")
    je.server.save(jpath)
    te.server.restore(jpath)
    ((_, _, jf),), ((_, _, tf),) = (je.server._pending[0].group_factors,
                                    te.server._pending[0].group_factors)
    assert sorted(map(str, tf)) == sorted(map(str, jf))
    n_mags = 0
    for key, val in jf.items():
        if isinstance(key[0], tuple):
            n_mags += 1
            np.testing.assert_array_equal(tf[key].numpy(), np.asarray(val))
        else:
            for jq, tq in zip(val, tf[key]):
                assert is_quantized(tq)
                np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert n_mags == 6
    tpath = str(tmp_path / "torch")
    te.server.save(tpath)
    je.server.drain_pending()
    te.server.drain_pending()
    back, _, _ = _buffered_pair("async")
    back.server.restore(tpath)
    back.server.drain_pending()
    for sj in (je.server, back.server):
        hj = [sj.history[-1]]
        _assert_parity(hj, [te.server.history[-1]], sj, te.server)


def test_dora_store_skips_and_warns():
    """A DoRA run with a bound ``AdapterStore``: the store refuses the
    magnitudes at publish, the hook degrades to a warning and the round
    loop goes on (``tests/test_serving.py``'s
    ``test_unservable_adapters_skip_and_warn``)."""
    exp = t_build("raflora", device="cpu",
                  fl_overrides={"num_clients": 4, "participation": 1.0,
                                "num_rounds": 2, "local_batch_size": 4},
                  lora_overrides={"rank_levels": (4, 8),
                                  "rank_probs": (0.5, 0.5),
                                  "variant": "dora"},
                  num_classes=4, d_model=32, samples_per_class=8,
                  batches_per_round=1)
    store = AdapterStore((4, 8))
    store.bind_server(exp.server)
    with pytest.warns(RuntimeWarning, match="post-aggregate hook"):
        exp.server.run(2)
    assert exp.server.adapter_version == 2
    assert store.published is None


def test_variants_bench_matches_reference(monkeypatch):
    """The ``variants`` bench (Table 5) at one round: the port's rows are
    named as the JAX bench's, and its FlexLoRA-DoRA row (the Table 5
    case that degrades), from the weights of the JAX bench's own
    experiment (``test_torch_benches.Recorder``), matches its higher-rank
    energy ratio (round parity plus the rows' 4 decimals); the other
    cases are stood in for on both sides."""
    from test_torch_benches import ENERGY_ATOL, Recorder
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    recorder = Recorder(monkeypatch)
    cases = {("dora", "flexlora")}

    class Skipped:
        def eval_accuracy(self):
            return float("nan")

        class server:
            class energy:
                rho_r1 = [0.0]
                higher_rank_ratio = [float("nan")]

    def pick(quick_fl):
        def picked(method, **kw):
            if (kw["lora_overrides"]["variant"], method) not in cases:
                return Skipped(), 0.0
            return quick_fl(method, **kw)
        return picked

    monkeypatch.setattr(j_variants, "ROUNDS", 1)
    monkeypatch.setattr(t_variants, "ROUNDS", 1)
    monkeypatch.setattr(j_variants, "quick_fl", pick(j_common.quick_fl))
    monkeypatch.setattr(t_variants, "quick_fl", pick(recorder.quick_fl))
    j_variants.run()
    t_variants.run(device="cpu")
    jr = {r["name"]: r for r in j_common.ROWS}
    tr = {r["name"]: r for r in t_common.ROWS}
    j_common.ROWS.clear()
    t_common.ROWS.clear()
    assert list(tr) == list(jr) and len(jr) == 6
    for variant, method in cases:
        name = f"table5_variants/{variant}/{method}"
        assert abs(float(tr[name]["higher_rank"])
                   - float(jr[name]["higher_rank"])) <= ENERGY_ATOL
