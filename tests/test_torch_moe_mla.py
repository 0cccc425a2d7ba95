"""Multi-head latent attention and mixture-of-experts in the port, held to
the JAX package on the CPU: DeepSeek-V2 (MLA with kv_lora 512 and q_lora
1536; 160 routed experts top-6 plus 2 shared) and Llama-4 Maverick (128
experts top-1 plus 1 shared, dense and MoE layers alternating, so the
layers stack in groups ``sub0`` / ``sub1``).

The registered configs field for field and their full-width
``param_shapes()`` leaf for leaf; the router, the MoE layer (also against
a dense every-token-through-every-expert oracle) and MLA's full-sequence
and decode paths (q_lora_rank 0 and > 0) alone; the reduced models'
forward, loss with the aux loss and LoRA gradients; cache shapes and a
prefill-then-decode against the forward; the serving engine against the
JAX engine (DeepSeek with ragged slots, Llama-4's layer groups); and one
raFLoRA round of the port's BATCHED
engine against the reference's SEQUENTIAL one (whose batched engine
cannot vmap ``ragged_dot``, ROADMAP.md queue 3).

The reduced models keep 8 experts (``reduced(max_experts=8)``), so
DeepSeek's top-6 really chooses. A router near-tie (a k-th and (k+1)-th
probability within f32 noise) may route a token differently in the two
packages without any fault of the port, so every test that routes
through the reference records the reference router's smallest top-k
margin at its inputs and asserts it above ``MARGIN`` first. Near-ties
are common at these sizes (the 6th and 7th of 8 probabilities sit close):
the model batch's seed (2) and the round data's (4) were picked as the
first whose margins clear 1e-4 for both models; at seeds 1 and 0 the
smallest margins were 1.8e-5 and 4.8e-5, and every comparison below still
held there. Tolerances:
atol 1e-5, rtol 1e-4 on logits, outputs and gradients; the loss at rtol
1e-5; rounds as tests/test_torch_round.py compares them."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.core.lora import split_lora as j_split
from repro.federation import ClientRegistry as JRegistry
from repro.federation import FederatedLoRA as JServer
from repro.models import build_model
from repro.models.layers import mla as jmla
from repro.models.layers import moe as jmoe
from repro.serving import AdapterStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import (FLConfig, FrontendConfig, MLAConfig,
                                      MoEConfig, ModelConfig)
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, merge_lora, split_lora, unflatten
from repro_torch.data import SequenceCopy, batches, make_partition
from repro_torch.federation import ClientRegistry
from repro_torch.federation.server import FederatedLoRA
from repro_torch.models.layers import mla as tmla
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.transformer import Model
from repro_torch.serving import AdapterStore, ServingEngine
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

DS, L4 = "deepseek-v2-236b", "llama4-maverick-400b-a17b"
MODELS = [DS, L4]
TOL = dict(atol=1e-5, rtol=1e-4)
LEVELS = (4, 8, 16)
LORA = dict(rank_levels=LEVELS, rank_probs=(1 / 3,) * 3)
REDUCED = dict(d_model=64, max_experts=8)
MARGIN = 1e-4


def _port_config(jcfg) -> ModelConfig:
    kw = dataclasses.asdict(jcfg)
    return ModelConfig(**dict(
        kw, moe=None if jcfg.moe is None else MoEConfig(**kw["moe"]),
        mla=None if jcfg.mla is None else MLAConfig(**kw["mla"]),
        frontend=FrontendConfig(**kw["frontend"])))


@contextlib.contextmanager
def _router_margins():
    """Record, through the reference's ``router_topk``, the smallest gap
    between each token's k-th and (k+1)-th expert probability: a list
    that fills as the reference runs (jit, scan and grad included)."""
    margins = []
    inner = jmoe.router_topk

    def recording(logits, top_k):
        probs = jnp.sort(jax.nn.softmax(logits.astype(jnp.float32), -1),
                         axis=-1)[..., ::-1]
        if top_k < probs.shape[-1]:
            gap = jnp.min(probs[..., top_k - 1] - probs[..., top_k])
            jax.debug.callback(lambda g: margins.append(float(g)), gap)
        return inner(logits, top_k)
    jmoe.router_topk = recording
    try:
        yield margins
    finally:
        jmoe.router_topk = inner


def _assert_margin(margins):
    print(f"smallest reference router top-k margin: {min(margins):.3e} "
          f"over {len(margins)} router calls")
    assert margins and min(margins) > MARGIN


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_config_matches_reference(name):
    """The registered config, field for field (the MoE, MLA and frontend
    sub-configs too), its default reduced form and the tests' own."""
    jcfg = j_config(name)
    assert get_config(name) == _port_config(jcfg)
    assert get_config(name).reduced() == _port_config(jcfg.reduced())
    assert get_config(name).reduced(**REDUCED) == _port_config(
        jcfg.reduced(**REDUCED))
    moe = get_config(name).moe
    assert [moe.is_moe_layer(i) for i in range(4)] == [
        jcfg.moe.is_moe_layer(i) for i in range(4)]


@pytest.mark.parametrize("name,count", [
    (DS, 239_408_071_680), (L4, 400_763_229_184)])
def test_full_param_shapes_match_reference(name, count):
    """``param_shapes()`` at full width allocates nothing (meta tensors)
    and gives the reference's leaves and shapes: DeepSeek-V2's q_a / q_b
    / kv_a / kv_b MLA leaves and its stacked experts, Llama-4's ``sub0``
    (dense) and ``sub1`` (MoE) groups."""
    got = flatten(Model(get_config(name), LoRAConfig(**LORA),
                        device="cpu").param_shapes())
    shapes = jax.tree_util.tree_leaves_with_path(
        build_model(j_config(name), JLoRA(**LORA)).param_shapes())
    want = {tuple(str(k.key) for k in path): tuple(s.shape)
            for path, s in shapes}
    assert {p: tuple(t.shape) for p, t in got.items()} == want
    assert all(t.device.type == "meta" for t in got.values())
    assert sum(t.numel() for t in got.values()) == count


# ---------------------------------------------------------------------------
# the router and the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k", [1, 6])
def test_router_topk_matches_reference(top_k):
    """Identical logits (C 2 clients, 24 tokens, 8 experts): equal expert
    ids, weights and per-client aux (the reference called per client)."""
    logits = np.random.default_rng(0).normal(size=(2, 24, 8)).astype(
        np.float32)
    w, e, aux = tmoe.router_topk(torch.from_numpy(logits), top_k)
    for c in range(2):
        with _router_margins() as margins:
            jw, je, jaux = jmoe.router_topk(jnp.asarray(logits[c]), top_k)
        _assert_margin(margins)
        np.testing.assert_array_equal(e[c].numpy(), np.asarray(je))
        np.testing.assert_allclose(w[c].numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(float(aux[c]), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("top_k", [2, 6])
def test_router_topk_breaks_ties_as_reference(top_k):
    """Exact ties (6 tokens over 8 experts: all-equal logits, pairs,
    triples and a periodic row) route to the reference's experts, lower
    index first as ``jax.lax.top_k`` orders them, with its weights (at
    ``TOL``: the renormalising sum may round differently) and aux;
    ``torch.topk`` left the order of ties open."""
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5]] = 1.0
    logits[2, [5, 6, 7]] = 0.5
    logits[3] = np.arange(8) % 3
    logits[4, ::2] = -1.0
    logits[5] = [3.0, 1.0, 3.0, 1.0, 2.0, 2.0, 2.0, 0.0]
    w, e, aux = tmoe.router_topk(torch.from_numpy(logits), top_k)
    jw, je, jaux = jmoe.router_topk(jnp.asarray(logits), top_k)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert e[0].tolist() == list(range(top_k))


NONFINITE_ROUTER_ROWS = {
    "nan": [0.5, np.nan, 1.0, -1.0, 2.0, 0.0, 1.5, -0.5],
    "pos_inf": [0.5, 1.0, np.inf, -1.0, 2.0, 0.0, 1.5, -0.5],
    "two_pos_inf": [np.inf, 1.0, 0.0, -1.0, np.inf, 0.0, 1.5, -0.5],
    "neg_inf": [-np.inf, 1.0, -np.inf, -1.0, 2.0, -np.inf, 1.5, -0.5],
    "all_neg_inf": [-np.inf] * 8,
}


@pytest.mark.parametrize("case", list(NONFINITE_ROUTER_ROWS))
def test_router_topk_on_non_finite_logits_as_reference(case):
    """A token's router logits with a NaN, +inf (one or two), some -inf or
    all -inf, beside a plain token: the reference's expert ids, weights
    and aux (NaN where the reference's are NaN) at top-2 and top-6. Each
    case's softmax is NaN or has exact zeros, so the order comes from the
    tie and NaN rules of the two sorts."""
    logits = np.stack([np.asarray(NONFINITE_ROUTER_ROWS[case], np.float32),
                       np.random.default_rng(3).normal(size=8)]).astype(
        np.float32)
    for top_k in (2, 6):
        w, e, aux = tmoe.router_topk(torch.from_numpy(logits), top_k)
        jw, je, jaux = jmoe.router_topk(jnp.asarray(logits), top_k)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _moe_case(name, seed):
    cfg = j_config(name).reduced(**REDUCED)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.moe,
                       cfg.activation, lora_ranks={})
    x = np.random.default_rng(seed).normal(
        size=(2, 3, 10, cfg.d_model)).astype(np.float32)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x


@pytest.mark.parametrize("name", MODELS)
def test_moe_apply_matches_reference_and_dense_oracle(name):
    """Two clients of 3 x 10 tokens through the reduced MoE layer (8
    experts and one shared expert; top-6 for DeepSeek, top-1 for
    Llama-4): the sorted dispatch equals the reference's per client, the
    aux per client too, and both equal the dense oracle's; one host sync
    a call."""
    cfg, jp, tp, x = _moe_case(name, 3)
    syncs = tmoe.moe_apply.host_syncs
    out, aux = tmoe.moe_apply(tp, torch.from_numpy(x), cfg.moe,
                              cfg.activation)
    assert tmoe.moe_apply.host_syncs == syncs + 1
    dense, dense_aux = tmoe.moe_apply_dense(tp, torch.from_numpy(x), cfg.moe,
                                            cfg.activation)
    assert out.shape == x.shape and aux.shape == (2,)
    for c in range(2):
        with _router_margins() as margins:
            jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x[c]), cfg.moe,
                                        cfg.activation)
        _assert_margin(margins)
        np.testing.assert_allclose(out[c].numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(float(aux[c]), float(jaux), rtol=1e-6)
    torch.testing.assert_close(out, dense, **TOL)
    torch.testing.assert_close(aux, dense_aux, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

MLA_RANKS = {"q_a_proj": 8, "kv_a_proj": 8, "o_proj": 8}


def _mla_case(q_lora_rank, seed=4):
    """A reduced MLA config (q_lora_rank 0: the ``q`` branch; > 0:
    ``q_a``, its norm and ``q_b``), the reference's params with lora_b
    away from 0, and the port's with a client axis on the adapters."""
    cfg = j_config(DS).reduced(**REDUCED)
    mcfg = dataclasses.replace(cfg.mla, q_lora_rank=q_lora_rank)
    jp = jmla.mla_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.num_heads,
                       mcfg, lora_ranks=MLA_RANKS)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * jax.random.normal(jax.random.PRNGKey(9),
                                                   x.shape)
                      if str(p[-1].key) == "lora_b" else x), jp)
    jp = jax.tree.map(np.asarray, jp)
    tp = unflatten({p: t[None] if p[-1].startswith("lora_") else t
                    for p, t in flatten(params_from_numpy(jp, "cpu")).items()})
    assert ("q_a" in tp) == bool(q_lora_rank)
    return cfg, mcfg, jp, tp


@pytest.mark.parametrize("q_lora_rank", [0, 32])
def test_mla_attention_matches_reference(q_lora_rank):
    """2 x 12 tokens at distinct positions: the output and the cache's
    (c_kv, post-RoPE k_rope)."""
    cfg, mcfg, jp, tp = _mla_case(q_lora_rank)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pos = (rng.integers(0, 500, (2, 1)) + np.arange(12)).astype(np.int32)
    jout, (jckv, jkr) = jmla.mla_attention(
        jp, jnp.asarray(x), jnp.asarray(pos), cfg.num_heads, mcfg,
        rope_theta=cfg.rope_theta)
    out, (ckv, kr) = tmla.mla_attention(
        tp, torch.from_numpy(x)[None], torch.from_numpy(pos)[None],
        cfg.num_heads, mcfg, rope_theta=cfg.rope_theta)
    for got, want in ((out, jout), (ckv, jckv), (kr, jkr)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_lora_rank", [0, 32])
def test_mla_decode_matches_reference(q_lora_rank):
    """One token a row for 3 rows at ragged lengths 0, 5 and 9 against a
    random compressed cache of 10: the output and both caches after the
    per-row write."""
    cfg, mcfg, jp, tp = _mla_case(q_lora_rank)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(3, 10, mcfg.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(3, 10, mcfg.qk_rope_head_dim)).astype(np.float32)
    lens = np.asarray([0, 5, 9], np.int32)
    jout, (jckv, jkr) = jmla.mla_decode(
        jp, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(ckv),
        jnp.asarray(kr), jnp.asarray(lens), cfg.num_heads, mcfg,
        rope_theta=cfg.rope_theta, write_idx=jnp.asarray(lens))
    t_ckv, t_kr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    out = tmla.mla_decode(tp, torch.from_numpy(x)[None],
                          torch.from_numpy(lens)[None, :, None], t_ckv, t_kr,
                          torch.from_numpy(lens), cfg.num_heads, mcfg,
                          rope_theta=cfg.rope_theta)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(t_ckv.numpy(), np.asarray(jckv), **TOL)
    np.testing.assert_allclose(t_kr.numpy(), np.asarray(jkr), **TOL)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

def _pair(jcfg, tcfg, seed=0):
    """JAX and port models of one config, the JAX weights carried over,
    lora_b drawn away from 0 so the adapters act."""
    jm = build_model(jcfg, JLoRA(**LORA), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                                   x.shape)
                      if str(getattr(p[-1], "key", "")) == "lora_b" else x),
        jm.init(jax.random.PRNGKey(seed)))
    params = jax.tree.map(np.asarray, params)
    tm = Model(tcfg, LoRAConfig(**LORA), device="cpu")
    return jm, tm, params, params_from_numpy(params, "cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(j_config(name).reduced(**REDUCED),
                        get_config(name).reduced(**REDUCED))
            for name in MODELS}


def _batch(cfg, b=2, t=16, seed=2):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)
                                   ).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, t)
                                    ).astype(np.int32)}


@pytest.mark.parametrize("name", MODELS)
def test_reduced_forward_and_loss_match_reference(models, name):
    """Logits and aux at full and truncated adapters, then ``train_loss``:
    the loss with the aux, and the metrics' loss without it and aux."""
    jm, tm, jp, tp = models[name]
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _router_margins() as margins:
        for rank in (-1, 4):
            want, jaux, _ = jm.forward_seq(jp, jb, lora_rank=rank)
            got, aux, _ = tm.forward_seq(tp, batch, lora_rank=rank)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
            assert float(aux) > 0
        lj, mj = jm.train_loss(jp, jb, lora_rank=8)
    _assert_margin(margins)
    lt, mt = tm.train_loss(tp, batch, lora_rank=8)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for key in ("loss", "aux_loss", "accuracy"):
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(lt), float(mt["loss"] + mt["aux_loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_lora_gradients_match_reference(models, name):
    """The client's training step: the gradient of ``train_loss`` (the
    aux loss included) with respect to every LoRA factor equals
    ``jax.grad``'s: DeepSeek's q / kv_a / o adapters, Llama-4's q/k/v/o in
    both groups' layers."""
    jm, tm, jp, tp = models[name]
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jbase, jlora = j_split(jax.tree.map(jnp.asarray, jp))

    def jloss(lora):
        merged = jax.tree.map(lambda b, l: b if l is None else l, jbase,
                              lora, is_leaf=lambda x: x is None)
        return jm.train_loss(merged, jb, lora_rank=8)[0]

    with _router_margins() as margins:
        want = params_from_numpy(jax.tree.map(
            lambda x: None if x is None else np.asarray(x),
            jax.grad(jloss)(jlora), is_leaf=lambda x: x is None), "cpu")
    _assert_margin(margins)
    base, lora = split_lora(tp)
    leaves = flatten(lora)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = tm.train_loss(merge_lora(base, lora), batch, lora_rank=8)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = flatten(want)
    assert set(want) == set(leaves)
    expect = (("layers", "attn", "kv_a", "lora_a") if name == DS
              else ("layers", "sub1", "attn", "q", "lora_a"))
    assert expect in leaves
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   err_msg=str(path), **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_cache_shapes_match_reference(name):
    """DeepSeek's {"ckv", "krope"}, Llama-4's {"sub0", "sub1"} of {"k",
    "v"}, on a group axis."""
    cfg_of = lambda g: g(name).reduced(**REDUCED)  # noqa: E731
    jm = build_model(cfg_of(j_config), JLoRA())
    tm = Model(cfg_of(get_config), LoRAConfig(), device="cpu")
    for batch_size, max_len in ((3, 40), (2, 10)):
        want = {tuple(str(k.key) for k in path): s for path, s in
                jax.tree_util.tree_leaves_with_path(
                    jm.cache_shapes(batch_size, max_len)["layers"])}
        got = flatten(tm.cache_shapes(batch_size, max_len)["layers"])
        assert set(got) == set(want)
        for path, spec in want.items():
            assert got[path].shape == spec.shape, path
            assert str(got[path].dtype).split(".")[-1] == str(spec.dtype)
    keys = {p[-1] for p in got}
    assert keys == ({"ckv", "krope"} if name == DS else {"k", "v"})


@pytest.mark.parametrize("name", MODELS)
def test_prefill_then_decode_matches_forward(models, name):
    """A prefill of 8 tokens, then 8 ``decode_step``s on a cache of 16,
    give the logits of the full 16-token forward at those positions."""
    _, tm, _, tp = models[name]
    tokens = _batch(tm.cfg)["tokens"]
    full = tm.forward_seq(tp, {"tokens": tokens})[0]
    logits, caches = tm.prefill(tp, {"tokens": tokens[:, :8]})
    torch.testing.assert_close(logits, full[:, :8], **TOL)
    cache = tm.init_cache(2, 16)
    layers = flatten(cache["layers"])
    for path, leaf in flatten(caches).items():
        layers[path][:, :, :8] = leaf
    cache = {"layers": unflatten(layers),
             "len": torch.tensor(8, dtype=torch.int32)}
    for t in range(8, 16):
        step, cache = tm.decode_step(tp, {"token": tokens[:, t:t + 1]},
                                     cache)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

def _tenants(jparams, seed):
    rng = np.random.default_rng(seed)
    _, jlora = j_split(jparams)
    trees = [jax.tree.map(
        lambda x: None if x is None else
        (0.05 * rng.normal(size=x.shape)).astype(np.float32), jlora,
        is_leaf=lambda x: x is None) for _ in range(2)]
    return {"hi": (trees[0], 16), "lo": (trees[1], 4)}


def test_deepseek_ragged_engine_matches_jax_engine(models):
    """The reference's ``test_e2e_mla_ragged_slots_matches_full_forward``
    shape: slot 0 admits 8 tokens and decodes alone, slot 1 admits 5
    tokens later, then both decode at lengths 9 and 5 on the compressed
    cache: every call's tokens equal the JAX engine's, with the plain path
    and with ``use_kernels`` (MLA and the experts take no K4, as in the
    reference)."""
    jm, tm, jp, _ = models[DS]
    tenants = _tenants(jp, 5)
    rng = np.random.default_rng(7)
    p0 = rng.integers(0, tm.cfg.vocab_size, (1, 8)).astype(np.int32)
    p1 = rng.integers(0, tm.cfg.vocab_size, (1, 5)).astype(np.int32)
    calls = [("admit", [0], p0, ["hi"]), ("decode", [True, False]),
             ("admit", [1], p1, ["lo"]), ("decode", [True, True]),
             ("decode", [True, True])]
    jstore = JStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        jstore.put(aid, tree, rank)
    jstore.publish()
    jeng = JEngine(jm, jp, jstore, max_len=14, slots=2)
    with _router_margins() as margins:
        want = [np.asarray(jeng.admit(*c[1:]) if c[0] == "admit"
                           else jeng.decode(jnp.asarray(c[1])))
                for c in calls]
    _assert_margin(margins)
    for kern in (False, True):
        store = AdapterStore(LEVELS)
        for aid, (tree, rank) in tenants.items():
            store.put(aid, params_from_numpy(tree, "cpu"), rank)
        store.publish()
        eng = ServingEngine(Model(tm.cfg, LoRAConfig(rank_levels=LEVELS),
                                  device="cpu", use_kernels=kern),
                            params_from_numpy(jp, "cpu"), store,
                            max_len=14, slots=2)
        for i, c in enumerate(calls):
            got = (eng.admit(*c[1:]) if c[0] == "admit"
                   else eng.decode(c[1]))
            np.testing.assert_array_equal(got.numpy(), want[i],
                                          err_msg=f"call {i}")
        assert set(eng.cache["layers"]) == {"ckv", "krope"}
        np.testing.assert_array_equal(eng.slot_len().numpy(), [11, 7])


def test_llama4_grouped_engine_matches_jax_engine(models):
    """Llama-4's layer groups through the serving path: the store's pages
    (P, G, r, in) under ``sub0`` / ``sub1``, ``seed_cache`` on the
    grouped prefill caches and the grouped decode; 2 slots of 8 tokens
    and 3 decode steps: every call's tokens equal the JAX engine's."""
    jm, tm, jp, _ = models[L4]
    tenants = _tenants(jp, 6)
    prompts = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 8)).astype(np.int32)
    calls = ([("admit", [0, 1], prompts, ["hi", "lo"])]
             + [("decode", [True, True])] * 3)
    jstore = JStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        jstore.put(aid, tree, rank)
    jstore.publish()
    jeng = JEngine(jm, jp, jstore, max_len=12, slots=2)
    with _router_margins() as margins:
        want = [np.asarray(jeng.admit(*c[1:]) if c[0] == "admit"
                           else jeng.decode(jnp.asarray(c[1])))
                for c in calls]
    _assert_margin(margins)
    store = AdapterStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        store.put(aid, params_from_numpy(tree, "cpu"), rank)
    snap = store.publish()
    assert snap.pages["layers"]["sub1"]["attn"]["q"]["lora_a"].shape == (
        2, 1, 16, tm.cfg.d_model)
    eng = ServingEngine(Model(tm.cfg, LoRAConfig(rank_levels=LEVELS),
                              device="cpu"),
                        params_from_numpy(jp, "cpu"), store, max_len=12,
                        slots=2)
    for i, c in enumerate(calls):
        got = eng.admit(*c[1:]) if c[0] == "admit" else eng.decode(c[1])
        np.testing.assert_array_equal(got.numpy(), want[i],
                                      err_msg=f"call {i}")
    assert set(eng.cache["layers"]) == {"sub0", "sub1"}


# ---------------------------------------------------------------------------
# one raFLoRA round: the port's batched engine, the reference's sequential
# ---------------------------------------------------------------------------

ROUND_FL = dict(aggregator="raflora", num_clients=4, participation=1.0,
                num_rounds=1, local_batch_size=2, learning_rate=2e-3,
                partition="pathological", labels_per_client=2)


def _round_servers(name, jm, jp):
    """The reference's sequential server and the port's batched one, both
    on the kernel backend, from the same weights, on ``SequenceCopy``
    tokens (bit-equal in both packages) of 16 in the reduced vocabulary."""
    from repro.configs import FLConfig as JFL
    from repro.data import make_partition as j_partition
    cfg = jm.cfg
    data = SequenceCopy(vocab_size=cfg.vocab_size, seq_len=16,
                        num_families=4, samples_per_family=4, seed=4)
    tokens, targets, family = data.generate()
    servers = []
    for pkg in ("jax", "torch"):
        fl = (JFL if pkg == "jax" else FLConfig)(**ROUND_FL)
        lora = (JLoRA if pkg == "jax" else LoRAConfig)(**LORA)
        shards = (j_partition if pkg == "jax" else make_partition)(
            fl.partition, family, fl.num_clients,
            labels_per_client=fl.labels_per_client, seed=fl.seed)
        registry = (JRegistry if pkg == "jax" else ClientRegistry).create(
            fl, lora, shards)

        def batch_fn(cid, rng, registry=registry):
            idx = registry.shards[cid]
            bx, by = next(batches(tokens[idx], targets[idx], 2, rng))
            return [{"tokens": bx, "targets": by}]
        if pkg == "jax":
            servers.append(JServer(jm, fl, lora, registry, batch_fn,
                                   base_params=jp, backend="kernel",
                                   round_engine="sequential"))
        else:
            servers.append(FederatedLoRA(
                Model(get_config(name).reduced(**REDUCED), lora,
                      device="cpu"), fl, lora, registry, batch_fn,
                base_params=params_from_numpy(jp, "cpu"), backend="kernel"))
    return servers


def _factors(server):
    r_max = server.lora_cfg.r_max
    return {tuple(p): tuple(np.asarray(x) for x in f) for p, f in
            server._extract_factors(server.global_lora, r_max).items()}


@pytest.mark.parametrize("name", MODELS)
def test_batched_round_matches_reference_sequential_round(models, name):
    """One round from identical state: same clients and ranks, loss (the
    metrics' loss, without the aux) at rtol 1e-4, spectra within 1e-3 of
    sigma_max and products within 2e-3 of it (the kernel path's
    tolerances), every adapter parent in the same order: DeepSeek's
    q / kv_a / o, Llama-4's ``sub0`` and ``sub1`` q/k/v/o, which share one
    shape bucket in the port's engine."""
    jm, _, jp, _ = models[name]
    js, ts = _round_servers(name, jm, jp)
    with _router_margins() as margins:
        (sj,) = js.run(1)
    _assert_margin(margins)
    (st,) = ts.run(1)
    assert st.clients == sj.clients and st.ranks == sj.ranks
    np.testing.assert_allclose(st.mean_client_loss, sj.mean_client_loss,
                               rtol=1e-4)
    scale = max(1.0, float(np.abs(sj.sigma_probe).max()))
    np.testing.assert_allclose(st.sigma_probe, sj.sigma_probe,
                               atol=1e-3 * scale)
    fj, ft = _factors(js), _factors(ts)
    assert list(ft) == list(fj)
    assert len(fj) == (3 if name == DS else 8)
    for parent, (b, a) in fj.items():
        tb, ta = ft[parent]
        np.testing.assert_allclose(tb @ ta, b @ a, atol=2e-3 * scale,
                                   err_msg=str(parent))
    assert np.isfinite(st.mean_client_loss)
