"""The port's serving subsystem (``repro_torch.serving``) held to the JAX
package's: adapter-store pages bit-equal to the reference store's, the
store's bucket / version / masking rules, path-aware cache seeding, greedy
tokens equal to the JAX ``ServingEngine`` and to the port's own
full-sequence greedy, ragged admission, hot-swap atomicity and the
round-landing hook on the port's federated round.

Models are reduced qwen2-7b with ``num_kv_heads=2`` (GQA) on the CPU; the
kernel route (``use_kernels=True``) takes K4's plain version here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_get_config
from repro.core.lora import split_lora as j_split
from repro.models import build_model
from repro.serving import AdapterStore as JStore
from repro.serving import ServingEngine as JEngine
from repro.serving import seed_cache as j_seed_cache
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, merge_lora, split_lora
from repro_torch.models.transformer import Model
from repro_torch.serving import AdapterStore, ServingEngine, seed_cache
from repro_torch.serving.engine import greedy

torch.set_num_threads(1)

LEVELS = (4, 8, 16)


def _toy_tree(r=16, d_in=8, d_out=6, val=1.0):
    return {"proj": {"lora_a": torch.full((r, d_in), val),
                     "lora_b": torch.full((d_out, r), val)}}


# ---------------------------------------------------------------------------
# AdapterStore
# ---------------------------------------------------------------------------

class TestAdapterStore:
    def test_bucket_order_and_page_ids(self):
        store = AdapterStore(LEVELS)
        store.put("c", _toy_tree(), 16)
        store.put("a", _toy_tree(), 4)
        store.put("b", _toy_tree(), 4)
        snap = store.publish()
        assert snap.page_of == {"a": 0, "b": 1, "c": 2}
        assert snap.ranks == (4, 4, 16) and snap.num_pages == 3
        assert store.buckets() == {4: ["a", "b"], 8: [], 16: ["c"]}
        np.testing.assert_array_equal(
            snap.page_ids(["c", "a", "c"]).numpy(), [2, 0, 2])
        assert snap.pages["proj"]["lora_a"].shape[0] == 3

    def test_monotonic_version(self):
        store = AdapterStore(LEVELS)
        store.put("t", _toy_tree(), 8)
        assert store.publish().version == 1
        with pytest.raises(ValueError, match="monotonic"):
            store.publish(1)
        assert store.publish(5).version == 5
        assert store.publish().version == 6 == store.version

    def test_masking_padding_and_scale_fold(self):
        store = AdapterStore(LEVELS, scaling_fn=lambda r: 32.0 / r)
        store.put("t", _toy_tree(r=8), 4)     # true rank 4, staged at r=8
        snap = store.publish()
        a = snap.pages["proj"]["lora_a"][0].numpy()     # (16, 8)
        b = snap.pages["proj"]["lora_b"][0].numpy()     # (6, 16)
        assert a.shape == (16, 8) and b.shape == (6, 16)
        assert (a[:4] == 1.0).all() and (a[4:] == 0.0).all()
        assert (b[:, :4] == 8.0).all() and (b[:, 4:] == 0.0).all()
        assert snap.scales == (8.0,)

    def test_errors(self):
        store = AdapterStore(LEVELS)
        with pytest.raises(ValueError, match="not in levels"):
            store.put("t", _toy_tree(), 5)
        with pytest.raises(ValueError, match="no staged"):
            store.publish()
        tree = _toy_tree()
        tree["proj"]["lora_m"] = torch.ones(6)
        store.put("t", tree, 16)
        with pytest.raises(ValueError, match="DoRA"):
            store.publish()

    def test_pages_bit_equal_to_reference_store(self, qwen):
        """Same tenants, ranks (staged below r_max and at it) and a
        non-unit scaling on both sides: every page leaf bit for bit."""
        _, _, params, _ = qwen
        _, jlora = j_split(params)
        trees = _tenant_trees(jlora, 3, seed=20)
        # one tenant staged at a narrower width than r_max
        trees[1] = jax.tree.map(
            lambda x: None if x is None else (
                x[..., :8, :] if x.shape[-2] == 16 else x[..., :8]),
            trees[1], is_leaf=lambda x: x is None)
        scaling = (lambda r: 16.0 / r)
        jstore, tstore = JStore(LEVELS, scaling), AdapterStore(LEVELS,
                                                               scaling)
        for aid, tree, rank in zip(("x", "y", "z"), trees, (16, 8, 4)):
            jstore.put(aid, tree, rank)
            tstore.put(aid, params_from_numpy(tree, "cpu"), rank)
        jsnap, tsnap = jstore.publish(), tstore.publish()
        assert tsnap.page_of == dict(jsnap.page_of)
        assert tsnap.ranks == jsnap.ranks and tsnap.scales == jsnap.scales
        want = flatten(params_from_numpy(
            jax.tree.map(np.asarray, jsnap.pages), "cpu"))
        got = flatten(tsnap.pages)
        assert set(got) == set(want) and len(got) == 8
        for path in want:
            assert got[path].dtype == want[path].dtype
            assert np.array_equal(got[path].numpy(), want[path].numpy()), \
                path


# ---------------------------------------------------------------------------
# seed_cache
# ---------------------------------------------------------------------------

class TestSeedCache:
    def test_ssm_state_with_coincidental_prompt_len_dim(self):
        lp, s_full, slots = 4, 10, 3
        cache = {"layers": {"conv": torch.zeros(2, slots, lp, 5),
                            "ssm": torch.zeros(2, slots, 7, 5),
                            "k": torch.zeros(2, slots, s_full, 2, 2)},
                 "len": torch.zeros(slots, dtype=torch.int32)}
        got = {"conv": torch.ones(2, slots, lp, 5),
               "ssm": 2.0 * torch.ones(2, slots, 7, 5),
               "k": 3.0 * torch.ones(2, slots, lp, 2, 2)}
        out = seed_cache(cache, got, lp, [True, True, True])
        assert (out["layers"]["conv"] == 1.0).all()
        assert (out["layers"]["ssm"] == 2.0).all()
        k = out["layers"]["k"]
        assert (k[:, :, :lp] == 3.0).all() and (k[:, :, lp:] == 0.0).all()
        np.testing.assert_array_equal(out["len"].numpy(), lp)

    def test_mask_reseeds_only_selected_slots(self):
        lp, s_full, slots = 2, 6, 3
        cache = {"layers": {"k": torch.zeros(1, slots, s_full, 2)},
                 "len": torch.full((slots,), 5, dtype=torch.int32)}
        got = {"k": torch.ones(1, slots, lp, 2)}
        out = seed_cache(cache, got, lp, [False, True, False])
        k = out["layers"]["k"]
        assert (k[:, 0] == 0.0).all() and (k[:, 2] == 0.0).all()
        assert (k[:, 1, :lp] == 1.0).all()
        np.testing.assert_array_equal(out["len"].numpy(), [5, lp, 5])

    def test_unknown_leaf_key_raises(self):
        cache = {"layers": {"mystery": torch.zeros(1, 2, 3)},
                 "len": torch.zeros(2, dtype=torch.int32)}
        with pytest.raises(ValueError, match="unknown cache leaf"):
            seed_cache(cache, {"mystery": torch.ones(1, 2, 3)}, 3,
                       [True, True])

    def test_ring_scatter_matches_reference(self):
        """prompt_len 7 > ring length 5: the last 5 positions land at
        t % 5, as the reference scatters them."""
        rng = np.random.default_rng(3)
        full = rng.normal(size=(2, 3, 5, 2, 4)).astype(np.float32)
        got = rng.normal(size=(2, 3, 7, 2, 4)).astype(np.float32)
        lens = np.array([1, 2, 3], np.int32)
        mask = np.array([True, False, True])
        want = j_seed_cache(
            {"layers": {"k": jnp.asarray(full)}, "len": jnp.asarray(lens)},
            {"k": jnp.asarray(got)}, 7, jnp.asarray(mask))
        out = seed_cache(
            {"layers": {"k": torch.from_numpy(full)},
             "len": torch.from_numpy(lens)},
            {"k": torch.from_numpy(got)}, 7, torch.from_numpy(mask))
        np.testing.assert_array_equal(out["layers"]["k"].numpy(),
                                      np.asarray(want["layers"]["k"]))
        np.testing.assert_array_equal(out["len"].numpy(),
                                      np.asarray(want["len"]))


def test_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    np.testing.assert_array_equal(greedy(logits).numpy(), [1, 0])
    assert greedy(logits).dtype == torch.int32


# ---------------------------------------------------------------------------
# the engine, end to end
# ---------------------------------------------------------------------------

def _configs(**replace):
    kw = dict(num_kv_heads=2, **replace)
    return (dataclasses.replace(j_get_config("qwen2-7b").reduced(), **kw),
            dataclasses.replace(get_config("qwen2-7b").reduced(), **kw))


def _tenant_trees(jlora, n, seed, scale=0.05):
    """n random nonzero JAX adapter trees (init has B = 0, which would
    test nothing), numpy leaves, None at base leaves."""
    rng = np.random.default_rng(seed)
    return [jax.tree.map(
        lambda x: None if x is None else
        (scale * rng.normal(size=x.shape)).astype(np.float32), jlora,
        is_leaf=lambda x: x is None) for _ in range(n)]


def _mask_rank(tree: dict, rank: int) -> dict:
    """Port tree with factor columns >= rank zeroed (the store's rule)."""
    out = {}
    for path, x in flatten(tree).items():
        ax = x.ndim - 2 if path[-1] == "lora_a" else x.ndim - 1
        keep = (torch.arange(x.shape[ax]) < rank).to(x.dtype)
        shape = [1] * x.ndim
        shape[ax] = x.shape[ax]
        out[path] = x * keep.reshape(shape)
    from repro_torch.core.lora import unflatten
    return unflatten(out)


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _configs()
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False, block_q=16, block_kv=16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jcfg, jm, params, tcfg


def _greedy_reference(model, params, prompt, n_tokens):
    """Greedy continuation by repeated full-sequence forwards."""
    toks = list(np.asarray(prompt))
    out = []
    for _ in range(n_tokens):
        with torch.no_grad():
            logits, _, _ = model.forward_seq(
                params, {"tokens": torch.tensor([toks], dtype=torch.int32)})
        nxt = int(greedy(logits[0, -1]))
        out.append(nxt)
        toks.append(nxt)
    return out


@pytest.fixture(scope="module")
def two_tenants(qwen):
    jcfg, jm, params, tcfg = qwen
    _, jlora = j_split(params)
    hi, lo = _tenant_trees(jlora, 2, seed=7)
    prompts = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jstore = JStore(LEVELS)
    jstore.put("hi", hi, 16)
    jstore.put("lo", lo, 4)
    jstore.publish()
    jeng = JEngine(jm, params, jstore, max_len=13, slots=2)
    want = [np.asarray(jeng.admit([0, 1], jnp.asarray(prompts),
                                  ["hi", "lo"]))]
    for _ in range(3):
        want.append(np.asarray(jeng.decode(jnp.array([True, True]))))
    return hi, lo, prompts, np.stack(want, axis=1)


def _port_engine(tcfg, params, trees_ranks, *, use_kernels=False,
                 max_len=13, slots=2):
    model = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu",
                  use_kernels=use_kernels)
    store = AdapterStore(LEVELS)
    for aid, (tree, rank) in trees_ranks.items():
        store.put(aid, params_from_numpy(tree, "cpu"), rank)
    store.publish()
    tparams = params_from_numpy(params, "cpu")
    return model, tparams, store, ServingEngine(model, tparams, store,
                                                max_len=max_len, slots=slots)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_e2e_greedy_matches_jax_engine_and_full_forward(qwen, two_tenants,
                                                        use_kernels):
    """Two slots with tenants at ranks 16 and 4, 8-token prompts, 4 new
    tokens: the port's greedy tokens equal the JAX ServingEngine's, and
    each slot's equal the port's own full-sequence greedy at that slot's
    rank-masked adapter."""
    jcfg, jm, params, tcfg = qwen
    hi, lo, prompts, want = two_tenants
    model, tparams, store, eng = _port_engine(
        tcfg, params, {"hi": (hi, 16), "lo": (lo, 4)},
        use_kernels=use_kernels)
    gen = [eng.admit([0, 1], prompts, ["hi", "lo"]).numpy()]
    for _ in range(3):
        gen.append(eng.decode([True, True]).numpy())
    gen = np.stack(gen, axis=1)
    np.testing.assert_array_equal(gen, want)
    assert eng.version_log == [1] * 4
    np.testing.assert_array_equal(eng.slot_len().numpy(), [11, 11])
    if use_kernels:
        return
    base, _ = split_lora(tparams)
    for row, (tree, rank) in enumerate([(hi, 16), (lo, 4)]):
        merged = merge_lora(base, _mask_rank(params_from_numpy(tree, "cpu"),
                                             rank))
        assert list(gen[row]) == _greedy_reference(model, merged,
                                                   prompts[row], 4), row


def test_ragged_admission_matches_full_forward(qwen, two_tenants):
    """Slot 1 is admitted mid-stream with a shorter prompt, so the slots'
    ``len`` differ while both decode; slot 0 decodes alone first (slot 1
    inactive and frozen). Each slot's tokens equal its own full-sequence
    greedy."""
    jcfg, jm, params, tcfg = qwen
    hi, lo, prompts, _ = two_tenants
    model, tparams, store, eng = _port_engine(
        tcfg, params, {"hi": (hi, 16), "lo": (lo, 4)}, max_len=14)
    p0, p1 = prompts[0], prompts[1, :5]
    gen0 = [int(eng.admit([0], p0[None], ["hi"])[0])]
    frozen = {k: v.clone() for k, v in eng.cache["layers"].items()}
    gen0.append(int(eng.decode([True, False])[0]))
    assert torch.equal(eng.cache["layers"]["k"][:, 1], frozen["k"][:, 1])
    assert int(eng.slot_len()[1]) == 0
    gen1 = [int(eng.admit([1], p1[None], ["lo"])[0])]
    lens = eng.slot_len().numpy()
    assert lens[0] != lens[1], "slots must be genuinely ragged"
    for _ in range(2):
        toks = eng.decode([True, True])
        gen0.append(int(toks[0]))
        gen1.append(int(toks[1]))
    base, _ = split_lora(tparams)
    for tree, rank, prompt, gen in ((hi, 16, p0, gen0), (lo, 4, p1, gen1)):
        merged = merge_lora(base, _mask_rank(params_from_numpy(tree, "cpu"),
                                             rank))
        assert gen == _greedy_reference(model, merged, prompt, len(gen))


def test_hot_swap_atomic_no_version_mixing():
    """Mid-stream publish: (a) every engine step runs on one snapshot
    version and the version log flips once; (b) post-flip tokens are
    BIT-EQUAL to a fresh engine on the new adapters that teacher-forces
    the same prefix. One layer and cache-neutral targets (q/o feed nothing
    that is cached), so the cache depends only on the tokens."""
    jcfg, tcfg = _configs(num_layers=1, lora_targets=("q_proj", "o_proj"))
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    _, jlora = j_split(params)
    v1, v2 = _tenant_trees(jlora, 2, seed=3)
    lp, pre, post = 8, 3, 4
    prompts = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, size=(2, lp)).astype(np.int32)
    model, tparams, store, eng = _port_engine(
        tcfg, params, {"t": (v1, 16)}, max_len=lp + pre + post + 2)
    seq = [eng.admit([0, 1], prompts, ["t", "t"]).numpy()]
    for _ in range(pre):
        seq.append(eng.decode([True, True]).numpy())
    store.put("t", params_from_numpy(v2, "cpu"), 16)
    store.publish()
    for _ in range(post):
        seq.append(eng.decode([True, True]).numpy())
    seq = np.stack(seq, axis=1)
    assert eng.version_log == [1] * (1 + pre) + [2] * post

    _, _, _, fresh = _port_engine(tcfg, params, {"t": (v2, 16)},
                                  max_len=lp + pre + post + 2)
    fresh.admit([0, 1], prompts, ["t", "t"])
    replay = []
    for t in range(pre + post):
        fresh.tokens = torch.from_numpy(seq[:, t].copy())
        replay.append(fresh.decode([True, True]).numpy())
    replay = np.stack(replay, axis=1)
    np.testing.assert_array_equal(replay[:, pre:], seq[:, 1 + pre:])


def test_engine_rejects_unpublished_store(qwen):
    _, _, params, tcfg = qwen
    model = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu")
    with pytest.raises(ValueError, match="publish"):
        ServingEngine(model, params_from_numpy(params, "cpu"),
                      AdapterStore(LEVELS), max_len=8, slots=1)


# ---------------------------------------------------------------------------
# round landing -> serving
# ---------------------------------------------------------------------------

def test_bind_server_publishes_every_round_landing():
    """The port's fedvit-tiny batched kernel-backend round with a bound
    store: 3 rounds give versions [1, 2, 3], and the published page is the
    server's global adapter."""
    from repro_torch.federation.experiment import build_experiment
    exp = build_experiment(
        "raflora", fl_overrides={"num_clients": 4, "participation": 1.0,
                                 "num_rounds": 8, "local_batch_size": 4},
        lora_overrides={"rank_levels": (4, 8), "rank_probs": (0.5, 0.5)},
        num_classes=4, d_model=32, samples_per_class=8,
        batches_per_round=1, backend="kernel", device="cpu")
    seen = []
    exp.server.add_post_aggregate_hook(lambda v, tree: seen.append(v))
    store = AdapterStore((4, 8))
    store.bind_server(exp.server)
    exp.server.run(3)
    assert seen == [1, 2, 3] and store.version == 3
    snap = store.published
    assert snap.ranks == (8,) and snap.page_of == {"global": 0}
    want = flatten(exp.server.global_lora)
    got = flatten(snap.pages)
    assert set(got) == set(want)
    for path, leaf in want.items():
        torch.testing.assert_close(got[path][0], leaf, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# an attention-free SSM model: reduced mamba2 (conv/ssm cache leaves)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-1.3b on both sides from one set of JAX weights, and
    two random nonzero tenants (LoRA on the SSD mixer's in/out_proj)."""
    jcfg = j_get_config("mamba2-1.3b").reduced()
    tcfg = get_config("mamba2-1.3b").reduced()
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    _, jlora = j_split(params)
    hi, lo = _tenant_trees(jlora, 2, seed=11)
    return jcfg, jm, params, tcfg, {"hi": (hi, 16), "lo": (lo, 4)}


def _run_calls(eng, calls, to_np):
    """Drive an engine through ("admit", slots, prompts, tenants) /
    ("decode", mask) calls; every call's returned tokens as numpy."""
    out = []
    for call in calls:
        if call[0] == "admit":
            out.append(to_np(eng.admit(*call[1:])))
        else:
            out.append(to_np(eng.decode(call[1])))
    return out


def _jax_run(jm, params, tenants, calls, max_len):
    store = JStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        store.put(aid, tree, rank)
    store.publish()
    eng = JEngine(jm, params, store, max_len=max_len, slots=2)
    return _run_calls(eng, [(c[0], *map(jnp.asarray, c[1:]))
                            if c[0] == "decode" else c for c in calls],
                      np.asarray)


def test_ssm_pages_bit_equal_to_reference_store(mamba):
    """The mixer's in_proj / out_proj pages at ranks 16 and 4 with a
    non-unit scaling, bit for bit."""
    _, _, _, _, tenants = mamba
    scaling = (lambda r: 16.0 / r)
    jstore, tstore = JStore(LEVELS, scaling), AdapterStore(LEVELS, scaling)
    for aid, (tree, rank) in tenants.items():
        jstore.put(aid, tree, rank)
        tstore.put(aid, params_from_numpy(tree, "cpu"), rank)
    jsnap, tsnap = jstore.publish(), tstore.publish()
    assert tsnap.page_of == dict(jsnap.page_of)
    want = flatten(params_from_numpy(
        jax.tree.map(np.asarray, jsnap.pages), "cpu"))
    got = flatten(tsnap.pages)
    assert set(got) == set(want) and len(got) == 4
    assert ("layers", "ssm", "in_proj", "lora_a") in got
    for path in want:
        assert np.array_equal(got[path].numpy(), want[path].numpy()), path


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ssm_engine_matches_jax_engine(mamba, use_kernels):
    """Two slots at ranks 16 and 4, 32-token prompts (one chunk), 3 decode
    steps: the port's greedy tokens equal the JAX ServingEngine's, and the
    engine's state cache holds only ``conv`` / ``ssm`` leaves."""
    jcfg, jm, params, tcfg, tenants = mamba
    prompts = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, size=(2, 32)).astype(np.int32)
    calls = [("admit", [0, 1], prompts, ["hi", "lo"])] + \
        [("decode", [True, True])] * 3
    want = _jax_run(jm, params, tenants, calls, max_len=36)
    _, _, _, eng = _port_engine(tcfg, params, tenants,
                                use_kernels=use_kernels, max_len=36)
    got = _run_calls(eng, calls, lambda t: t.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert set(eng.cache["layers"]) == {"conv", "ssm"}
    assert eng.cache["layers"]["ssm"].dtype == torch.float32
    np.testing.assert_array_equal(eng.slot_len().numpy(), [35, 35])


def test_ssm_ragged_admission_matches_jax_engine(mamba):
    """Slot 0 admitted with 32 tokens decodes alone (slot 1 inactive: its
    conv and SSM states stay exactly zero), then slot 1 is admitted with a
    16-token prompt (chunk = min(32, 16)); every call's tokens equal the
    JAX engine's through the same calls."""
    jcfg, jm, params, tcfg, tenants = mamba
    rng = np.random.default_rng(13)
    p0 = rng.integers(0, jcfg.vocab_size, size=(1, 32)).astype(np.int32)
    p1 = rng.integers(0, jcfg.vocab_size, size=(1, 16)).astype(np.int32)
    calls = [("admit", [0], p0, ["hi"]), ("decode", [True, False]),
             ("admit", [1], p1, ["lo"]), ("decode", [True, True]),
             ("decode", [True, True])]
    want = _jax_run(jm, params, tenants, calls, max_len=40)
    _, _, _, eng = _port_engine(tcfg, params, tenants, max_len=40)
    got = _run_calls(eng, calls[:2], lambda t: t.numpy())
    for key, leaf in eng.cache["layers"].items():
        assert (leaf[:, 1] == 0).all(), key
    got += _run_calls(eng, calls[2:], lambda t: t.numpy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(eng.slot_len().numpy(), [35, 18])
