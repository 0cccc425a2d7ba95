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
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

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


NAN, INF = float("nan"), float("inf")
# one row of 8 logits a case, each exact in bf16; None: seeded rows only
GREEDY_ROWS = {
    "nan_first": [NAN, 1, 2, 3, 0, 5, 1, 2],
    "nan_middle": [0, 1, NAN, 1, 7, 2, 1, 0],
    "nan_last": [3, 1, 2, 3, 0, 5, 1, NAN],
    "two_nans": [1, NAN, 4, 5, NAN, 2, 9, 1],
    "nan_beside_inf": [0, INF, NAN, 1, 2, INF, NAN, 3],
    "pm_inf": [INF, 1, INF, 0, -INF, 2, -INF, 3],
    "all_neg_inf": [-INF] * 8,
    "all_pos_inf": [INF] * 8,
    "ties": [0, 2, 2, 1, 2, 0, 1, 2],
    "all_equal": [5] * 8,
    "plain": None,
}


def _greedy_logits(case: str) -> np.ndarray:
    """The case's row above two seeded normal rows, (3, 8) f32."""
    rows = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
    if GREEDY_ROWS[case] is None:
        return rows
    return np.concatenate([np.asarray([GREEDY_ROWS[case]], np.float32),
                           rows])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GREEDY_ROWS))
def test_greedy_takes_the_first_maximum(case, dtype):
    """``greedy`` against ``jnp.argmax`` on the same logits in f32 and
    bf16: the first maximum, a NaN counting as greater than every number
    (so a row with a NaN gives its first NaN), int32, bit-equal indices;
    a 1-D row as a batch of one."""
    logits = _greedy_logits(case)
    t = torch.from_numpy(logits).to(getattr(torch, dtype))
    j = jnp.asarray(logits).astype(dtype)
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    want = np.asarray(jnp.argmax(j, axis=-1)).astype(np.int32)
    got = greedy(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert greedy(t[0]).dtype == torch.int32 and int(greedy(t[0])) == want[0]


@pytest.mark.parametrize("seam", ["serve_step", "accuracy"])
def test_launch_seams_choose_as_reference(seam):
    """The launcher's serve step (``launch/steps.py``) and the train loss's
    accuracy (``Model.train_loss_clients``) choose by the reference's rule
    on every special row of ``GREEDY_ROWS``: the same logits through
    stand-in models that return them, f32. Accuracy is read per row
    against two targets, the reference's argmax and the first maximum
    of the row's numbers."""
    from types import SimpleNamespace

    from repro.launch import steps as j_steps
    from repro.models.transformer import Model as JModel
    from repro_torch.launch import steps as t_steps
    logits = np.stack([_greedy_logits(c)[0] for c in GREEDY_ROWS
                       if GREEDY_ROWS[c] is not None])          # (R, V)
    if seam == "serve_step":
        tok, _ = t_steps.build_serve_step(SimpleNamespace(
            decode_step=lambda *a, **k: (torch.from_numpy(logits)[:, None],
                                         {})), 8)(None, {}, {})
        jtok, _ = j_steps.build_serve_step(SimpleNamespace(
            decode_step=lambda *a, **k: (jnp.asarray(logits)[:, None],
                                         {})), 8)(None, {}, {})
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        return
    numbers = np.where(np.isnan(logits), -np.inf, logits)
    for targets in (np.argmax(logits, -1), np.argmax(numbers, -1)):
        _, metrics = Model.train_loss_clients(SimpleNamespace(
            forward_seq_clients=lambda *a, **k: (
                torch.from_numpy(logits)[:, None, None],
                torch.zeros(len(logits)), None)),
            None, None, {"targets": torch.from_numpy(targets)[:, None, None]},
            None)
        want = [float(JModel.train_loss(SimpleNamespace(
            forward_seq=lambda *a, row=row, **k: (
                jnp.asarray(row)[None, None], 0.0, None)),
            None, {"targets": jnp.asarray([[t]])})[1]["accuracy"])
            for row, t in zip(logits, targets)]
        np.testing.assert_array_equal(metrics["accuracy"].numpy(), want)


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


def _with_nan(tree: dict) -> dict:
    """A copy of a numpy adapter tree with a NaN at [0, 0, 0] of its first
    ``lora_b`` leaf (group 0, output row 0, rank column 0: inside every
    rank, so the store's rank mask keeps it)."""
    hit = []

    def walk(node):
        out = {}
        for key, leaf in node.items():
            if isinstance(leaf, dict):
                leaf = walk(leaf)
            elif key == "lora_b" and not hit:
                leaf = leaf.copy()
                leaf[0, 0, 0] = np.nan
                hit.append(key)
            out[key] = leaf
        return out
    return walk(tree)


@pytest.fixture(scope="module")
def jax_faults(qwen, two_tenants):
    """The reference engine on the two tenants with "hi" poisoned
    (``_with_nan``): its tokens over admit plus two decode steps. Then, on
    the same engine with "hi" clean again, the same three steps after
    prompts whose slot 1 holds token V (one past the vocabulary) at
    position 3."""
    jcfg, jm, params, tcfg = qwen
    hi, lo, prompts, _ = two_tenants
    jstore = JStore(LEVELS)
    jstore.put("hi", _with_nan(hi), 16)
    jstore.put("lo", lo, 4)
    jstore.publish()
    jeng = JEngine(jm, params, jstore, max_len=11, slots=2)

    def three_steps(p):
        out = [np.asarray(jeng.admit([0, 1], jnp.asarray(p), ["hi", "lo"]))]
        for _ in range(2):
            out.append(np.asarray(jeng.decode(jnp.array([True, True]))))
        return np.stack(out, axis=1)

    poisoned = three_steps(prompts)
    jstore.put("hi", hi, 16)
    jstore.publish()
    bad = prompts.copy()
    bad[1, 3] = jcfg.vocab_size
    return poisoned, bad, three_steps(bad)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_nan_tenant_matches_jax_engine(qwen, two_tenants, jax_faults,
                                       use_kernels):
    """One tenant's B leaf holds a NaN: admit plus two decode steps give
    the reference engine's tokens for every slot and raise nothing; the
    poisoned slot's logits are NaN and its tokens in range (the first
    NaN, as ``jnp.argmax``), the clean slot's tokens those of the run
    without the NaN."""
    jcfg, jm, params, tcfg = qwen
    hi, lo, prompts, clean = two_tenants
    want = jax_faults[0]
    _, _, _, eng = _port_engine(
        tcfg, params, {"hi": (_with_nan(hi), 16), "lo": (lo, 4)},
        use_kernels=use_kernels, max_len=11)
    gen = [eng.admit([0, 1], prompts, ["hi", "lo"]).numpy()]
    for _ in range(2):
        gen.append(eng.decode([True, True]).numpy())
    gen = np.stack(gen, axis=1)
    np.testing.assert_array_equal(gen, want)
    assert torch.isnan(eng.last_logits[0]).all()
    assert not torch.isnan(eng.last_logits[1]).any()
    assert ((gen >= 0) & (gen < jcfg.vocab_size)).all()
    np.testing.assert_array_equal(gen[1], clean[1, :3])


def test_prompt_token_past_the_vocabulary_diverges(qwen, two_tenants,
                                                   jax_faults):
    """A prompt token equal to V, once a pinned divergence, now held equal
    to the reference: the reference embeds it by ``jnp.take``, whose
    default mode fills an out-of-range row with NaN (it does not clamp),
    and so does the port (``take_rows``). Over admit plus two decode
    steps that slot's tokens are all 0 (the first NaN of all-NaN logits),
    unlike the clamped token V - 1's, and the other slot's are the clean
    run's, on the plain route and the K4 route, with nothing raised."""
    jcfg, jm, params, tcfg = qwen
    hi, lo, prompts, clean = two_tenants
    _, bad, want = jax_faults
    np.testing.assert_array_equal(want[0], clean[0, :3])
    np.testing.assert_array_equal(want[1], [0, 0, 0])
    for use_kernels in (False, True):
        _, _, _, eng = _port_engine(tcfg, params, {"hi": (hi, 16),
                                                   "lo": (lo, 4)},
                                    use_kernels=use_kernels, max_len=11)
        clamped = bad.copy()
        clamped[1, 3] = jcfg.vocab_size - 1
        assert int(eng.admit([0, 1], clamped, ["hi", "lo"])[1]) != 0
        gen = [eng.admit([0, 1], bad, ["hi", "lo"]).numpy()]
        assert torch.isnan(eng.last_logits[1]).all()
        for _ in range(2):
            gen.append(eng.decode([True, True]).numpy())
        np.testing.assert_array_equal(np.stack(gen, axis=1), want)


# ---------------------------------------------------------------------------
# token ids and targets outside the vocabulary, as the reference takes them
# ---------------------------------------------------------------------------

def _bad_ids(v: int) -> tuple:
    """The ids of every rule of ``jnp.take``: past the end (V, V + 7),
    wrapped from the end (-1, -V) and past the start (-V - 1)."""
    return v, v + 7, -1, -v, -v - 1


def _same_with_nan(got, want, **tol):
    """NaN exactly where the reference has NaN, the rest within tol."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], **tol)


def test_page_gather_takes_ids_as_reference_engine():
    """The engine's page gather (``_gather``) at ids past the end, from
    the end and past the start: every leaf equal to the reference engine's
    ``leaf[page_ids]`` (a negative id counts from the end, then clamped to
    [0, P - 1]), nested trees included."""
    from repro_torch.serving.engine import _gather
    pages = {"a": np.arange(3 * 2 * 4, dtype=np.float32).reshape(3, 2, 4),
             "sub": {"b": -np.arange(3 * 5, dtype=np.float32)
                     .reshape(3, 5)}}
    ids = np.array([0, 3, 6, -1, -3, -4, 2], np.int32)
    got = _gather({"a": torch.from_numpy(pages["a"]),
                   "sub": {"b": torch.from_numpy(pages["sub"]["b"])}},
                  torch.from_numpy(ids))
    for leaf, want in ((got["a"], pages["a"]), (got["sub"]["b"],
                                                pages["sub"]["b"])):
        np.testing.assert_array_equal(
            leaf.numpy(), np.asarray(jnp.asarray(want)[jnp.asarray(ids)]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_take_rows_as_jnp_take(dtype):
    """Every id rule of ``jnp.take``'s default mode on a (5, 3) table of
    either dtype: rows id mod V for ids in [-V, V), NaN rows in the
    table's dtype for the others, bit for bit."""
    from repro_torch.models.transformer import take_rows
    table = np.arange(15, dtype=np.float32).reshape(5, 3) - 7.0
    ids = np.array([[0, 4, *_bad_ids(5)], [2, -3, 1, 9, -11, 3, 0]],
                   np.int32)
    want = jnp.take(jnp.asarray(table, dtype), jnp.asarray(ids), axis=0)
    got = take_rows(torch.from_numpy(table).to(getattr(torch, dtype)),
                    torch.from_numpy(ids))
    assert got.dtype == getattr(torch, dtype)
    _same_with_nan(got.float().numpy(), np.asarray(want, np.float32),
                   rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["prefill", "decode", "train"])
def test_out_of_range_tokens_match_reference(qwen, two_tenants, entry):
    """Token ids V, V + 7, -1, -V and -V - 1 through the reference model
    and the port at the same weights (tenant "hi" merged in): NaN logits
    where the reference has them (a decode row from V, V + 7 or -V - 1;
    in prefill every position of a sequence that holds one, whose NaN key
    and value reach every query through the masked softmax's 0 * NaN),
    the wrapped ids' rows and every other row within the decode tests'
    tolerance; the prefill's k cache alike. Training gives the
    reference's loss (NaN) and accuracy."""
    from repro.core.lora import merge_lora as j_merge
    jcfg, jm, params, tcfg = qwen
    hi = two_tenants[0]
    v = jcfg.vocab_size
    jbase, _ = j_split(jax.tree.map(jnp.asarray, params))
    jparams = j_merge(jbase, jax.tree.map(
        lambda x: None if x is None else jnp.asarray(x), hi,
        is_leaf=lambda x: x is None))
    model = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu")
    base, _ = split_lora(params_from_numpy(params, "cpu"))
    lora = flatten(params_from_numpy(hi, "cpu"))
    from repro_torch.core.lora import unflatten
    tparams = merge_lora(base, unflatten(lora))
    bad = _bad_ids(v)
    prompts = np.random.default_rng(11).integers(0, v, size=(3, 8))
    prompts[0, [1, 5]] = bad[2:4]           # wrapped: every row finite
    prompts[1, 6] = bad[0]                  # rows 6, 7 NaN
    prompts[2, [2, 4]] = bad[1], bad[4]     # rows 2..7 NaN
    prompts = prompts.astype(np.int32)
    tol = dict(rtol=1e-4, atol=1e-5)
    if entry == "decode":
        tok = np.array([[t] for t in bad + (3,)], np.int32)
        want, _ = jm.decode_step(jparams, {"token": jnp.asarray(tok)},
                                 jm.init_cache(len(tok), 4))
        with torch.no_grad():
            got, _ = model.decode_step(tparams,
                                       {"token": torch.from_numpy(tok)},
                                       model.init_cache(len(tok), 4))
        assert np.isnan(np.asarray(want))[[0, 1, 4]].all()
        _same_with_nan(got.numpy(), want, **tol)
        return
    if entry == "prefill":
        want, jcaches = jm.prefill(jparams, {"tokens": jnp.asarray(prompts)})
        with torch.no_grad():
            got, caches = model.prefill(tparams,
                                        {"tokens": torch.from_numpy(prompts)})
        _same_with_nan(got.numpy(), want, **tol)
        _same_with_nan(caches["k"].numpy(), jcaches["k"], **tol)
        assert not np.isnan(np.asarray(want)[0]).any()
        return
    batch = {"tokens": prompts, "targets": np.roll(prompts, -1, 1) % v}
    j_val, j_metrics = jm.train_loss(jparams, batch, lora_rank=16)
    with torch.no_grad():
        t_val, t_metrics = model.train_loss(tparams, batch, lora_rank=16)
    assert np.isnan(float(j_val)) and np.isnan(t_val.item())
    for key in ("loss", "accuracy"):
        _same_with_nan([t_metrics[key].item()], [float(j_metrics[key])],
                       **tol)


class _Offset:
    """Within the block the reference model's logits carry ``offset``."""

    def __init__(self, jm, offset):
        self.jm, self.offset = jm, offset

    def __enter__(self):
        jm, off = self.jm, self.offset
        jm._logits = lambda p, x: type(jm)._logits(jm, p, x) + off

    def __exit__(self, *exc):
        del self.jm._logits


# the reference's compiled loss and LoRA gradients with an offset on its
# logits: one program for every case of the test below
_JAX_LOSS_GRAD: dict = {}


def _jax_loss_grad(jm, jbase, jlora, batch, offset):
    from repro.core.lora import merge_lora as j_merge
    if jm not in _JAX_LOSS_GRAD:
        def loss(lora_tree, off, b):
            with _Offset(jm, off):
                return jm.train_loss(j_merge(jbase, lora_tree), b,
                                     lora_rank=16)[0]
        _JAX_LOSS_GRAD[jm] = jax.jit(jax.value_and_grad(loss))
    return _JAX_LOSS_GRAD[jm](jlora, jnp.asarray(offset),
                              jax.tree.map(jnp.asarray, batch))


@pytest.mark.parametrize("case", ["targets_outside", "minus_inf_column",
                                  "plus_inf_column"])
def test_loss_targets_and_infinite_logits_match_reference(
        qwen, two_tenants, case):
    """The reference's gold logit is the one-hot contraction sum(logits *
    one_hot(t)), and the port's ``gold_logits`` its rule: targets V and -1
    have gold 0 (the loss is their logsumexp), and an infinite non-target
    logit column gives a NaN loss (0 * inf) with the contraction's
    gradient, softmax - one-hot. The same offset (a -inf or +inf column,
    or none) is added to both models' logits; the loss equals the
    reference's ``train_loss`` and every LoRA gradient the reference's,
    NaN where it has NaN, the rest within rtol 1e-4 (f32 sums in another
    order). The reference's compiled program (its training steps') gives
    the same gradients but takes the contraction as a select, with no
    0 * inf, so its loss at a -inf column is finite where ``train_loss``
    run as written gives NaN (ROADMAP.md queue 3)."""
    from repro.core.lora import merge_lora as j_merge
    from repro_torch.core.lora import unflatten
    jcfg, jm, params, tcfg = qwen
    hi = two_tenants[0]
    v = jcfg.vocab_size
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, v, size=(2, 6)).astype(np.int32)
    targets = rng.integers(1, v, size=(2, 6)).astype(np.int32)
    offset = np.zeros(v, np.float32)
    if case == "targets_outside":
        targets[0, 2], targets[1, 4] = v, -1
    else:
        offset[0] = -np.inf if case == "minus_inf_column" else np.inf
    batch = {"tokens": tokens, "targets": targets,
             "loss_mask": (rng.random((2, 6)) < 0.8).astype(np.float32)}
    jbase, _ = j_split(jax.tree.map(jnp.asarray, params))
    jlora = jax.tree.map(lambda x: None if x is None else jnp.asarray(x), hi,
                         is_leaf=lambda x: x is None)
    with _Offset(jm, jnp.asarray(offset)):
        j_val = float(jm.train_loss(j_merge(jbase, jlora), batch,
                                    lora_rank=16)[0])
    compiled, j_grads = _jax_loss_grad(jm, jbase, jlora, batch, offset)
    if case == "minus_inf_column":
        assert np.isfinite(float(compiled)) and np.isnan(j_val)
    else:
        _same_with_nan([float(compiled)], [j_val], rtol=1e-6)
    model = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu")
    t_logits = model._logits
    model._logits = lambda p, x: t_logits(p, x) + torch.from_numpy(offset)
    base, _ = split_lora(params_from_numpy(params, "cpu"))
    lora = {p: t.requires_grad_(True)
            for p, t in flatten(params_from_numpy(hi, "cpu")).items()}
    t_val, _ = model.train_loss(merge_lora(base, unflatten(lora)), batch,
                                lora_rank=16)
    grads = torch.autograd.grad(t_val, list(lora.values()))
    assert np.isnan(j_val) == (case != "targets_outside")
    _same_with_nan([t_val.item()], [j_val], rtol=1e-4)
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 j_grads)[0]}
    assert set(jflat) == set(lora)
    for path, g in zip(lora, grads):
        want = np.asarray(jflat[path])
        if case != "plus_inf_column":
            assert np.isfinite(want).all() and np.abs(want).max() > 0
        floor = 1e-6 * max(float(np.nanmax(np.abs(want), initial=0)), 1e-30)
        _same_with_nan(g.numpy(), want, rtol=1e-4, atol=floor)


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
