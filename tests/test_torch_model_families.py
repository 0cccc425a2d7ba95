"""Three more model families in the port, held to the JAX package on the
CPU: Gemma-2B (MQA, GeGLU, tied head, token embeddings scaled by
sqrt(d_model)), Hymba-1.5B (hybrid blocks: attention beside an SSD mixer
on the same normed input, a sliding window with global layers) and
Qwen2-VL-7B (patch embeddings before the tokens, M-RoPE).

Each reduced model runs from the JAX weights carried over by
``convert.params_from_numpy``: the forward and ``train_loss``, Hymba's
LoRA gradients, a prefill and 8 decode steps against the full forward,
``cache_shapes``, and the serving engine's greedy tokens against the JAX
``ServingEngine``. Reduced Hymba keeps 2 layers (layer 0 global, layer 1
windowed at 64) and runs 96 tokens, so the window bites and the SSD scan
carries its state over 3 chunks of 32. The pieces (M-RoPE, attention with
a window and a softcap, the windowed decode) are held to the reference's
functions alone. Tolerances: atol 1e-5, rtol 1e-4 on logits and
gradients, the loss at rtol 1e-5; Hymba's logits and gradients at atol
1e-4, the reduced mamba2's model-level tolerance in test_torch_ssd.py
(the SSD dual form's decays amplify GEMM rounding: both packages' f32
logits sit 3.3-3.9e-5 from a float64 run of the port, and 3.5e-5 from
each other; with the SSD branch weighted 0 they agree to 1.2e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.core.lora import split_lora as j_split
from repro.models import build_model
from repro.models import transformer as jtransformer
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro.serving import AdapterStore as JStore
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import FrontendConfig, ModelConfig, SSMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, split_lora
from repro_torch.kernels import lora_apply as la
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import rope as trope
from repro_torch.models.transformer import Model
from repro_torch.serving import AdapterStore, ServingEngine

torch.set_num_threads(1)

MODELS = ["gemma-2b", "hymba-1.5b", "qwen2-vl-7b"]
TOL = dict(atol=1e-5, rtol=1e-4)
SSD_MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
TOLS = {"gemma-2b": TOL, "hymba-1.5b": SSD_MODEL_TOL, "qwen2-vl-7b": TOL}
LEVELS = (4, 8, 16)
HYMBA_LEN = 96       # past the reduced window of 64: 3 SSD chunks of 32


def _port_config(jcfg) -> ModelConfig:
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items()
          if k in fields and k not in ("moe", "mla", "ssm", "frontend")}
    ssm = (None if jcfg.ssm is None
           else SSMConfig(**dataclasses.asdict(jcfg.ssm)))
    return ModelConfig(frontend=FrontendConfig(**dataclasses.asdict(
        jcfg.frontend)), ssm=ssm, **kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_config_matches_reference(name):
    """The registered config, field for field (the SSM and frontend
    sub-configs too), and its reduced form."""
    jcfg = j_config(name)
    assert get_config(name) == _port_config(jcfg)
    assert get_config(name).reduced() == _port_config(jcfg.reduced())


@pytest.mark.parametrize("name,count", [
    ("gemma-2b", 2_509_858_816), ("hymba-1.5b", 1_653_436_096),
    ("qwen2-vl-7b", 7_638_554_112)])
def test_full_param_shapes_match_reference(name, count):
    """``param_shapes()`` at full width allocates nothing (meta tensors)
    and gives the reference's leaves and shapes (LoRA rank levels 4, 8,
    16 on the config's targets)."""
    lora = dict(rank_levels=LEVELS, rank_probs=(1 / 3,) * 3)
    got = flatten(Model(get_config(name), LoRAConfig(**lora),
                        device="cpu").param_shapes())
    shapes = jax.tree_util.tree_leaves_with_path(
        build_model(j_config(name), JLoRA(**lora)).param_shapes())
    want = {tuple(str(k.key) for k in path): tuple(s.shape)
            for path, s in shapes}
    assert {p: tuple(t.shape) for p, t in got.items()} == want
    assert all(t.device.type == "meta" for t in got.values())
    assert sum(t.numel() for t in got.values()) == count


@pytest.mark.parametrize("name,window,every", [
    ("qwen2-7b", 16, 0), ("qwen2-7b", 8192, 0), ("gemma-2b", 1024, 4)])
def test_with_sliding_window_matches_reference(name, window, every):
    got = get_config(name).with_sliding_window(window, every)
    assert got == _port_config(j_config(name).with_sliding_window(
        window, every))
    assert got.name == name + "-swa"


# ---------------------------------------------------------------------------
# RoPE and attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", [(4, 6, 6), (2, 3, 3)])
def test_mrope_matches_reference(sections):
    """Three distinct position streams; with equal streams M-RoPE is
    standard RoPE (the reference's test_mrope_equals_rope_for_text)."""
    rng = np.random.default_rng(0)
    d = 2 * sum(sections)
    x = rng.normal(size=(2, 8, 4, d)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(3, 2, 8)).astype(np.int32)
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    same = torch.from_numpy(pos[0])
    np.testing.assert_allclose(
        trope.apply_mrope(torch.from_numpy(x), same.expand(3, 2, 8), 1e4,
                          sections).numpy(),
        trope.apply_rope(torch.from_numpy(x), same, 1e4).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        trope.apply_mrope(torch.from_numpy(x), same.expand(3, 2, 8), 1e4,
                          (1, 1, 1))


@pytest.mark.parametrize("window", [1, 16, 100])
@pytest.mark.parametrize("softcap,q_offset", [(0.0, 0), (5.0, 0), (5.0, 3)])
def test_causal_attention_window_softcap_matches_reference(window, softcap,
                                                           q_offset):
    """GQA 4 query heads over 2 KV heads, L 40 (Lq 37 behind a q offset),
    windows 1, 16 and one longer than L, softcap 5 on scores scaled up so
    that it bites."""
    rng = np.random.default_rng(1)
    q = 3 * rng.normal(size=(2, 40 - q_offset, 4, 8)).astype(np.float32)
    k, v = (3 * rng.normal(size=(2, 40, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sliding_window=window, q_offset=q_offset, block_q=16, block_kv=16,
        softcap=softcap)
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v)),
                                 q_offset=q_offset, sliding_window=window,
                                 softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("total,lo", [
    (9, 3), (5, -4), (np.array([2, 9, 6], np.int32),
                      np.array([-3, 4, 1], np.int32))],
    ids=["scalar", "scalar-below-0", "per-slot"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_windowed_decode_matches_reference(total, lo, softcap):
    rng = np.random.default_rng(2)
    q = 3 * rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    k, v = (3 * rng.normal(size=(3, 9, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jtransformer._decode_attention_windowed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(total),
        jnp.asarray(lo), softcap=softcap)
    got = tattn.decode_attention_windowed(
        *map(torch.from_numpy, (q, k, v)), torch.as_tensor(total),
        torch.as_tensor(lo), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cache_len", [5, np.array([2, 7, 9], np.int32)],
                         ids=["scalar", "vector"])
def test_decode_attention_softcap_matches_reference(cache_len):
    rng = np.random.default_rng(3)
    q = 3 * rng.normal(size=(3, 1, 4, 8)).astype(np.float32)
    k, v = (3 * rng.normal(size=(3, 9, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cache_len),
                                  softcap=5.0)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                 torch.as_tensor(cache_len), softcap=5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------

def _pair(jcfg, tcfg, seed=0):
    """JAX and port models of one config, the JAX weights carried over,
    lora_b drawn away from 0 so the adapters act."""
    lora = dict(rank_levels=LEVELS, rank_probs=(1 / 3,) * 3)
    jm = build_model(jcfg, JLoRA(**lora), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                                   x.shape)
                      if str(getattr(p[-1], "key", "")) == "lora_b" else x),
        jm.init(jax.random.PRNGKey(seed)))
    params = jax.tree.map(np.asarray, params)
    tm = Model(tcfg, LoRAConfig(**lora), device="cpu")
    return jm, tm, params, params_from_numpy(params, "cpu")


@pytest.fixture(scope="module")
def models():
    return {name: _pair(j_config(name).reduced(), get_config(name).reduced())
            for name in MODELS}


def _batch(cfg, b=2, t=16, patches=0):
    """Tokens and targets; a VLM's ``patches`` patch embeddings first, with
    three distinct position streams over the whole sequence."""
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)
                                    ).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (b, t + patches)
                                     ).astype(np.int32)}
    if patches:
        batch["embeds"] = rng.normal(size=(b, patches, cfg.frontend.embed_dim)
                                     ).astype(np.float32)
        grid = np.arange(patches)
        side = int(np.sqrt(patches))
        text = side + np.arange(t)
        streams = [np.concatenate([np.zeros(patches, np.int64), text]),
                   np.concatenate([grid // side, text]),
                   np.concatenate([grid % side, text])]
        batch["positions"] = np.broadcast_to(
            np.stack(streams)[:, None], (3, b, patches + t)).astype(np.int32)
    return batch


BATCHES = {"gemma-2b": dict(t=16), "hymba-1.5b": dict(t=HYMBA_LEN),
           "qwen2-vl-7b": dict(t=12, patches=16)}


@pytest.mark.parametrize("name", MODELS)
def test_reduced_forward_and_loss_match_reference(models, name):
    """Logits at full and truncated adapters, then ``train_loss``."""
    jm, tm, jp, tp = models[name]
    batch = _batch(jm.cfg, **BATCHES[name])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for rank in (-1, 4):
        want = np.asarray(jm.forward_seq(jp, jb, lora_rank=rank)[0])
        got = tm.forward_seq(tp, batch, lora_rank=rank)[0].numpy()
        np.testing.assert_allclose(got, want, **TOLS[name])
    lj, mj = jm.train_loss(jp, jb, lora_rank=8)
    lt, mt = tm.train_loss(tp, batch, lora_rank=8)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["accuracy"]), float(mj["accuracy"]))


def test_mrope_positions_are_live(models):
    """Qwen2-VL's logits move with the height and width streams: the
    distinct streams give other logits than all three equal."""
    _, tm, _, tp = models["qwen2-vl-7b"]
    batch = _batch(tm.cfg, **BATCHES["qwen2-vl-7b"])
    flat = dict(batch, positions=np.broadcast_to(
        batch["positions"][:1], batch["positions"].shape).copy())
    a = tm.forward_seq(tp, batch)[0]
    b = tm.forward_seq(tp, flat)[0]
    assert float((a - b).abs().max()) > 1e-3


def test_gemma_scales_its_embeddings(models):
    """The reduced Gemma keeps the reference's rule (a dense model named
    gemma*): its forward differs from the same weights unscaled."""
    _, tm, _, tp = models["gemma-2b"]
    other = Model(dataclasses.replace(tm.cfg, name="dense-reduced"),
                  tm.lora, device="cpu")
    batch = _batch(tm.cfg)
    a = tm.forward_seq(tp, batch)[0]
    b = other.forward_seq(tp, batch)[0]
    assert float((a - b).abs().max()) > 1e-3


def test_hymba_lora_gradients_match_reference(models):
    """The client's training step through the hybrid block and the window
    on the plain scan: the gradient of ``train_loss`` with respect to
    every LoRA factor (attention's and the SSD mixer's) equals
    ``jax.grad``'s."""
    jm, tm, jp, tp = models["hymba-1.5b"]
    batch = _batch(jm.cfg, t=HYMBA_LEN)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jbase, jlora = j_split(jax.tree.map(jnp.asarray, jp))

    def jloss(lora):
        merged = jax.tree.map(lambda b, l: b if l is None else l, jbase,
                              lora, is_leaf=lambda x: x is None)
        return jm.train_loss(merged, jb, lora_rank=8)[0]

    want = params_from_numpy(jax.tree.map(
        lambda x: None if x is None else np.asarray(x),
        jax.grad(jloss)(jlora), is_leaf=lambda x: x is None), "cpu")
    base, lora = split_lora(tp)
    leaves = flatten(lora)
    for t in leaves.values():
        t.requires_grad_(True)
    from repro_torch.core.lora import merge_lora
    loss, _ = tm.train_loss(merge_lora(base, lora), batch, lora_rank=8)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = flatten(want)
    assert set(want) == set(leaves)
    assert ("layers", "ssm", "in_proj", "lora_a") in leaves
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(),
                                   err_msg=str(path), **SSD_MODEL_TOL)


DECODE = {"gemma-2b": dict(t=16), "hymba-1.5b": dict(t=HYMBA_LEN),
          "qwen2-vl-7b": dict(t=12, patches=16)}
# prefill lengths: the SSD scan takes multiples of its chunk (32)
PREFILL = {"gemma-2b": 8, "hymba-1.5b": 64, "qwen2-vl-7b": 20}


@pytest.mark.parametrize("name", MODELS)
def test_prefill_then_decode_matches_forward(models, name):
    """A prefill, then 8 ``decode_step``s, give the logits of the full
    forward (default positions) at those positions. Hymba prefills 64
    tokens and decodes to 72, past its window of 64, on a cache of 72
    (the window masks in decode)."""
    _, tm, _, tp = models[name]
    batch = _batch(tm.cfg, **DECODE[name])
    batch.pop("targets")
    batch.pop("positions", None)
    tokens = batch["tokens"]
    full = tm.forward_seq(tp, batch)[0]
    n_pre = PREFILL[name]
    n_text = n_pre - (full.shape[1] - tokens.shape[1])    # after patches
    logits, caches = tm.prefill(tp, dict(batch, tokens=tokens[:, :n_text]))
    torch.testing.assert_close(logits, full[:, :n_pre], **TOLS[name])
    cache = tm.init_cache(2, n_pre + 8)
    for key, leaf in caches.items():
        if key in ("k", "v"):
            cache["layers"][key][:, :, :n_pre] = leaf
        else:
            cache["layers"][key] = leaf
    cache["len"] = torch.tensor(n_pre, dtype=torch.int32)
    for i in range(8):
        t = n_text + i
        step, cache = tm.decode_step(tp, {"token": tokens[:, t:t + 1]},
                                     cache)
        torch.testing.assert_close(step[:, 0], full[:, n_pre + i],
                                   **TOLS[name])


@pytest.mark.parametrize("cfg_of", [
    lambda g: g("hymba-1.5b").reduced(),
    lambda g: g("qwen2-7b").with_sliding_window(16, 0),
    lambda g: g("gemma-2b").reduced(),
    lambda g: g("qwen2-vl-7b").reduced()],
    ids=["hybrid", "ring", "gemma", "qwen2-vl"])
def test_cache_shapes_match_reference(cfg_of):
    jm = build_model(cfg_of(j_config), JLoRA())
    tm = Model(cfg_of(get_config), LoRAConfig(), device="cpu")
    for batch_size, max_len in ((3, 40), (2, 10)):
        want = jm.cache_shapes(batch_size, max_len)
        got = tm.cache_shapes(batch_size, max_len)
        assert set(got["layers"]) == set(want["layers"])
        for key, spec in want["layers"].items():
            assert got["layers"][key].shape == spec.shape, key
            assert str(got["layers"][key].dtype).split(".")[-1] == \
                str(spec.dtype), key
        assert tm.cache_seq_len(max_len) == jm.cache_seq_len(max_len)


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


def _drive(eng, calls, to_np, wrap=lambda c: c):
    out = []
    for call in calls:
        call = wrap(call)
        out.append(to_np(eng.admit(*call[1:]) if call[0] == "admit"
                         else eng.decode(call[1])))
    return out


def _engines_agree(jm, tm_cfg, params, tenants, calls, max_len,
                   use_kernels=(False,)):
    jstore = JStore(LEVELS)
    for aid, (tree, rank) in tenants.items():
        jstore.put(aid, tree, rank)
    jstore.publish()
    jeng = JEngine(jm, params, jstore, max_len=max_len, slots=2)
    want = _drive(jeng, calls, np.asarray,
                  lambda c: (c[0], jnp.asarray(c[1])) if c[0] == "decode"
                  else c)
    engines = []
    for kern in use_kernels:
        store = AdapterStore(LEVELS)
        for aid, (tree, rank) in tenants.items():
            store.put(aid, params_from_numpy(tree, "cpu"), rank)
        store.publish()
        eng = ServingEngine(Model(tm_cfg, LoRAConfig(rank_levels=LEVELS),
                                  device="cpu", use_kernels=kern),
                            params_from_numpy(params, "cpu"), store,
                            max_len=max_len, slots=2)
        got = _drive(eng, calls, lambda t: t.numpy())
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"call {i}")
        engines.append(eng)
    return engines


# the families served at reduced size with GQA kept (2 KV heads of 4)
GQA_SERVED = ("granite-3-8b", "nemotron-4-340b")


@pytest.fixture(scope="module")
def serve_models():
    """Reduced gemma and hymba, qwen2 with a pure sliding window of 16
    (a ring cache of 16), and granite and nemotron at GQA 4/2, each from
    JAX weights with random tenants."""
    out = {}
    for name in ("gemma-2b", "hymba-1.5b", "qwen2-7b-swa") + GQA_SERVED:
        if name == "qwen2-7b-swa":
            jcfg, tcfg = (dataclasses.replace(
                g("qwen2-7b").reduced().with_sliding_window(16, 0),
                num_kv_heads=2) for g in (j_config, get_config))
        elif name in GQA_SERVED:
            jcfg, tcfg = (dataclasses.replace(g(name).reduced(),
                                              num_kv_heads=2)
                          for g in (j_config, get_config))
        else:
            jcfg, tcfg = j_config(name).reduced(), get_config(name).reduced()
        jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                         remat=False, block_q=16, block_kv=16)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
        out[name] = (jm, tcfg, params, _tenants(params, 5))
    return out


def _prompts(vocab, n, length, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(n, length)).astype(np.int32)


@pytest.mark.parametrize("name,prompt_len,steps", [
    ("gemma-2b", 8, 3), ("qwen2-7b-swa", 24, 4), ("granite-3-8b", 8, 3),
    ("nemotron-4-340b", 8, 3)])
def test_engine_matches_jax_engine(serve_models, monkeypatch, name,
                                   prompt_len, steps):
    """Two slots at ranks 16 and 4: equal greedy tokens. The sliding
    qwen2's 24-token prompt ring-scatters into a ring of 16, and decode
    wraps it further. Granite (tied head, SwiGLU) and Nemotron (untied
    head, squared-ReLU MLP, LoRA on q/k/v/o/up/down) run with the plain
    path and with ``use_kernels``: K4 (its plain version on the CPU) takes
    q/k/v/o, 4 calls a layer and engine call, and never the MLP's W,
    whose per-slot adapters take the plain path, as the reference's
    ``mlp_apply`` takes no ``use_kernel``."""
    jm, tcfg, params, tenants = serve_models[name]
    prompts = _prompts(tcfg.vocab_size, 2, prompt_len, 6)
    calls = [("admit", [0, 1], prompts, ["hi", "lo"])] + \
        [("decode", [True, True])] * steps
    k4_weights = []
    inner = la.batched_lora_apply_plain

    def counting(x, w, *rest):
        k4_weights.append(tuple(w.shape))
        return inner(x, w, *rest)
    monkeypatch.setattr(la, "batched_lora_apply_plain", counting)
    kernels = (False, True) if name in GQA_SERVED else (False,)
    eng = _engines_agree(jm, tcfg, params, tenants, calls,
                         prompt_len + steps + 1, use_kernels=kernels)[0]
    if name == "qwen2-7b-swa":
        assert eng.cache["layers"]["k"].shape[2] == 16
    if name in GQA_SERVED:
        d, hd = tcfg.d_model, tcfg.resolved_head_dim
        attn = {(d, tcfg.num_heads * hd), (d, tcfg.num_kv_heads * hd),
                (tcfg.num_heads * hd, d)}
        assert len(k4_weights) == len(calls) * 4 * tcfg.num_layers
        assert set(k4_weights) == attn
        assert not any(tcfg.d_ff in shape for shape in k4_weights)
    else:
        assert not k4_weights


def test_hymba_engine_matches_jax_engine(serve_models):
    """96-token prompts (the window of 64 bites in layer 1, the scan runs 3
    chunks) and 4 decode steps, with the plain path and with
    ``use_kernels`` (K4 and K6 fall back to their plain versions on the
    CPU); the cache entry holds k, v, conv and ssm."""
    jm, tcfg, params, tenants = serve_models["hymba-1.5b"]
    prompts = _prompts(tcfg.vocab_size, 2, HYMBA_LEN, 7)
    calls = [("admit", [0, 1], prompts, ["hi", "lo"])] + \
        [("decode", [True, True])] * 4
    for eng in _engines_agree(jm, tcfg, params, tenants, calls,
                              HYMBA_LEN + 5, use_kernels=(False, True)):
        assert set(eng.cache["layers"]) == {"k", "v", "conv", "ssm"}
        np.testing.assert_array_equal(eng.slot_len().numpy(),
                                      [HYMBA_LEN + 4] * 2)


def test_hymba_ragged_admission_matches_jax_engine(serve_models):
    """Slot 0 (64 tokens) decodes alone, slot 1 frozen at zeros; then slot
    1 is admitted with 32 tokens, so the per-slot lengths differ by 33 and
    the windowed decode's bounds are per slot (slot 0's past the window):
    every call's tokens equal the JAX engine's."""
    jm, tcfg, params, tenants = serve_models["hymba-1.5b"]
    p0 = _prompts(tcfg.vocab_size, 1, 64, 8)
    p1 = _prompts(tcfg.vocab_size, 1, 32, 9)
    calls = [("admit", [0], p0, ["hi"]), ("decode", [True, False]),
             ("admit", [1], p1, ["lo"]), ("decode", [True, True]),
             ("decode", [True, True])]
    (eng,) = _engines_agree(jm, tcfg, params, tenants, calls, 72)
    np.testing.assert_array_equal(eng.slot_len().numpy(), [67, 34])
