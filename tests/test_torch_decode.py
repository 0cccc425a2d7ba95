"""The port's decoder path (Qwen2-family: token embedding, RoPE, causal
GQA attention, KV cache, SwiGLU, untied head) held to the JAX package at
JAX-initialised weights carried over by ``repro_torch.convert``.

Reduced qwen2-7b keeps 4 heads and 4 KV heads, which never exercises GQA
grouping, so both sides run it with ``num_kv_heads=2``. Both use
``use_kernels=False``. Tolerance: rtol 1e-4, atol 1e-5 on logits and on
every cache leaf (f32 sums in another order; the reference streams an
online softmax where the port takes a full one)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_get_config
from repro.models import build_model
from repro.models.layers import attention as jattn
from repro.models.layers import rope as jrope
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import FrontendConfig, ModelConfig, SSMConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import rope as trope
from repro_torch.models.transformer import Model
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

LEVELS = (4, 8, 16)
TOL = dict(rtol=1e-4, atol=1e-5)


def _port_config(jcfg) -> ModelConfig:
    """The port's ModelConfig with a JAX config's field values (the
    sub-configs the port keeps opaque, MoE and MLA, are dropped)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items()
          if k in fields and k not in ("moe", "mla", "ssm", "frontend")}
    ssm = (None if jcfg.ssm is None
           else SSMConfig(**dataclasses.asdict(jcfg.ssm)))
    return ModelConfig(frontend=FrontendConfig(**dataclasses.asdict(
        jcfg.frontend)), ssm=ssm, **kw)


@pytest.mark.parametrize("name", ["qwen2-7b", "gemma-2b", "qwen2-vl-7b",
                                  "hubert-xlarge", "granite-3-8b",
                                  "mamba2-1.3b", "hymba-1.5b"])
def test_reduced_config_matches_reference(name):
    """``reduced()`` gives the reference's numbers for every field the port
    knows, including sliding windows, M-RoPE sections, frontends and the
    SSM sub-config (state 16, head 32, chunk 32)."""
    jcfg = j_get_config(name)
    port = _port_config(jcfg).reduced()
    want = _port_config(jcfg.reduced())
    assert port == want
    assert (port.ssm is None) == (jcfg.ssm is None)
    assert port.supports_decode == jcfg.supports_decode
    assert port.is_encoder_only == jcfg.is_encoder_only
    if name in ("qwen2-7b", "mamba2-1.3b"):
        assert get_config(name) == _port_config(jcfg)


def test_rope_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mpos = np.stack([pos, pos // 3, pos % 7])
    want = jrope.apply_mrope(jnp.asarray(x), jnp.asarray(mpos), 1e6,
                             (2, 3, 3))
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(mpos),
                            1e6, (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("q_offset", [0, 3])
def test_causal_attention_matches_reference(q_offset):
    """GQA 4 query heads over 2 KV heads, Lq < Lkv with a q offset."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 8, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=q_offset, block_q=4, block_kv=4)
    got = tattn.causal_attention(*map(torch.from_numpy, (q, k, v)),
                                 q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cache_len", [5, np.array([2, 7], np.int32)],
                         ids=["scalar", "vector"])
def test_decode_attention_matches_reference(cache_len):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cache_len))
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                 torch.as_tensor(cache_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def qwen_pair():
    """Reduced qwen2-7b (GQA 4/2) on both sides from one set of JAX
    weights; nonzero LoRA B and biases so every term is exercised."""
    jcfg = dataclasses.replace(j_get_config("qwen2-7b").reduced(),
                               num_kv_heads=2)
    tcfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                               num_kv_heads=2)
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False, block_q=16, block_kv=16)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        if path[-1].key in ("lora_b", "b"):
            return (0.05 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(perturb, params)
    tm = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu")
    return jcfg, jm, tm, params, params_from_numpy(params, "cpu")


def test_prefill_and_ragged_decode_match_reference(qwen_pair):
    """prefill logits and every cache leaf, then three decode steps from a
    ragged cache (row lengths 8 and 6, a (B,) ``len`` vector): logits,
    every cache leaf and ``len`` at each step."""
    cfg, jm, tm, params, tparams = qwen_pair
    rng = np.random.default_rng(1)
    b, lp, max_len = 2, 8, 12
    toks = rng.integers(0, cfg.vocab_size, size=(b, lp)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)

    shapes = jax.tree.map(lambda s: s.shape, jm.cache_shapes(b, max_len))
    tshapes = tm.cache_shapes(b, max_len)
    assert tshapes["layers"]["k"].shape == shapes["layers"]["k"]
    assert tm.cache_seq_len(max_len) == jm.cache_seq_len(max_len)
    # one shared ragged cache: row 1 keeps only its first 6 positions
    full = {}
    for key in ("k", "v"):
        leaf = np.zeros(shapes["layers"][key], np.float32)
        leaf[:, :, :lp] = np.asarray(jc[key])
        leaf[:, 1, 6:] = 0.0
        full[key] = leaf
    lens = np.array([lp, 6], np.int32)
    jcache = {"layers": {k: jnp.asarray(v) for k, v in full.items()},
              "len": jnp.asarray(lens)}
    tcache = {"layers": {k: torch.from_numpy(v.copy())
                         for k, v in full.items()},
              "len": torch.from_numpy(lens.copy())}
    tok = rng.integers(0, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(params, {"token": jnp.asarray(tok)},
                                    jcache)
        with torch.no_grad():
            tl, tcache = tm.decode_step(
                tparams, {"token": torch.from_numpy(tok)}, tcache)
        assert tl.shape == (b, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                       np.asarray(jcache["layers"][key]),
                                       **TOL)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)


def test_scalar_len_decode_matches_reference(qwen_pair):
    """Lock-step decode (scalar ``len``) from a zero cache."""
    cfg, jm, tm, params, tparams = qwen_pair
    tok = np.array([[3], [7]], np.int32)
    jl, jcache = jm.decode_step(params, {"token": jnp.asarray(tok)},
                                jm.init_cache(2, 6))
    with torch.no_grad():
        tl, tcache = tm.decode_step(
            tparams, {"token": torch.from_numpy(tok)}, tm.init_cache(2, 6))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["layers"]["k"].numpy(),
                               np.asarray(jcache["layers"]["k"]), **TOL)
    assert tcache["len"].ndim == 0 and int(tcache["len"]) == 1


def test_init_keeps_the_stacked_layout(qwen_pair):
    """``Model.init`` fills each stacked leaf layer by layer: the reference's
    tree and shapes, and no frontend projection for a token model."""
    cfg, jm, tm, params, _ = qwen_pair
    got = tm.init(torch.Generator().manual_seed(0))
    want = params_from_numpy(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), jm.param_shapes()), "cpu")
    from repro_torch.core.lora import flatten
    assert {p: tuple(t.shape) for p, t in flatten(got).items()} == \
        {p: tuple(t.shape) for p, t in flatten(want).items()}
    layer_w = got["layers"]["attn"]["q"]["w"]
    assert not torch.equal(layer_w[0], layer_w[1])
