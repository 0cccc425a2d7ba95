"""The paper's own language models (``roberta-base``, ``llama3.2-3b``,
``llama3.1-8b``) and three more configs the port's model takes
(``granite-3-8b``, ``nemotron-4-340b``, ``hubert-xlarge``), held to the
JAX package on the CPU: the registered configs field for field, ``SequenceCopy`` bit for bit,
and each model's reduced forward and ``train_loss`` with the JAX weights
copied over (atol 1e-5, rtol 1e-4; the loss at rtol 1e-5). LLaMA-3.2-3B's
tied head and GQA decode (a prefill and a decode step equal the full
forward); RoBERTa-base, an encoder, refuses to decode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.data import SequenceCopy as JSequenceCopy
from repro.models import build_model
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import FrontendConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.data import SequenceCopy
from repro_torch.models.transformer import Model
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

MODELS = ["roberta-base", "llama3.2-3b", "llama3.1-8b", "granite-3-8b",
          "nemotron-4-340b", "hubert-xlarge"]
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_config_matches_reference(name):
    """Every field of the port's registered config equals the
    reference's."""
    jcfg = j_config(name)
    kw = {k: v for k, v in dataclasses.asdict(jcfg).items()
          if k in {f.name for f in dataclasses.fields(ModelConfig)}
          and k != "frontend"}
    want = ModelConfig(frontend=FrontendConfig(**dataclasses.asdict(
        jcfg.frontend)), **kw)
    assert get_config(name) == want
    assert get_config(name).supports_decode == jcfg.supports_decode


@pytest.mark.parametrize("kw", [{}, dict(vocab_size=128256, seq_len=64,
                                         num_families=5,
                                         samples_per_family=7, seed=3)],
                         ids=["default", "llama-vocab"])
def test_sequence_copy_bit_equal(kw):
    """The same seed gives the same tokens, targets and families."""
    got = SequenceCopy(**kw).generate()
    want = JSequenceCopy(**kw).generate()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _pair(name):
    """Reduced JAX and port models and the JAX weights carried over, with
    lora_b drawn away from 0 so the adapters act."""
    jcfg = j_config(name).reduced()
    lora = dict(rank_levels=(4, 8), rank_probs=(0.5, 0.5))
    jm = build_model(jcfg, JLoRA(**lora), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * jax.random.normal(jax.random.PRNGKey(3),
                                                   x.shape)
                      if str(getattr(p[-1], "key", "")) == "lora_b" else x),
        jm.init(jax.random.PRNGKey(0)))
    tm = Model(get_config(name).reduced(), LoRAConfig(**lora), device="cpu")
    return jm, tm, params, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _batch(cfg, b=2, t=16):
    rng = np.random.default_rng(1)
    batch = {"targets": rng.integers(0, cfg.vocab_size, (b, t)
                                     ).astype(np.int32)}
    if cfg.frontend.kind != "none":
        batch["embeds"] = rng.normal(size=(b, t, cfg.frontend.embed_dim)
                                     ).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, t)
                                       ).astype(np.int32)
    return batch


@pytest.mark.parametrize("name", MODELS)
def test_reduced_forward_and_loss_match_reference(name):
    """The reduced model's logits (full and truncated adapters) and
    ``train_loss`` equal the reference's from the same weights."""
    jm, tm, jp, tp = _pair(name)
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for rank in (-1, 4):
        want = np.asarray(jm.forward_seq(jp, jb, lora_rank=rank)[0])
        got = tm.forward_seq(tp, batch, lora_rank=rank)[0].numpy()
        np.testing.assert_allclose(got, want, **TOL)
    lj, mj = jm.train_loss(jp, jb, lora_rank=4)
    lt, mt = tm.train_loss(tp, batch, lora_rank=4)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt["accuracy"]), float(mj["accuracy"]))


def test_llama_tied_head_decode_matches_forward():
    """LLaMA-3.2-3B reduced (GQA 4/4 at reduced width, tied head: no
    ``lm_head`` leaf): a prefill of 12 tokens then 4 decode steps give the
    logits of the full 16-token forward."""
    _, tm, _, tp = _pair("llama3.2-3b")
    assert "lm_head" not in tp and tm.cfg.tie_embeddings
    tokens = _batch(tm.cfg)["tokens"]
    full = tm.forward_seq(tp, {"tokens": tokens})[0]
    logits, caches = tm.prefill(tp, {"tokens": tokens[:, :12]})
    torch.testing.assert_close(logits, full[:, :12], **TOL)
    cache = tm.init_cache(2, 16)
    for k in ("k", "v"):
        cache["layers"][k][:, :, :12] = caches[k]
    cache["len"] = torch.tensor(12, dtype=torch.int32)
    for t in range(12, 16):
        step, cache = tm.decode_step(tp, {"token": tokens[:, t:t + 1]}, cache)
        torch.testing.assert_close(step[:, 0], full[:, t], **TOL)


def test_roberta_decode_raises():
    """RoBERTa-base is an encoder: its decode raises, as vit-base's does."""
    tm = Model(get_config("roberta-base").reduced(), LoRAConfig(),
               device="cpu")
    assert not tm.cfg.supports_decode
    with pytest.raises(ValueError, match="encoder-only"):
        tm.decode_step({}, {"token": torch.zeros(1, 1, dtype=torch.int32)},
                       {"layers": {}, "len": 0})
