"""Two parts of the port's ``Model`` that need no reference run:

``remat`` (the reference's ``jax.checkpoint`` around each layer group of
its training forward): the LoRA gradients of ``train_loss`` with it are
bit for bit those without it, in f32, on reduced qwen2-7b (one layer a
group) and llama4-maverick (a dense and an MoE layer a group); it keeps
its hands off prefill and off a forward without a gradient.

``init`` writing each leaf straight into its slice of the stacked leaf
(``models/layers/draw.py``): in f32 its values are bit for bit those
of the draw it replaced (each layer group drawn whole, then copied into
the stacked leaves: ``_old_init`` below), on every registered family at
reduced size; in bf16 the draws round in bf16, so only their
distribution is held (each random leaf's std within 2% of the f32
draw's, its mean within 0.05 of that std). The init reads its shapes on
the meta device, where a random op or ``log`` would import
``torch._dynamo`` (seconds, once a process): it must not. In bf16 the
token table and an untied head are drawn in place as well: no f32 copy
of the table's size is made.

In f32 the full-sequence attention is the plain softmax(Q K^T * scale) V,
forward and gradients bit for bit: the bf16 rounding form (exp(s - max),
divided after p V) would keep the scores for the backward beside the
weights."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import _REGISTRY
from repro_torch.core.lora import flatten, merge_lora, split_lora, unflatten
from repro_torch.models import transformer
from repro_torch.models.layers import attention
from repro_torch.models.layers.dense import dense_init
from repro_torch.models.layers.norms import rms_norm_init
from repro_torch.models.transformer import Model

torch.set_num_threads(1)

LORA = LoRAConfig(rank_levels=(4, 8, 16), rank_probs=(1 / 3,) * 3)
get_config("qwen2-7b")                  # fills the registry
FAMILIES = sorted(_REGISTRY)


def _grads(name: str, remat: bool):
    cfg = get_config(name).reduced()
    model = Model(cfg, LORA, device="cpu", remat=remat)
    gen = torch.Generator().manual_seed(0)
    base, lora = split_lora(model.init(gen))
    leaves = {p: (t + 0.05 * torch.randn(t.shape, generator=gen)
                  if p[-1] == "lora_b" else t).requires_grad_()
              for p, t in flatten(lora).items()}
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    loss, _ = model.train_loss(merge_lora(base, unflatten(leaves)), batch,
                               lora_rank=8)
    return loss, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


@pytest.mark.parametrize("name", ["qwen2-7b", "llama4-maverick-400b-a17b"])
def test_remat_gradients_equal_no_remat_bit_for_bit(name, monkeypatch):
    """The same loss and LoRA gradients with and without ``remat``, bit
    for bit in f32; with it each layer group runs in a checkpoint, its
    forward again in the backward."""
    calls = []
    inner = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    loss_r, with_remat = _grads(name, True)
    groups = Model(get_config(name).reduced(), LORA, device="cpu").num_groups
    assert len(calls) == groups
    loss_n, without = _grads(name, False)
    assert len(calls) == groups
    assert torch.equal(loss_r, loss_n)
    assert set(with_remat) == set(without) and len(without) > 0
    for path, g in without.items():
        assert torch.equal(with_remat[path], g), path


def test_remat_skips_prefill_and_forwards_without_a_gradient(monkeypatch):
    """``remat`` is a training matter: a prefill, and a training forward
    under ``no_grad``, run no checkpoint."""
    monkeypatch.setattr(transformer, "checkpoint", None)
    cfg = get_config("qwen2-7b").reduced()
    model = Model(cfg, LORA, device="cpu", remat=True)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": np.zeros((1, 8), np.int32)}
    model.prefill(params, batch)
    with torch.no_grad():
        model.forward_seq(params, batch)


def _copy_into(stacked: dict, group: dict, g: int) -> None:
    for k, v in group.items():
        if isinstance(v, dict):
            _copy_into(stacked[k], v, g)
        else:
            stacked[k][g].copy_(v)


def _old_init(model: Model, gen: torch.Generator) -> dict:
    """``Model.init`` as it drew before the in-place fill: each layer
    group drawn whole, then copied into the stacked leaves."""
    cfg, kw = model.cfg, dict(dtype=model.dtype, device=model.device)
    params = {"embed": (torch.randn(cfg.vocab_size, cfg.d_model,
                                    generator=gen)
                        * cfg.d_model ** -0.5).to(model.dtype),
              "final_norm": rms_norm_init(cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       **kw)
    layers = None
    for g in range(model.num_groups):
        group = model._group_init(gen, g)
        if layers is None:
            layers = transformer._index(group, lambda t: t.new_empty(
                (model.num_groups,) + tuple(t.shape)))
        _copy_into(layers, group, g)
    params["layers"] = layers
    if cfg.frontend.kind != "none":
        params["frontend_proj"] = dense_init(
            gen, cfg.frontend.embed_dim, cfg.d_model, **kw)
    return params


@pytest.mark.parametrize("name", FAMILIES)
def test_init_in_place_equals_the_old_draw_in_f32(name):
    """Every leaf bit for bit the old draw's from the same generator."""
    model = Model(get_config(name).reduced(), LORA, device="cpu")
    got = flatten(model.init(torch.Generator().manual_seed(5)))
    want = flatten(_old_init(model, torch.Generator().manual_seed(5)))
    assert set(got) == set(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype
        assert torch.equal(got[path], t), path


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b", "qwen2-7b"])
def test_init_in_place_in_bf16_keeps_the_distributions(name):
    """In bf16 every leaf has its f32 draw's dtype rule (bf16, the router
    and the SSD constants f32) and each random leaf of more than 1000
    values its f32 draw's std within 2% and mean within 0.05 std."""
    cfg = get_config(name).reduced()
    f32 = flatten(Model(cfg, LORA, device="cpu").init(
        torch.Generator().manual_seed(5)))
    bf16 = flatten(Model(cfg, LORA, device="cpu", dtype=torch.bfloat16)
                   .init(torch.Generator().manual_seed(5)))
    assert set(f32) == set(bf16)
    checked = 0
    for path, t in f32.items():
        b = bf16[path]
        assert b.dtype == (torch.float32 if path[-2:] == ("router", "w")
                           else torch.bfloat16), path
        std = float(t.std()) if t.numel() > 1000 else 0.0
        if std > 0 and float(t.mean()).__abs__() < 0.05 * std:
            assert abs(float(b.float().std()) / std - 1) < 0.02, path
            assert abs(float(b.float().mean())) < 0.05 * std, path
            checked += 1
    assert checked > 5


@pytest.mark.parametrize("name", ["nemotron-4-340b", "qwen2-7b"])
def test_bf16_init_draws_the_embedding_and_head_in_place(name):
    """A bf16 ``init`` makes no f32 tensor, and no second tensor, of the
    token table's size: the embedding and an untied head are drawn into
    their bf16 leaves (each op's outputs recorded under a dispatch mode).
    Drawn in f32, then scaled, then cast, the table stood at 2.5 times
    its bf16 bytes beside the model: Nemotron-4-340B's init peaked 13.59
    GiB over its 30.46 GiB on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode
    cfg = get_config(name).reduced()
    table = cfg.vocab_size * cfg.d_model
    made = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and not t.is_meta and \
                        t.numel() >= table:
                    made.append((str(func), t.dtype, t.untyped_storage()
                                 .data_ptr()))
            return out
    model = Model(cfg, LORA, device="cpu", dtype=torch.bfloat16)
    with Record():
        params = model.init(torch.Generator().manual_seed(5))
    assert not [m for m in made if m[1] != torch.bfloat16], made
    leaves = {t.untyped_storage().data_ptr() for t in flatten(params)
              .values()}
    assert {m[2] for m in made} <= leaves
    heads = [params["embed"]] + ([params["lm_head"]["w"]]
                                 if "lm_head" in params else [])
    for t in heads:
        assert t.dtype == torch.bfloat16 and t.numel() == table


def test_init_does_not_import_dynamo():
    """A fresh process inits every registered family at reduced size and
    reads the full configs' shapes without importing ``torch._dynamo``."""
    code = ("import sys, torch\n"
            "from repro_torch.configs import LoRAConfig, get_config\n"
            "from repro_torch.configs.base import _REGISTRY\n"
            "from repro_torch.models.transformer import Model\n"
            "get_config('qwen2-7b')\n"
            "for n in sorted(_REGISTRY):\n"
            "    Model(get_config(n).reduced(), LoRAConfig(), device='cpu')"
            ".init(torch.Generator().manual_seed(0))\n"
            "    Model(get_config(n), LoRAConfig(), device='cpu')"
            ".param_shapes()\n"
            "assert 'torch._dynamo' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("window", [0, 5])
def test_f32_attention_is_the_plain_softmax(window):
    """f32 causal attention (GQA, softcap, and a window) equals
    softmax(Q K^T * scale) V written out, forward and gradients bit for
    bit."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 8, 32, generator=gen, requires_grad=True)
    k = torch.randn(2, 16, 2, 32, generator=gen, requires_grad=True)
    v = torch.randn(2, 16, 2, 32, generator=gen, requires_grad=True)
    got = attention.causal_attention(q, k, v, sliding_window=window,
                                     softcap=30.0)
    kh, vh = (t.repeat_interleave(4, dim=-2).transpose(-3, -2)
              for t in (k, v))
    s = (q.transpose(-3, -2) @ kh.mT) * 32 ** -0.5
    s = 30.0 * torch.tanh(s / 30.0)
    pos = torch.arange(16)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, attention.NEG_INF)
    want = (torch.softmax(s, dim=-1) @ vh).transpose(-3, -2)
    assert torch.equal(got, want)
    for a, b in zip(torch.autograd.grad(got.sum(), (q, k, v)),
                    torch.autograd.grad(want.sum(), (q, k, v))):
        assert torch.equal(a, b)
