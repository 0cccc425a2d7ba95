"""The port's bf16 model held to the JAX package's bf16 model on the CPU:
reduced qwen2-7b, gemma-2b, deepseek-v2-236b, llama4-maverick and
nemotron-4-340b (its squared-ReLU MLP: ``relu`` then ``r * r``, one
rounding each, as the reference; and hymba-1.5b on the kernel path), the
reference's weights carried over
(bf16 leaves as bf16, its f32 leaves as f32; lora_b drawn away from 0).

Both packages round at the same points: the port writes out, below f32,
the elementwise ops the reference's XLA program rounds one at a time
(``mlp.silu`` and ``mlp.gelu_tanh``, also in the SSD gate) and the
reference's attention weights (exp(s - max) rounded to the value dtype
before p V, divided by their f32 sum after it, as one block of its online
softmax; its blocks are set to the sequence here, so one block it is).
What remains between them is the order of f32 sums inside each product,
which moves a result by at most one bf16 rounding step and does not grow
from one layer to the next.

The rule, one for every family: the port's tensor within N bf16 ulps of
the reference's largest |value| of that tensor, an ulp being the bf16
spacing at that value, 2^(floor(log2 |v|) - 7); N = ``ULPS`` (4) for the
logits and the loss, ``GRAD_ULPS`` (8) for each LoRA gradient leaf. The
backward rounds at more points than the forward, and not all of them are
the reference's: its autodiff differentiates ``jax.nn.sigmoid`` as one
primitive (g s (1 - s)) where the port differentiates the written-out
ops. Measured when the rule was set: logits within 1.25 ulps (2.75 for the
per-slot kernel path), the loss within 0.05, gradients within 4.5.

``Model(dtype=torch.bfloat16, use_kernels=True)`` raised before this port
could read bf16 in K4 (``batched_lora_apply x: expected torch.float32,
got torch.bfloat16``); it runs and is held to the reference's
``use_kernels=True`` model here, on the single-model forward (where the
reference takes its plain LoRA path and the port K4) and with per-slot
adapters (both packages' K4: the reference's Pallas kernel in interpret
mode). The MoE models assert the reference router's smallest top-k
margin above ``MARGIN`` first: a bf16 rounding step in a router input
moves its probabilities by about 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.core.lora import split_lora as j_split
from repro.models import build_model
from repro.models.layers import moe as jmoe
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, merge_lora, split_lora, unflatten
from repro_torch.models.transformer import Model

torch.set_num_threads(1)

QWEN, GEMMA, HYMBA = "qwen2-7b", "gemma-2b", "hymba-1.5b"
DS, L4 = "deepseek-v2-236b", "llama4-maverick-400b-a17b"
NEMO = "nemotron-4-340b"
LORA = dict(rank_levels=(4, 8, 16), rank_probs=(1 / 3,) * 3)
B, T = 2, 16
ULPS = 4            # logits and the loss
GRAD_ULPS = 8       # each LoRA gradient leaf
MARGIN = 1e-2


def ulp(v: float) -> float:
    """The bf16 spacing at |v|."""
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0 ** -126))) - 7)


def assert_ulps(got, want, what: str, ulps: int = ULPS) -> float:
    """``got`` within ``ulps`` bf16 ulps of ``want``'s largest |value|;
    returns the distance in those ulps."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    unit = ulp(float(np.abs(want).max()))
    dist = float(np.abs(got - want).max()) / unit
    print(f"{what}: {dist:.3f} bf16 ulps of {float(np.abs(want).max()):.4g}")
    assert dist <= ulps, f"{what}: {dist} bf16 ulps > {ulps}"
    return dist


def _margins():
    """The reference router's top-k margins, recorded as it runs."""
    margins = []
    inner = jmoe.router_topk

    def recording(logits, top_k):
        probs = jnp.sort(jax.nn.softmax(logits.astype(jnp.float32), -1),
                         axis=-1)[..., ::-1]
        if top_k < probs.shape[-1]:
            gap = jnp.min(probs[..., top_k - 1] - probs[..., top_k])
            jax.debug.callback(lambda g: margins.append(float(g)), gap)
        return inner(logits, top_k)
    return margins, inner, recording


class _Routed:
    def __enter__(self):
        self.margins, self.inner, jmoe.router_topk = _margins()
        return self.margins

    def __exit__(self, *exc):
        jmoe.router_topk = self.inner


def _to_port(tree) -> dict:
    """The reference's tree in the port: its bf16 leaves as bf16."""
    flat = jax.tree_util.tree_leaves_with_path(tree)
    out = flatten(params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x.astype(jnp.float32)), tree), "cpu"))
    for path, x in flat:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        if x.dtype == jnp.bfloat16:
            out[key] = out[key].to(torch.bfloat16)
    return unflatten(out)


_CACHE = {}


def _pair(name: str, **opts):
    """(reference model, port model, reference params, port params) at
    ``opts`` (remat, use_kernels; each default off): one set of weights
    a family, cached."""
    jcfg, tcfg = j_config(name).reduced(), get_config(name).reduced()
    if name not in _CACHE:
        jm = build_model(jcfg, JLoRA(**LORA), dtype=jnp.bfloat16,
                         remat=False)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: (x + (0.05 * jax.random.normal(
                jax.random.PRNGKey(3), x.shape)).astype(x.dtype)
                          if str(getattr(p[-1], "key", "")) == "lora_b"
                          else x), params)
        _CACHE[name] = (params, _to_port(params))
    params, tparams = _CACHE[name]
    opts = dict(dict(remat=False, use_kernels=False), **opts)
    jm = build_model(jcfg, JLoRA(**LORA), dtype=jnp.bfloat16, block_q=T,
                     block_kv=T, **opts)
    tm = Model(tcfg, LoRAConfig(**LORA), device="cpu", dtype=torch.bfloat16,
               **opts)
    return jm, tm, params, tparams


def _batch(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
            for k in ("tokens", "targets")}


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check_model(name: str, grads: bool = True, **opts) -> None:
    """Logits, ``train_loss`` and (``grads``) the LoRA gradients of the
    port against the reference at ``opts``."""
    jm, tm, jp, tp = _pair(name, **opts)
    batch = _batch(jm.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jbase, jlora = j_split(jp)

    def jloss(lora):
        merged = jax.tree.map(lambda b, l: b if l is None else l, jbase,
                              lora, is_leaf=lambda x: x is None)
        return jm.train_loss(merged, jb, lora_rank=8)[0]

    with _Routed() as margins:
        want = _f32(jm.forward_seq(jp, jb)[0])
        if grads:
            lj, jgrad = jax.value_and_grad(jloss)(jlora)
        else:
            lj = jloss(jlora)
        lj = float(lj)
    if margins:
        assert min(margins) > MARGIN, min(margins)
    with torch.no_grad():
        got = tm.forward_seq(tp, batch)[0].float().numpy()
    assert_ulps(got, want, f"{name} {opts} logits")
    base, lora = split_lora(tp)
    leaves = {p: t.clone().requires_grad_(grads) for p, t in
              flatten(lora).items()}
    with torch.set_grad_enabled(grads):
        loss, _ = tm.train_loss(merge_lora(base, unflatten(leaves)), batch,
                                lora_rank=8)
    assert_ulps(float(loss.detach()), lj, f"{name} {opts} loss")
    if not grads:
        return
    want_g = flatten(params_from_numpy(jax.tree.map(
        lambda x: None if x is None else np.asarray(x.astype(jnp.float32)),
        jgrad, is_leaf=lambda x: x is None), "cpu"))
    got_g = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    assert set(want_g) == set(got_g)
    for path, g in got_g.items():
        assert g.dtype == torch.bfloat16
        assert_ulps(g.float().numpy(), want_g[path].numpy(),
                    f"{name} grad {'/'.join(path)}", GRAD_ULPS)


@pytest.mark.parametrize("name", [QWEN, GEMMA, DS, L4, NEMO])
def test_bf16_model_matches_reference(name):
    """Logits, loss and every LoRA gradient, remat off on both sides."""
    _check_model(name)


@pytest.mark.parametrize("name", [QWEN, L4])
@pytest.mark.parametrize("option", ["remat"])
def test_bf16_model_options_match_reference(name, option):
    """``remat`` on both sides (the layer groups run again in the
    backward): logits, loss and every LoRA gradient. (The reference's
    ``bf16_scores`` serves only its TPU dry run; the port has none.)"""
    _check_model(name, **{option: True})


def _per_slot(tree, n: int):
    """A tree whose adapter leaves carry ``n`` distinct adapters on a new
    slot axis after the layer axis (the reference's per-request layout)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (jnp.stack([x * (1.0 + 0.5 * i) for i in range(n)],
                                axis=1).astype(x.dtype)
                      if str(getattr(p[-1], "key", "")).startswith("lora_")
                      else x), tree)


@pytest.mark.parametrize("name", [QWEN, GEMMA, L4])
def test_bf16_kernel_model_single_forward_matches_reference(name):
    """The single-model forward of ``Model(dtype=torch.bfloat16,
    use_kernels=True)``, the call that raised, K4 reading the bf16
    operands (the CPU takes K4's plain version), against the reference's
    ``use_kernels=True`` model's single-model forward (its plain LoRA
    path) under the same rule. Hymba is left out: the port's own K4 and
    plain routes sit 4.125 ulps apart on it, so it is held on the
    per-slot layout below, both packages' K4."""
    jm, tm, jp, tp = _pair(name, use_kernels=True)
    batch = _batch(jm.cfg)
    with _Routed() as margins:
        want = _f32(jm.forward_seq(jp, {"tokens": jnp.asarray(
            batch["tokens"])})[0])
    if margins:
        assert min(margins) > MARGIN, min(margins)
    with torch.no_grad():
        got = tm.forward_seq(tp, batch)[0]
    assert got.dtype == torch.bfloat16
    assert_ulps(got.float().numpy(), want, f"{name} single-model K4 logits")


@pytest.mark.parametrize("name", [QWEN, GEMMA, HYMBA, L4, NEMO])
def test_bf16_kernel_model_matches_reference_kernel(name):
    """The fault: ``Model(dtype=torch.bfloat16, use_kernels=True)`` raised
    on its first forward (K4 took f32 only); its single-model forward now
    runs, K4 reading the bf16 operands (the CPU takes K4's plain
    version), and returns finite bf16 logits. Then per-slot adapters (the
    serving layout, slot c's sequence through its own factors), where
    both packages' kernel paths take K4: the reference's ``forward_seq``
    of its ``use_kernels=True`` model with (B, ...) adapter leaves, its
    Pallas kernel in interpret mode (and hymba's Pallas scan), against
    the port's ``forward_clients`` over B clients of one sequence each."""
    jm, tm, jp, tp = _pair(name, use_kernels=True)
    batch = _batch(jm.cfg)
    with torch.no_grad():
        single = tm.forward_seq(tp, batch)[0]
    assert single.dtype == torch.bfloat16
    assert bool(torch.isfinite(single).all())
    jps = _per_slot(jp, B)
    with _Routed() as margins:
        want = _f32(jm.forward_seq(jps, {"tokens": jnp.asarray(
            batch["tokens"])})[0])
    if margins:
        assert min(margins) > MARGIN, min(margins)
    base, lora = split_lora(_to_port(jps))
    lora_c = unflatten({p: t.movedim(1, 0) for p, t in
                        flatten(lora).items()})
    tokens = torch.from_numpy(batch["tokens"])[:, None]
    with torch.no_grad():
        got = tm.forward_clients(base, lora_c, {"tokens": tokens},
                                 torch.ones(B))[:, 0].float().numpy()
    assert_ulps(got, want, f"{name} per-slot K4 logits")
