"""The port's expert-parallel MoE dispatch (``moe_apply_ep`` and the
capacity dispatch ``_expert_ffn_capacity``) held to the JAX package's on
the CPU, over a one-rank gloo group (``launch.mesh.make_host_mesh``, a
module fixture destroyed at teardown) against the reference's
``shard_map`` on its one-device ``make_host_mesh()``.

The layer at ``tests/test_models.py::test_moe_ep_matches_tp_on_host_mesh``'s
shape (4 experts, top-2, d 16, ff 32; x (2, 8, 16)): dropless within atol
1e-5 of the reference's EP path and of the port's ``moe_apply``; the
capacity path at factors 0.5 and 1.0 (assignments dropped at both) within
atol 1e-5 of the reference's capacity path, with no host sync. The
reduced DeepSeek-V2 ``Model(moe_impl="ep")`` forward against the
reference's, dropless and at capacity 1.25, with the reference router's
smallest top-k margin above 1e-4 (``test_torch_moe_mla.py``); its LoRA
gradients at one rank equal the ``"tp"`` model's. The two-rank case (the
experts split 2 + 2) is in ``test_torch_sharded.py``'s gloo spawn."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import LoRAConfig as JLoRA
from repro.configs import get_config as j_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import build_model
from repro.models.layers import moe as jmoe
from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import collective
from repro_torch.core.lora import flatten, merge_lora, split_lora, unflatten
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.transformer import Model
from test_torch_moe_mla import (LORA, REDUCED, TOL, _assert_margin, _batch,
                                _pair, _router_margins)
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

DS = "deepseek-v2-236b"


# before any test that takes ``mesh``: the module fixture holds its group
# until the module ends

def test_model_builds_its_host_mesh_lazily():
    """Without a mesh, ``Model(moe_impl="ep")`` makes
    ``make_host_mesh()`` (a one-rank group here) at its first MoE layer;
    the caller destroys the group."""
    assert not dist.is_initialized()
    cfg = get_config(DS).reduced(**REDUCED)
    model = Model(cfg, LoRAConfig(**LORA), device="cpu", moe_impl="ep",
                  moe_capacity_factor=1.25)
    assert model.mesh is None
    params = model.init(torch.Generator().manual_seed(0))
    try:
        logits = model.forward_seq(params, {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)})[0]
        assert model.mesh.mesh_dim_names == ("data", "model")
        assert torch.isfinite(logits).all()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh():
    """The port's ("data", "model") mesh over a one-rank gloo group made
    here, and the reference's one-device host mesh."""
    assert not dist.is_initialized()
    m = make_host_mesh(device="cpu")
    assert m.shape == (1, 1) and m.mesh_dim_names == ("data", "model")
    yield m, j_host_mesh()
    dist.destroy_process_group()


def _layer():
    """The reference test's layer (4 experts, top-2, ff 32, d 16,
    swiglu) in both packages, and x (2, 8, 16)."""
    key = jax.random.PRNGKey(0)
    jcfg = JMoEConfig(num_experts=4, top_k=2, expert_d_ff=32)
    jp = jmoe.moe_init(key, 16, jcfg, "swiglu", lora_ranks={})
    x = np.array(jax.random.normal(jax.random.fold_in(key, 1), (2, 8, 16)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, MoEConfig(num_experts=4, top_k=2, expert_d_ff=32), jp, tp, x


def _drops(x, params, cfg, factor):
    """Assignments past their expert's capacity at ``factor`` (the
    reference's rule, all experts local)."""
    _, _, experts, _ = tmoe._route(params, torch.from_numpy(x)[None], cfg)
    sizes = torch.bincount(experts.reshape(-1), minlength=cfg.num_experts)
    cap = int(factor * experts.numel() / cfg.num_experts) + 1
    return int((sizes - cap).clamp(min=0).sum())


def test_dropless_ep_matches_reference_and_tp(mesh):
    """World 1: the port's EP dropless output within atol 1e-5 of the
    reference's ``moe_apply_ep`` and of the port's ``moe_apply``; the aux
    equal; one all-reduce and one host sync a call."""
    tmesh, jmesh = mesh
    jcfg, cfg, jp, tp, x = _layer()
    with _router_margins() as margins:     # the router outside shard_map
        jmoe.router_topk(jnp.asarray(x).reshape(-1, 16)
                         @ jp["router"]["w"], jcfg.top_k)
    _assert_margin(margins)
    want, jaux = jax.jit(lambda p, v: jmoe.moe_apply_ep(
        p, v, jcfg, "swiglu", jmesh, batch_axes=("data",)))(
            jp, jnp.asarray(x))
    calls, syncs = collective.all_reduce.calls, tmoe.moe_apply.host_syncs
    got, aux = tmoe.moe_apply_ep(tp, torch.from_numpy(x)[None], cfg,
                                 "swiglu", tmesh, batch_axes=("data",))
    assert collective.all_reduce.calls == calls + 1
    assert tmoe.moe_apply.host_syncs == syncs + 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=1e-6)
    tp_out, tp_aux = tmoe.moe_apply(tp, torch.from_numpy(x)[None], cfg,
                                    "swiglu")
    torch.testing.assert_close(got, tp_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux, tp_aux, atol=0, rtol=0)


@pytest.mark.parametrize("factor", [0.5, 1.0])
def test_capacity_ep_matches_reference_with_drops(mesh, factor):
    """The capacity dispatch at ``factor``: assignments are dropped
    (counted by the reference's rule), the output is within atol 1e-5 of
    the reference's capacity path and differs from the dropless one, and
    no host sync is made (one all-reduce)."""
    tmesh, jmesh = mesh
    jcfg, cfg, jp, tp, x = _layer()
    assert _drops(x, tp, cfg, factor) > 0
    want, _ = jax.jit(lambda p, v: jmoe.moe_apply_ep(
        p, v, jcfg, "swiglu", jmesh, capacity_factor=factor))(
            jp, jnp.asarray(x))
    calls, syncs = collective.all_reduce.calls, tmoe.moe_apply.host_syncs
    got, _ = tmoe.moe_apply_ep(tp, torch.from_numpy(x)[None], cfg, "swiglu",
                               tmesh, capacity_factor=factor)
    assert tmoe.moe_apply.host_syncs == syncs
    assert collective.all_reduce.calls == calls + 1
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5)
    dropless, _ = tmoe.moe_apply_ep(tp, torch.from_numpy(x)[None], cfg,
                                    "swiglu", tmesh)
    assert (got - dropless).abs().max() > 1e-3


@pytest.fixture(scope="module")
def deepseek(mesh):
    """The reduced DeepSeek-V2 pair of ``test_torch_moe_mla.py`` (8
    experts top-6, lora_b away from 0)."""
    return _pair(j_config(DS).reduced(**REDUCED), get_config(DS).reduced(
        **REDUCED))


@pytest.mark.parametrize("factor", [0.0, 1.25], ids=["dropless", "cap1.25"])
def test_deepseek_ep_model_matches_reference(mesh, deepseek, factor):
    """``Model(moe_impl="ep")`` of both packages on the same weights, at
    full and truncated adapters: logits at atol 1e-5, rtol 1e-4 and the
    aux at rtol 1e-5; dropless, also equal to the ``"tp"`` model's."""
    tmesh, jmesh = mesh
    jm_tp, tm_tp, jp, tp = deepseek
    jcfg, tcfg = jm_tp.cfg, tm_tp.cfg
    jm = build_model(jcfg, JLoRA(**LORA), dtype=jnp.float32, remat=False,
                     block_q=16, block_kv=16, moe_impl="ep", mesh=jmesh,
                     moe_capacity_factor=factor)
    tm = Model(tcfg, LoRAConfig(**LORA), device="cpu", moe_impl="ep",
               mesh=tmesh, moe_capacity_factor=factor)
    batch = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with _router_margins() as margins:
        for rank in (-1, 4):
            want, jaux, _ = jm.forward_seq(jp, jb, lora_rank=rank)
            got, aux, _ = tm.forward_seq(tp, batch, lora_rank=rank)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _assert_margin(margins)
    if not factor:
        tp_logits = tm_tp.forward_seq(tp, batch)[0]
        torch.testing.assert_close(tm.forward_seq(tp, batch)[0], tp_logits,
                                   **TOL)


def test_ep_lora_gradients_equal_tp_at_one_rank(mesh, deepseek):
    """At one rank the expert sum's gradient is the identity: the LoRA
    gradients of ``train_loss`` through the EP model equal the ``"tp"``
    model's (atol 1e-5, rtol 1e-4)."""
    tmesh, _ = mesh
    _, tm_tp, _, tp = deepseek
    tm = Model(tm_tp.cfg, LoRAConfig(**LORA), device="cpu", moe_impl="ep",
               mesh=tmesh)
    batch = _batch(tm_tp.cfg)
    grads = []
    for model in (tm, tm_tp):
        base, lora = split_lora(tp)
        lora = {p: t.clone().requires_grad_()
                for p, t in flatten(lora).items()}
        loss, _ = model.train_loss(merge_lora(base, unflatten(lora)), batch,
                                   lora_rank=8)
        grads.append(torch.autograd.grad(loss, list(lora.values())))
    assert len(grads[0]) > 0
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **TOL)
