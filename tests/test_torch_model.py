"""The port's fedvit-tiny encoder and its masked multi-client training
step, held to the JAX package at JAX-initialised weights carried over by
``repro_torch.convert``. The forward uses tanh-GELU (``jax.nn.gelu``'s
default) and a full softmax where the reference streams an online one.

Tolerance: rtol 1e-4 on the loss and on every LoRA gradient / trained
factor, with an absolute floor of 1e-6 of the leaf's largest entry for
entries that cancel to ~0 (f32 sums taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LoRAConfig as JLoRA
from repro.core.lora import merge_lora as j_merge
from repro.core.lora import split_lora as j_split
from repro.federation.client import LocalTrainer as JTrainer
from repro.federation.experiment import fedvit_config as j_cfg
from repro.models.transformer import Model as JModel
from repro_torch.configs.base import LoRAConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.lora import flatten, split_lora, unflatten
from repro_torch.federation.client import LocalTrainer
from repro_torch.federation.experiment import fedvit_config
from repro_torch.models.transformer import Model
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

LEVELS = (4, 8, 16)
D, PATCHES, CLASSES = 32, 8, 6

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


def _close(got, want):
    want = np.asarray(want)
    floor = 1e-6 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=floor)


@pytest.fixture(scope="module")
def setup():
    lora_j = JLoRA(rank_levels=LEVELS, rank_probs=(0.34, 0.33, 0.33))
    jm = JModel(j_cfg(d_model=D, num_classes=CLASSES, patches=PATCHES),
                lora_j, dtype=jnp.float32, remat=False, block_q=64,
                block_kv=64)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    # nonzero lora_b so every LoRA gradient is nonzero
    rng = np.random.default_rng(0)

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "lora_b":
                tree[k] = (0.1 * rng.normal(size=v.shape)).astype(np.float32)
    fill(params)
    tm = Model(fedvit_config(d_model=D, num_classes=CLASSES, patches=PATCHES),
               LoRAConfig(rank_levels=LEVELS, rank_probs=(0.34, 0.33, 0.33)),
               device="cpu")
    return jm, tm, params


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    targets = np.zeros((b, PATCHES), np.int32)
    targets[:, 0] = rng.integers(0, CLASSES, size=b)
    mask = np.zeros((b, PATCHES), np.float32)
    mask[:, 0] = 1.0
    return {"embeds": rng.normal(size=(b, PATCHES, D)).astype(np.float32),
            "targets": targets, "loss_mask": mask}


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_train_loss_and_lora_grads_match_jax(setup, scale):
    jm, tm, params = setup
    batch = _batch(1)
    jbase, jlora = j_split(jax.tree.map(jnp.asarray, params))

    def jloss(lora):
        return jm.train_loss(j_merge(jbase, lora), batch, lora_rank=16,
                             lora_scale=scale)[0]
    j_val, j_grads = jax.value_and_grad(jloss)(jlora)

    base, lora = split_lora(params_from_numpy(params, "cpu"))
    leaves = {p: t.requires_grad_(True) for p, t in flatten(lora).items()}
    from repro_torch.core.lora import merge_lora
    t_val, metrics = tm.train_loss(merge_lora(base, unflatten(leaves)), batch,
                                   lora_rank=16, lora_scale=scale)
    grads = torch.autograd.grad(t_val, list(leaves.values()))
    _close(t_val.item(), j_val)
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    assert set(jflat) == set(leaves)
    for (path, _), g in zip(leaves.items(), grads):
        assert float(np.abs(np.asarray(jflat[path])).max()) > 0
        _close(g.numpy(), jflat[path])
    assert set(metrics) == {"loss", "aux_loss", "accuracy"}


def test_masked_group_step_matches_jax(setup):
    """One local step of three mixed-rank clients at once: trained factors
    match the reference's ``train_group_masked`` and every slice beyond a
    client's rank is exactly zero."""
    jm, tm, params = setup
    ranks = [4, 16, 8]
    batches = [_batch(10 + i) for i in range(3)]
    stack = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    jbase, jlora = j_split(jax.tree.map(jnp.asarray, params))
    j_lora, j_metrics = JTrainer(jm).train_group_masked(
        jbase, jlora, ranks, [stack], 1e-3)
    base, lora = split_lora(params_from_numpy(params, "cpu"))
    t_lora, t_metrics = LocalTrainer(tm).train_group_masked(
        base, lora, ranks, [{k: torch.from_numpy(v) for k, v in
                             stack.items()}], 1e-3)
    _close(t_metrics["loss"].numpy(), j_metrics["loss"])
    jflat = {tuple(str(getattr(k, "key", k)) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(j_lora)[0]
             if leaf is not None}
    for path, t in flatten(t_lora).items():
        _close(t.numpy(), jflat[path])
        for c, r in enumerate(ranks):
            tail = t[c, ..., r:, :] if path[-1] == "lora_a" else t[c, ..., r:]
            assert torch.count_nonzero(tail) == 0
