"""The port's adapter-tree utilities (``repro_torch.core.lora``) held to
``repro.core.lora`` (tests/test_federation.py::TestLoRATreeUtils) on one
numpy tree: scan-stacked attention and MLP adapters next to base leaves."""
import jax
import numpy as np
import pytest
import torch

from repro.core import lora as jlora
from repro_torch.core import lora as tlora
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

R_MAX = 16

# one thread keeps parallel test workers from oversubscribing cores
torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"embed": f(10, 8), "final_norm": {"scale": f(8)},
            "layers": {"attn": {"q_proj": {"w": f(2, 8, 8), "b": f(2, 8),
                                           "lora_a": f(2, R_MAX, 8),
                                           "lora_b": f(2, 8, R_MAX)}},
                       "mlp": {"down_proj": {"w": f(2, 12, 8),
                                             "lora_a": f(2, R_MAX, 12),
                                             "lora_b": f(2, 8, R_MAX)}}}}


def _pairs(t_tree, j_tree):
    """(path, port leaf, reference leaf) for every port leaf."""
    j_flat = {tuple(str(getattr(k, "key", k)) for k in p): x
              for p, x in jax.tree_util.tree_leaves_with_path(j_tree)}
    return [(p, x, j_flat[p]) for p, x in tlora.flatten(t_tree).items()]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def test_split_lora_only_and_adapter_paths():
    tree = _tree()
    base, lora = tlora.split_lora(_to_torch(tree))
    assert tlora.flatten(tlora.merge_lora(base, lora)).keys() == \
        tlora.flatten(_to_torch(tree)).keys()
    pairs = _pairs(tlora.lora_only(_to_torch(tree)), jlora.lora_only(tree))
    assert len(pairs) == 4
    for _, t, j in pairs:
        np.testing.assert_array_equal(t.numpy(), j)
    t_paths = tlora.adapter_paths(_to_torch(tree))
    j_paths = jlora.adapter_paths(tree)
    assert list(t_paths) == list(j_paths) == ["layers/attn/q_proj",
                                              "layers/mlp/down_proj"]
    for name, ab in j_paths.items():
        assert set(t_paths[name]) == {"a", "b"}
        for kind in ab:
            np.testing.assert_array_equal(t_paths[name][kind].numpy(),
                                          ab[kind])


@pytest.mark.parametrize("rank", [4, 8, R_MAX])
def test_truncate_pad_roundtrip_matches_reference(rank):
    """Truncation to r_k, then zero-padding back to r_max, leaf for leaf
    equal to the reference's; shapes restored."""
    tree = _tree(1)
    t_lora = tlora.lora_only(_to_torch(tree))
    j_lora = jlora.lora_only(tree)
    t_trunc = tlora.truncate_adapters(t_lora, rank)
    j_trunc = jlora.truncate_adapters(j_lora, rank)
    t_pad = tlora.pad_adapters(t_trunc, R_MAX)
    j_pad = jlora.pad_adapters(j_trunc, R_MAX)
    for t_tree, j_tree in ((t_trunc, j_trunc), (t_pad, j_pad)):
        for _, t, j in _pairs(t_tree, j_tree):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for (_, p, _), (_, x, _) in zip(_pairs(t_pad, j_pad),
                                    _pairs(t_lora, j_lora)):
        assert p.shape == x.shape


def test_map_adapters_matches_reference():
    tree = _tree(2)

    def fn(_, ab):
        return {"a": ab["a"] * 2.0, "b": ab["b"] - 1.0}

    t_out = tlora.map_adapters(fn, tlora.lora_only(_to_torch(tree)))
    j_out = jlora.map_adapters(fn, jlora.lora_only(tree))
    pairs = _pairs(t_out, j_out)
    assert len(pairs) == 4
    for _, t, j in pairs:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
