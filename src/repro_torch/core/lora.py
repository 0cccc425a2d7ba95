"""LoRA adapter trees of the port.

Parameters are nested dicts of tensors with the JAX package's keys and
layouts: a LoRA-augmented dense layer is ``{"w": (..., in, out)[, "b"],
"lora_a": (..., r_max, in), "lora_b": (..., out, r_max)}``. A path is the
tuple of keys down to a leaf, as in the reference's pytrees.

The federation layer splits params into (base, lora) so clients optimize
only adapters, truncates adapters to a client rank r_k (broadcast, Alg. 1
line 4), pads them back to r_max (upload) and enumerates them per parent.

Traversal is in SORTED key order everywhere (``flatten``), because that is
how JAX flattens dict pytrees: the server's adapter order -- and with it
which adapter the energy probe follows -- must be the reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch.nn.functional as F

LORA_KEYS = ("lora_a", "lora_b", "lora_m")  # lora_m: DoRA magnitude


def _is_lora_path(path: Tuple[str, ...]) -> bool:
    return path[-1] in LORA_KEYS


def flatten(tree: dict, prefix: Tuple[str, ...] = ()) -> Dict[tuple, object]:
    """{path: leaf} in sorted-key (JAX pytree) order."""
    out: Dict[tuple, object] = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = val
    return out


def unflatten(flat: Dict[tuple, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def split_lora(params: dict) -> Tuple[dict, dict]:
    """(base, lora) trees: every leaf lands in exactly one of them."""
    flat = flatten(params)
    base = {p: x for p, x in flat.items() if not _is_lora_path(p)}
    lora = {p: x for p, x in flat.items() if _is_lora_path(p)}
    return unflatten(base), unflatten(lora)


def merge_lora(base: dict, lora: dict) -> dict:
    """Inverse of split_lora."""
    return unflatten({**flatten(base), **flatten(lora)})


def adapter_parents(lora: dict):
    """Adapter parent paths (the dense layer holding lora_a/lora_b) in
    sorted-key order."""
    seen = []
    for path in flatten(lora):
        if path[-1] in ("lora_a", "lora_b") and path[:-1] not in seen:
            seen.append(path[:-1])
    return seen


def lora_only(params: dict) -> dict:
    """The tree pruned to its adapter leaves (for optimizer state)."""
    return split_lora(params)[1]


def _kind(path: Tuple[str, ...]) -> str:
    return "a" if path[-1] == "lora_a" else "b"


def adapter_paths(params: dict) -> Dict[str, Dict[str, object]]:
    """{"dotted/path": {"a": A, "b": B}} for every adapter in the tree."""
    out: Dict[str, Dict[str, object]] = {}
    for path, x in flatten(params).items():
        if _is_lora_path(path):
            out.setdefault("/".join(path[:-1]), {})[_kind(path)] = x
    return out


def truncate_adapters(lora_tree: dict, rank: int) -> dict:
    """Broadcast step: slice every adapter to the client's rank r_k
    (magnitudes are not rank-indexed)."""
    def trunc(path, x):
        if path[-1] == "lora_a":
            return x[..., :rank, :]
        if path[-1] == "lora_b":
            return x[..., :, :rank]
        return x
    return unflatten({p: trunc(p, x) for p, x in flatten(lora_tree).items()})


def pad_adapters(lora_tree: dict, r_max: int) -> dict:
    """Upload step: zero-pad rank-r_k adapters back to r_max."""
    def pad(path, x):
        if path[-1] == "lora_a":
            return F.pad(x, (0, 0, 0, r_max - x.shape[-2]))
        if path[-1] == "lora_b":
            return F.pad(x, (0, r_max - x.shape[-1]))
        return x
    return unflatten({p: pad(p, x) for p, x in flatten(lora_tree).items()})


def map_adapters(fn: Callable, lora_tree: dict) -> dict:
    """Apply fn(parent_path, {"a": A, "b": B}) -> {"a": A', "b": B'} to
    every adapter pair in the tree; returns a new tree."""
    flat = flatten(lora_tree)
    pairs: Dict[tuple, Dict[str, object]] = {}
    for path, x in flat.items():
        if _is_lora_path(path):
            pairs.setdefault(path[:-1], {})[_kind(path)] = x
    results = {parent: fn(parent, ab) for parent, ab in pairs.items()}
    return unflatten({p: results[p[:-1]][_kind(p)] if _is_lora_path(p)
                      else x for p, x in flat.items()})
