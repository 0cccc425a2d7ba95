"""LoRA adapter trees of the port.

Parameters are nested dicts of tensors with the JAX package's keys and
layouts: a LoRA-augmented dense layer is ``{"w": (..., in, out)[, "b"],
"lora_a": (..., r_max, in), "lora_b": (..., out, r_max)}``. A path is the
tuple of keys down to a leaf, as in the reference's pytrees.

Traversal is in SORTED key order everywhere (``flatten``), because that is
how JAX flattens dict pytrees: the server's adapter order -- and with it
which adapter the energy probe follows -- must be the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
