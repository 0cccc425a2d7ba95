"""Round-resumable checkpointing, a port of
``repro/checkpointing/checkpoint.py``: nested-dict parameter trees <->
``.npz`` files with "/"-joined path keys, and a JSON metadata sidecar.

The files are the reference's layout: a tree's arrays are keyed by the
dict keys down to each leaf joined with "/" (the reference's ``_flatten``
of a dict pytree gives the same strings), so a checkpoint written by
either package loads in the other. Both the ``.npz`` and the
``.meta.json`` are written ATOMICALLY (a temp file in the target
directory, then ``os.replace``): a crash mid-save leaves the previous
checkpoint or the new one, never a torn file.

Path spellings: ``save("ckpt")`` and ``save("ckpt.npz")`` are the same
checkpoint; the arrays land at ``<stem>.npz``, the metadata at
``<stem>.meta.json``.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.lora import flatten, unflatten


def _stem(path: str) -> str:
    """Normalize both accepted spellings to the extensionless stem."""
    return path[:-len(".npz")] if path.endswith(".npz") else path


def _atomic_write(path: str, suffix: str, write) -> None:
    """``write(file)`` into a temp file in the target dir, then
    ``os.replace``; the temp file is removed on any failure."""
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _atomic_savez(npz_path: str, arrays: dict) -> None:
    _atomic_write(npz_path, ".npz", lambda f: np.savez(f, **arrays))


def _atomic_write_text(path: str, text: str) -> None:
    _atomic_write(path, ".json", lambda f: f.write(text.encode()))


def _to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array -> numpy, for the ``.npz``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flatten(tree: dict) -> Dict[str, np.ndarray]:
    return {"/".join(path): _to_numpy(x) for path, x in flatten(tree).items()
            if x is not None}


def _json_safe(obj):
    """Recursively convert numpy scalars and arrays so metadata dumps."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    return obj


def save_pytree(path: str, tree: dict,
                metadata: Optional[dict] = None) -> None:
    """Atomically write ``<stem>.npz`` (and ``<stem>.meta.json``)."""
    stem = _stem(path)
    _atomic_savez(stem + ".npz", _flatten(tree))
    if metadata is not None:
        _atomic_write_text(stem + ".meta.json",
                           json.dumps(_json_safe(metadata)))


def load_pytree(path: str, like: dict) -> Any:
    """Restore into the structure of ``like``: each leaf keeps its
    template's shape, dtype and device."""
    with np.load(_stem(path) + ".npz") as data:
        out = {}
        for p, x in flatten(like).items():
            key = "/".join(p)
            arr = data[key]
            assert arr.shape == tuple(x.shape), (key, arr.shape, x.shape)
            out[p] = torch.as_tensor(arr, dtype=x.dtype, device=x.device)
    return unflatten(out)


def load_metadata(path: str) -> Optional[dict]:
    """Metadata for either path spelling (``<stem>.meta.json`` first,
    then ``<path>.meta.json``)."""
    for candidate in (_stem(path) + ".meta.json", path + ".meta.json"):
        if os.path.exists(candidate):
            with open(candidate) as f:
                return json.load(f)
    return None


# -- flat, template-free array blobs ----------------------------------------
#
# Server momentum and the async engine's pending plans have no template at
# restore time (their structure depends on what was in flight), so they
# serialize as flat string-keyed array dicts.

def save_flat(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Atomically write a flat {key: array} dict to ``<stem>.npz``."""
    _atomic_savez(_stem(path) + ".npz",
                  {k: _to_numpy(v) for k, v in arrays.items()})


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Load a flat {key: array} dict saved by ``save_flat``."""
    with np.load(_stem(path) + ".npz") as data:
        return {k: data[k] for k in data.files}
