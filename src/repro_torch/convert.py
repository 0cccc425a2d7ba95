"""Carry weights between the JAX package and the port.

``params_from_numpy`` turns a parameter pytree of the JAX package whose
leaves are numpy arrays (``jax.tree.map(np.asarray, params)``) into the
port's parameter tree: the same nested keys, the same layouts and adapter
paths, tensors on ``device``. ``FederatedLoRA`` and ``build_experiment``
accept the result as ``base_params``. The two frameworks' random streams
differ, so every parity test starts both sides from one set of weights
through this function.

The same function carries an adapter tree of the JAX package (from
``split_lora``, ``None`` at every base leaf) or a ``PublishedAdapters.pages``
tree into the port's lora-only trees: ``None`` leaves are dropped, and so
is every sub-tree left empty by that, so the result has the port's
``split_lora`` / ``AdapterStore`` structure.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None) -> dict:
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            out = {k: conv(v) for k, v in x.items() if v is not None}
            return {k: v for k, v in out.items()
                    if not (isinstance(v, dict) and not v)}
        return torch.as_tensor(np.array(x, copy=True), device=dev)

    return conv(tree)

