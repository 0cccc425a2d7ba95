"""Carry weights between the JAX package and the port.

``params_from_numpy`` turns a parameter pytree of the JAX package whose
leaves are numpy arrays (``jax.tree.map(np.asarray, params)``) into the
port's parameter tree: the same nested keys, the same layouts and adapter
paths, tensors on ``device``. ``FederatedLoRA`` and ``build_experiment``
accept the result as ``base_params``. The two frameworks' random streams
differ, so every parity test starts both sides from one set of weights
through this function.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device=None) -> dict:
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items() if v is not None}
        return torch.as_tensor(np.array(x, copy=True), device=dev)

    return conv(tree)

