"""Device policy of the port: the card unless the caller asks otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. Without CUDA that raises: the port never
    drops quietly to the CPU; the CPU path is taken only on request."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default, but CUDA is not "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
