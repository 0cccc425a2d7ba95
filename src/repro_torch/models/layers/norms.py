"""RMSNorm (port of ``repro/models/layers/norms.py::rms_norm``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import draw


def rms_norm_init(d: int, dtype=torch.float32, device=None,
                  out: Optional[dict] = None) -> dict:
    return {"scale": draw.keep(torch.ones(d, dtype=dtype, device=device),
                               draw.sub(out, "scale"))}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Statistics in f32, multiply in the input dtype."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * params["scale"].to(x.dtype)
