"""Feed-forward blocks (port of ``repro/models/layers/mlp.py``)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ACT_GEGLU, ACT_GELU, ACT_RELU2, ACT_SWIGLU
from repro_torch.models.layers import draw
from repro_torch.models.layers.dense import dense_apply, dense_init


def is_gated(activation: str) -> bool:
    return activation in (ACT_GEGLU, ACT_SWIGLU)


def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu. In f32, torch's fused op. In a lower precision the
    reference rounds after every elementwise op (XLA keeps each bf16
    intermediate) where a fused torch op rounds once, so its sequence is
    written out, one rounding per op: x * (1 / (1 + exp(-x)))."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu (its default tanh approximation). Below f32, as
    ``silu``: 0.5 * (1 + tanh(c2 * (x + c1 * x**3))) * x with x**3 as (x *
    x) * x and the constants in x's dtype, one rounding per op."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c1 = torch.tensor(0.044715, dtype=x.dtype)
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def _act(activation: str, x: torch.Tensor) -> torch.Tensor:
    if activation in (ACT_GELU, ACT_GEGLU):
        return gelu_tanh(x)
    if activation == ACT_SWIGLU:
        return silu(x)
    if activation == ACT_RELU2:
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {activation!r}")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             *, lora_ranks: dict, dtype=torch.float32, device=None,
             out: Optional[dict] = None) -> dict:
    """lora_ranks maps {"up_proj": r, "gate_proj": r, "down_proj": r}."""
    kw = dict(dtype=dtype, device=device)
    params = {
        "up": dense_init(gen, d_model, d_ff,
                         lora_rank=lora_ranks.get("up_proj", 0),
                         out=draw.sub(out, "up"), **kw),
        "down": dense_init(gen, d_ff, d_model,
                           lora_rank=lora_ranks.get("down_proj", 0),
                           out=draw.sub(out, "down"), **kw),
    }
    if is_gated(activation):
        params["gate"] = dense_init(gen, d_model, d_ff,
                                    lora_rank=lora_ranks.get("gate_proj", 0),
                                    out=draw.sub(out, "gate"), **kw)
    return params


def mlp_apply(params: dict, x: torch.Tensor, activation: str, **lk
              ) -> torch.Tensor:
    up = dense_apply(params["up"], x, **lk)
    if "gate" in params:
        h = _act(activation, dense_apply(params["gate"], x, **lk)) * up
    else:
        h = _act(activation, up)
    return dense_apply(params["down"], h, **lk)
