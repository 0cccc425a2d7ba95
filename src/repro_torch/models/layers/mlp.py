"""Feed-forward blocks (port of ``repro/models/layers/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ACT_GEGLU, ACT_GELU, ACT_RELU2, ACT_SWIGLU
from repro_torch.models.layers.dense import dense_apply, dense_init


def is_gated(activation: str) -> bool:
    return activation in (ACT_GEGLU, ACT_SWIGLU)


def _act(activation: str, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so must the port
    if activation in (ACT_GELU, ACT_GEGLU):
        return F.gelu(x, approximate="tanh")
    if activation == ACT_SWIGLU:
        return F.silu(x)
    if activation == ACT_RELU2:
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {activation!r}")


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             *, lora_ranks: dict, dtype=torch.float32, device=None) -> dict:
    """lora_ranks maps {"up_proj": r, "gate_proj": r, "down_proj": r}."""
    kw = dict(dtype=dtype, device=device)
    params = {
        "up": dense_init(gen, d_model, d_ff,
                         lora_rank=lora_ranks.get("up_proj", 0), **kw),
        "down": dense_init(gen, d_ff, d_model,
                           lora_rank=lora_ranks.get("down_proj", 0), **kw),
    }
    if is_gated(activation):
        params["gate"] = dense_init(gen, d_model, d_ff,
                                    lora_rank=lora_ranks.get("gate_proj", 0),
                                    **kw)
    return params


def mlp_apply(params: dict, x: torch.Tensor, activation: str, **lk
              ) -> torch.Tensor:
    up = dense_apply(params["up"], x, **lk)
    if "gate" in params:
        h = _act(activation, dense_apply(params["gate"], x, **lk)) * up
    else:
        h = _act(activation, up)
    return dense_apply(params["down"], h, **lk)
