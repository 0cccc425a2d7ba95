"""Dense projection with an optional LoRA adapter per client.

Parameter layout per dense layer, as in the reference::

    {"w": (in, out) [, "b": (out,)] [, "lora_a": (C, r, in),
     "lora_b": (C, out, r)]}

where the adapter leaves carry a leading CLIENT axis C matching the
leading axis of x (C, ..., in): the all-rank masked round trains every
sampled client at once with shared base weights, each through its own
factors and scale. A single model is the C = 1 case. Forward, with
s = alpha / r (s = 1 under the paper's alpha = r)::

    y = x @ w + b + s * (x @ a.T) @ b.T

Serving is the same layout with C = request slots: each slot carries its
own tenant's factors. ``use_kernel`` sends such an adapted projection
through the paged LoRA kernel K4 (``kernels/lora_apply.py``) with row ids
= the row's slot and the per-slot scales, and adds the bias after it, as
the reference's ``_batched_lora_dense`` does; off, the plain path runs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lora_apply import batched_lora_apply


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, lora_rank: int = 0,
               dtype=torch.float32, device=None) -> dict:
    """w ~ N(0, 1/d_in); bias zeros; LoRA A ~ N(0, 1/r), B = 0 (the
    reference's init distributions; the random streams differ)."""
    params = {"w": (torch.randn(d_in, d_out, generator=gen, device=device)
                    * d_in ** -0.5).to(dtype)}
    if bias:
        params["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    if lora_rank > 0:
        params["lora_a"] = (torch.randn(lora_rank, d_in, generator=gen,
                                        device=device)
                            * (1.0 / lora_rank) ** 0.5).to(dtype)
        params["lora_b"] = torch.zeros(d_out, lora_rank, dtype=dtype,
                                       device=device)
    return params


def dense_apply(params: dict, x: torch.Tensor, *,
                lora_scale: Optional[torch.Tensor] = None,
                lora_rank: int = -1, use_kernel: bool = False
                ) -> torch.Tensor:
    """x (C, ..., in). ``lora_scale`` (C,) per-client scales; ``lora_rank``
    -1 uses the full factors, 0 disables the adapter, r > 0 truncates."""
    if use_kernel and lora_rank != 0 and "lora_a" in params:
        return _kernel_lora_dense(params, x, lora_scale, lora_rank)
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    if lora_rank != 0 and "lora_a" in params:
        a, b = params["lora_a"], params["lora_b"]
        if lora_rank > 0:
            a, b = a[..., :lora_rank, :], b[..., :lora_rank]
        c = x.shape[0]
        x2 = x.reshape(c, -1, x.shape[-1])
        z = x2 @ a.to(x.dtype).mT                       # (C, N, r)
        lo = z @ b.to(x.dtype).mT                       # (C, N, out)
        if lora_scale is not None:
            lo = lora_scale.to(x.dtype).reshape(c, 1, 1) * lo
        y = y + lo.reshape(y.shape)
    return y


def _kernel_lora_dense(params: dict, x: torch.Tensor,
                       lora_scale: Optional[torch.Tensor],
                       lora_rank: int) -> torch.Tensor:
    """K4 over the slot axis: slot c's rows use page c (its own factors)."""
    a, b = params["lora_a"], params["lora_b"]
    if lora_rank > 0:
        a, b = a[..., :lora_rank, :], b[..., :lora_rank].contiguous()
    c, k = x.shape[0], x.shape[-1]
    x2 = x.reshape(c, -1, k).contiguous()
    ids = torch.arange(c, dtype=torch.int32, device=x.device)[:, None]
    ids = ids.expand(c, x2.shape[1]).contiguous()
    scales = (torch.ones(c, dtype=torch.float32, device=x.device)
              if lora_scale is None
              else lora_scale.to(torch.float32).expand(c).contiguous())
    y = batched_lora_apply(x2, params["w"], a, b, scales, ids)
    y = y.reshape(x.shape[:-1] + (y.shape[-1],))
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y
