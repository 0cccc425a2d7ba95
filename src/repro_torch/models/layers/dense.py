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

A magnitude leaf ``lora_m`` (C, out) next to the factors makes the layer
DoRA's (arXiv:2402.09353, the paper's Table 5): one adapted weight per
client, ``W'_c = m_c * (W + s_c A_c^T B_c^T) / ||W + s_c A_c^T B_c^T||_col``
in f32, applied by a batched product of x (C, N, in) against (C, in, out).
QLoRA keeps the LoRA forward over a base weight fake-quantized once at
init (``quantize_dequantize``).

Serving is the same layout with C = request slots: each slot carries its
own tenant's factors. ``use_kernel`` sends such an adapted projection
through the paged LoRA kernel K4 (``kernels/lora_apply.py``) with row ids
= the row's slot and the per-slot scales, and adds the bias after it, as
the reference's ``_batched_lora_dense`` does; off, the plain path runs.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.lora_apply import batched_lora_apply
from repro_torch.models.layers import draw


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, lora_rank: int = 0,
               dtype=torch.float32, device=None,
               out: Optional[dict] = None) -> dict:
    """w ~ N(0, 1/d_in); bias zeros; LoRA A ~ N(0, 1/r), B = 0 (the
    reference's init distributions; the random streams differ). With
    ``out``, every leaf goes into its tensor there (``draw``)."""
    kw = dict(dtype=dtype, device=device)
    params = {"w": draw.normal(gen, (d_in, d_out), d_in ** -0.5, dtype,
                               device, draw.sub(out, "w"))}
    if bias:
        params["b"] = draw.keep(torch.zeros(d_out, **kw),
                                draw.sub(out, "b"))
    if lora_rank > 0:
        params["lora_a"] = draw.normal(gen, (lora_rank, d_in),
                                       (1.0 / lora_rank) ** 0.5, dtype,
                                       device, draw.sub(out, "lora_a"))
        params["lora_b"] = draw.keep(torch.zeros(d_out, lora_rank, **kw),
                                     draw.sub(out, "lora_b"))
    return params


def dense_apply(params: dict, x: torch.Tensor, *,
                lora_scale: Optional[torch.Tensor] = None,
                lora_rank: int = -1, use_kernel: bool = False
                ) -> torch.Tensor:
    """x (C, ..., in). ``lora_scale`` (C,) per-client scales; ``lora_rank``
    -1 uses the full factors, 0 disables the adapter, r > 0 truncates.
    With a magnitude ``lora_m`` the layer is DoRA's (``use_kernel`` does
    not apply: K4 has no DoRA form, as in the reference)."""
    if lora_rank != 0 and "lora_m" in params and "lora_a" in params:
        return _dora_apply(params, x, lora_scale, lora_rank)
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
    """K4 over the slot axis: slot c's rows use page c (its own factors).
    x, W and the factors in the model's dtype (f32 or bf16) go to the
    kernel as they are; y comes back in that dtype."""
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


def _dora_apply(params: dict, x: torch.Tensor,
                lora_scale: Optional[torch.Tensor],
                lora_rank: int) -> torch.Tensor:
    """DoRA over the client axis: W'_c = m_c * (W + s_c dW_c) /
    ||W + s_c dW_c||_col with dW_c = A_c^T B_c^T (in, out), all in f32
    (the reference's ``_dora_apply`` for each client c)."""
    a, b = params["lora_a"], params["lora_b"]
    if lora_rank > 0:
        a, b = a[..., :lora_rank, :], b[..., :lora_rank]
    c = x.shape[0]
    dw = a.float().mT @ b.float().mT                   # (C, in, out)
    if lora_scale is not None:
        dw = lora_scale.float().reshape(c, 1, 1) * dw
    adapted = params["w"].float() + dw
    col_norm = torch.sqrt(torch.sum(torch.square(adapted), dim=-2) + 1e-8)
    scaled = adapted * (params["lora_m"].float() / col_norm)[:, None, :]
    x2 = x.reshape(c, -1, x.shape[-1])
    y = (x2 @ scaled.to(x.dtype)).reshape(x.shape[:-1] + (scaled.shape[-1],))
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def dora_magnitude_init(w: torch.Tensor) -> torch.Tensor:
    """DoRA init: m = column norms of the pretrained weight, in f32; for
    layer-stacked weights (..., in, out) the norm runs over the in dim.

    Bit-equal to the reference as XLA compiles it on the CPU: the column
    sum runs in XLA's order (``_xla_column_sum``) and the square root is
    correctly rounded (through f64, as numpy's and XLA's are; torch's CPU
    f32 ``sqrt`` is not)."""
    return torch.sqrt(_xla_column_sum(torch.square(w.float())).double()
                      ).float()


def _xla_column_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim -2 in the order of XLA's CPU reduction: while the
    summed dim is longer than 32 it is zero-padded symmetrically (the
    extra row at the end) to a multiple of 32 and each window of 32 rows
    is summed in order; the last <= 32 partial sums are summed in order."""
    while x.shape[-2] > 32:
        n = x.shape[-2]
        pad = -n % 32
        x = F.pad(x, (0, 0, pad // 2, pad - pad // 2))
        x = _sum_rows(x.reshape(x.shape[:-2] + ((n + pad) // 32, 32,
                                                x.shape[-1])))
    return _sum_rows(x)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        acc = acc + x[..., i, :]
    return acc


def quantize_dequantize(w: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """QLoRA simulation: per-output-channel symmetric fake quantization of
    the frozen base weight over the in dim (layer-stacked weights too),
    rounding half to even and clipping to [-levels - 1, levels], as the
    reference's ``jnp.round`` and ``jnp.clip`` do."""
    levels = 2 ** (bits - 1) - 1
    scale = torch.amax(torch.abs(w), dim=-2, keepdim=True) / levels
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(w / scale), -levels - 1, levels)
    return (q * scale).to(w.dtype)
