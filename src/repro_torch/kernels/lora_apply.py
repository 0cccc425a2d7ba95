"""Paged multi-adapter LoRA apply K4 (DESIGN.md §11), ported from
``repro/kernels/lora_apply.py::batched_lora_apply_pallas``.

Row t of x uses the adapter page p = ids[t]::

    y[t] = x[t] @ W + s_p * (x[t] @ A_p^T) @ B_p^T

``batched_lora_apply_plain`` is the plain PyTorch version; the wrapper
``batched_lora_apply`` computes it for CPU tensors and launches the CUDA
kernel (``csrc/lora_apply.cu``) for CUDA tensors, with no fallback: a
failed build or launch raises. ``batched_lora_apply.launches`` counts
kernel calls and nothing else. The kernel has no backward, so the wrapper
refuses inputs that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rank_partition_agg import _same_device, _stream


def batched_lora_apply_plain(x: torch.Tensor, w: torch.Tensor,
                             a_pages: torch.Tensor, b_pages: torch.Tensor,
                             scales: torch.Tensor,
                             ids: torch.Tensor) -> torch.Tensor:
    """x (..., K); ids (...) int; a_pages (P, r, K); b_pages (P, N, r);
    scales (P,) f32 -> (..., N) in x.dtype, computed in f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    idf = ids.reshape(-1).long()
    a = a_pages.float()[idf]                      # (M, r, K)
    b = b_pages.float()[idf]                      # (M, N, r)
    s = scales.float()[idf]
    z = torch.einsum("mk,mrk->mr", x2, a)
    y = x2 @ w.float() + s[:, None] * torch.einsum("mr,mnr->mn", z, b)
    return y.reshape(lead + (w.shape[-1],)).to(x.dtype)


def _check(name: str, t: torch.Tensor, ndim: int, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_pages(name: str, t: torch.Tensor) -> None:
    """Each page contiguous; the page axis may be strided (a per-layer
    slice of a stacked adapter tree)."""
    _check(name, t, 3, torch.float32)
    if t.shape[1] * t.shape[2] and t.stride()[1:] != (t.shape[2], 1):
        raise ValueError(f"{name}: every page must be contiguous")


def batched_lora_apply(x: torch.Tensor, w: torch.Tensor,
                       a_pages: torch.Tensor, b_pages: torch.Tensor,
                       scales: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """K4: x (..., K) f32 contiguous; w (K, N) contiguous; a_pages
    (P, r, K); b_pages (P, N, r); scales (P,) f32; ids (...) int32 page
    index per row -> (..., N) f32."""
    _check("batched_lora_apply x", x, x.ndim, torch.float32)
    _check("batched_lora_apply w", w, 2, torch.float32)
    _check_pages("batched_lora_apply a_pages", a_pages)
    _check_pages("batched_lora_apply b_pages", b_pages)
    _check("batched_lora_apply scales", scales, 1, torch.float32)
    _check("batched_lora_apply ids", ids, ids.ndim, torch.int32)
    for t in (w, a_pages, b_pages, scales, ids):
        _same_device(x, t, "batched_lora_apply")
    k, n = w.shape
    p, r, _ = a_pages.shape
    if x.ndim < 1 or x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match w {(k, n)}")
    if tuple(a_pages.shape) != (p, r, k) or \
            tuple(b_pages.shape) != (p, n, r) or tuple(scales.shape) != (p,):
        raise ValueError(
            f"pages a {tuple(a_pages.shape)}, b {tuple(b_pages.shape)}, "
            f"scales {tuple(scales.shape)} do not match {(p, r, k, n)}")
    if tuple(ids.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"ids {tuple(ids.shape)} != rows {x.shape[:-1]}")
    if not (x.is_contiguous() and w.is_contiguous() and ids.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("batched_lora_apply: x, w, scales and ids must be "
                         "contiguous")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w, a_pages, b_pages, scales)):
        raise NotImplementedError(
            "batched_lora_apply has no backward (serving only)")
    if x.device.type == "cpu":
        return batched_lora_apply_plain(x, w, a_pages, b_pages, scales, ids)
    m = ids.numel()
    y = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                    device=x.device)
    z = torch.empty((m, r), dtype=torch.float32, device=x.device)
    fn = "batched_lora_apply_f32"
    rc = getattr(build.library("lora_apply"), fn)(
        x.data_ptr(), w.data_ptr(), a_pages.data_ptr(), b_pages.data_ptr(),
        scales.data_ptr(), ids.data_ptr(), z.data_ptr(), y.data_ptr(),
        m, k, n, r, p, a_pages.stride(0), b_pages.stride(0), _stream(x))
    build.check(rc, fn)
    batched_lora_apply.launches += 1
    return y


KERNELS = (batched_lora_apply,)
batched_lora_apply.launches = 0
