"""Fused LoRA apply kernels, ported from ``repro/kernels/lora_apply.py``:
K4, the paged multi-adapter apply of serving (DESIGN.md §11; replaces
``batched_lora_apply_pallas``), where row t of x uses the adapter page
p = ids[t]::

    y[t] = x[t] @ W + s_p * (x[t] @ A_p^T) @ B_p^T

and K5, the single-adapter apply y = x @ W + s * (x @ A^T) @ B^T
(replaces ``lora_apply_pallas``; no model calls it, the kernel API ``ops``
does). Both run ``csrc/lora_apply.cu``, K5 without the page gather.

Above ``GEMV_MAX_ROWS`` rows the base product is the f32 SGEMM of
``csrc/sgemm_f32.cuh``; ``gemm_plan.plan_gemm`` chooses its tile and its
split over K from the shapes, here on the host, and the wrapper passes
the plan (and a workspace for the partial tiles) to the C entry.
``*_split_plain`` repeat that arithmetic in PyTorch: K cut as the plan
cuts it, the partials summed in the kernel's order, then the adapter
term.

``*_plain`` are the plain PyTorch versions; each wrapper computes its plain
version for CPU tensors and launches the CUDA kernel for CUDA tensors, with
no fallback: a failed build or launch raises. ``wrapper.launches`` counts
kernel calls and nothing else. The kernels have no backward, so the
wrappers refuse inputs that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm_plan import (  # noqa: F401 (kept importable)
    MIN_SPLIT_DEPTH, RESIDENT, SLAB, SMS, TILES, WAVE, GemmPlan, plan_gemm,
    split_ranges, split_sum)
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


def lora_apply_plain(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``ref.lora_apply_ref``: x (M, K); w (K, N); a (r, K); b (N, r) ->
    (M, N) in x.dtype, computed in f32."""
    xf = x.float()
    y = xf @ w.float()
    z = xf @ a.float().T
    return (y + scale * (z @ b.float().T)).to(x.dtype)


# -- the SGEMM's plan (gemm_plan.py, shared with K2 and K3) ----------------

GEMV_MAX_ROWS = 32        # up to this many rows: the GEMV route, no plan


def describe_plan(m: int, n: int, k: int) -> dict:
    """The route and plan of an (m, k) @ (k, n) call, for reports."""
    if m <= GEMV_MAX_ROWS:
        return {"route": "gemv"}
    return {"route": "sgemm", **plan_gemm(m, n, k).report()}


def _sgemm_args(m: int, n: int, k: int, device) -> tuple:
    """(workspace or None, bm, bn, splits, depth) for the C entry."""
    if m <= GEMV_MAX_ROWS:
        return None, 0, 0, 1, 0
    p = plan_gemm(m, n, k)
    part = torch.empty((p.splits, m, n), dtype=torch.float32,
                       device=device) if p.splits > 1 else None
    return part, p.bm, p.bn, p.splits, p.depth


def _split_product(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 @ w as the SGEMM route sums it: one partial product per range
    of the plan, added in range order."""
    m, k = x2.shape
    depth = plan_gemm(m, w.shape[1], k).depth if m > GEMV_MAX_ROWS else k
    return split_sum(lambda k0, k1: x2[:, k0:k1] @ w[k0:k1], k, depth)


def batched_lora_apply_split_plain(x: torch.Tensor, w: torch.Tensor,
                                   a_pages: torch.Tensor,
                                   b_pages: torch.Tensor,
                                   scales: torch.Tensor,
                                   ids: torch.Tensor) -> torch.Tensor:
    """``batched_lora_apply_plain`` with the base product split over K as
    ``plan_gemm`` splits it; (..., N) f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    idf = ids.reshape(-1).long()
    z = torch.einsum("mk,mrk->mr", x2, a_pages.float()[idf])
    s = scales.float()[idf]
    y = _split_product(x2, w.float()) + torch.einsum(
        "mr,mnr->mn", s[:, None] * z, b_pages.float()[idf])
    return y.reshape(lead + (w.shape[-1],))


def lora_apply_split_plain(x: torch.Tensor, w: torch.Tensor,
                           a: torch.Tensor, b: torch.Tensor,
                           scale: float = 1.0) -> torch.Tensor:
    """``lora_apply_plain`` with the base product split over K as
    ``plan_gemm`` splits it; (M, N) f32."""
    xf = x.float()
    z = xf @ a.float().T
    return _split_product(xf, w.float()) + (scale * z) @ b.float().T


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
    part, *plan = _sgemm_args(m, n, k, x.device)
    fn = "batched_lora_apply_f32"
    rc = getattr(build.library("lora_apply"), fn)(
        x.data_ptr(), w.data_ptr(), a_pages.data_ptr(), b_pages.data_ptr(),
        scales.data_ptr(), ids.data_ptr(), z.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None, m, k, n, r, p,
        a_pages.stride(0), b_pages.stride(0), *plan, _stream(x))
    build.check(rc, fn)
    batched_lora_apply.launches += 1
    return y


def lora_apply(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """K5: x (M, K); w (K, N); a (r, K); b (N, r), all f32 contiguous;
    ``scale`` a Python number -> (M, N) f32."""
    for name, t in (("x", x), ("w", w), ("a", a), ("b", b)):
        _check(f"lora_apply {name}", t, 2, torch.float32)
        if not t.is_contiguous():
            raise ValueError(f"lora_apply {name}: input must be contiguous")
        _same_device(x, t, "lora_apply")
    (m, k), n, r = x.shape, w.shape[1], a.shape[0]
    if w.shape[0] != k or tuple(a.shape) != (r, k) or \
            tuple(b.shape) != (n, r):
        raise ValueError(f"lora_apply: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not match")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, a, b)):
        raise NotImplementedError("lora_apply has no backward")
    if x.device.type == "cpu":
        return lora_apply_plain(x, w, a, b, scale)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    z = torch.empty((m, r), dtype=torch.float32, device=x.device)
    part, *plan = _sgemm_args(m, n, k, x.device)
    fn = "lora_apply_f32"
    rc = getattr(build.library("lora_apply"), fn)(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), z.data_ptr(),
        y.data_ptr(), part.data_ptr() if part is not None else None, m, k, n,
        r, float(scale), *plan, _stream(x))
    build.check(rc, fn)
    lora_apply.launches += 1
    return y


KERNELS = (batched_lora_apply, lora_apply)
for _k in KERNELS:
    _k.launches = 0
