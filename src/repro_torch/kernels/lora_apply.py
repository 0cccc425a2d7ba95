"""Fused LoRA apply kernels, ported from ``repro/kernels/lora_apply.py``:
K4, the paged multi-adapter apply of serving (DESIGN.md §11; replaces
``batched_lora_apply_pallas``), where row t of x uses the adapter page
p = ids[t]::

    y[t] = x[t] @ W + s_p * (x[t] @ A_p^T) @ B_p^T

in f32 or, for a bf16 model, with x, W and the pages read as bf16 and y
written in bf16 (every product and sum in f32, y rounded once),
and K5, the single-adapter apply y = x @ W + s * (x @ A^T) @ B^T
(replaces ``lora_apply_pallas``; no model calls it, the kernel API ``ops``
does). Both run ``csrc/lora_apply.cu``, K5 without the page gather.

Each call's base product takes one of four routes (``describe_plan``
names it), each planned here on the host (``gemm_plan``) and passed, with
its scratch, to the C entry:

* ``"gemv"``, at most ``GEMV_MAX_ROWS`` rows, both dtypes, K4 and K5: W
  streamed in 128-byte strips, K split over blocks (``plan_gemv``), the
  partials summed in the launch by the last block of each tile;
* ``"mma_bf16"``, K4's bf16 instances above that: the bf16 tensor cores
  (``csrc/mma_bf16.cuh``; ``plan_gemm_bf16``), split and summed alike;
* ``"sgemm"``, K4 in f32 above that: the SIMT SGEMM of
  ``csrc/sgemm_f32.cuh`` (``plan_gemm``), its splits through an (S, M, N)
  workspace and a second kernel;
* ``"mma_tf32x3"``, K5 above that: 3xTF32 on the tensor cores
  (``csrc/mma_tf32x3.cuh``; ``plan_gemm_tc``), split as the SGEMM.

The GEMV's and the bf16 route's partials and counters live in one
scratch a device, allocated at a shape's first call and reused (the
counters reset themselves). ``batched_lora_apply_split_plain`` and
``lora_apply_tf32x3_plain`` repeat the arithmetic in PyTorch: K cut as
the route's plan cuts it, the partials (K5's from 3xTF32 products above
32 rows) summed in the kernel's order, then the adapter term.

``*_plain`` are the plain PyTorch versions; each wrapper computes its plain
version for CPU tensors and launches the CUDA kernel for CUDA tensors, with
no fallback: a failed build or launch raises. ``wrapper.launches`` counts
kernel calls and nothing else (``batched_lora_apply.launches_bf16`` those
of them through the bf16 instances). The kernels have no backward, so the
wrappers refuse inputs that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, tf32x3
from repro_torch.kernels.gemm_plan import (  # noqa: F401 (kept importable)
    MIN_SPLIT_DEPTH, RESIDENT, SLAB, SMS, TILES, WAVE, GemmPlan, plan_gemm,
    plan_gemm_bf16, plan_gemm_tc, plan_gemv, split_ranges, split_sum)
from repro_torch.kernels.rank_partition_agg import _same_device, _stream


def page_index(ids: torch.Tensor, pages: int) -> torch.Tensor:
    """Page ids (...) as the reference's gathers take them (``ref.py``'s
    ``a_pages[ids]``, the serving engine's ``leaf[page_ids]``): a negative
    id counts from the end, then every id is clamped to [0, P - 1]; int64,
    on the device, with no read to the host."""
    ids = ids.long()
    return torch.where(ids < 0, ids + pages, ids).clamp(0, pages - 1)


def batched_lora_apply_plain(x: torch.Tensor, w: torch.Tensor,
                             a_pages: torch.Tensor, b_pages: torch.Tensor,
                             scales: torch.Tensor,
                             ids: torch.Tensor) -> torch.Tensor:
    """x (..., K); ids (...) int; a_pages (P, r, K); b_pages (P, N, r);
    scales (P,) f32 -> (..., N) in x.dtype, computed in f32; ids by
    ``page_index``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    idf = page_index(ids.reshape(-1), a_pages.shape[0])
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


# -- the routes' plans (gemm_plan.py, shared with K2 and K3) ---------------

GEMV_MAX_ROWS = 32        # up to this many rows: the GEMV route


def _route(m: int, n: int, k: int, tensor_cores: bool,
           dtype: torch.dtype) -> tuple:
    """(route, plan) of an (m, k) @ (k, n) base product: K4's, or with
    ``tensor_cores`` K5's, for operands of ``dtype``."""
    if m <= GEMV_MAX_ROWS:
        return "gemv", plan_gemv(m, n, k, torch.finfo(dtype).bits // 8)
    if dtype == torch.bfloat16:
        return "mma_bf16", plan_gemm_bf16(m, n, k)
    if tensor_cores:
        return "mma_tf32x3", plan_gemm_tc(m, n, k)
    return "sgemm", plan_gemm(m, n, k)


def describe_plan(m: int, n: int, k: int, tensor_cores: bool = False,
                  dtype: torch.dtype = torch.float32) -> dict:
    """The route and plan of an (m, k) @ (k, n) call, for reports: K4's
    (the GEMV, the SIMT SGEMM in f32, the bf16 tensor cores in bf16) or,
    with ``tensor_cores``, K5's (the GEMV, 3xTF32)."""
    route, plan = _route(m, n, k, tensor_cores, dtype)
    return {"route": route, **plan.report()}


# the GEMV's and the bf16 route's split scratch: device -> (partials,
# counters); the counters start at zero and each launch leaves them so
_SCRATCH: dict = {}


def _split_scratch(plan: GemmPlan, device) -> tuple:
    """(partials, counters) for a plan summed in its launch, None for one
    split: splits x tiles x (bm bn, rounded up to a block's 256 threads)
    floats, a counter a tile; grown, never shrunk."""
    if plan.splits == 1:
        return None, None
    floats = plan.splits * plan.tiles * -(-plan.bm * plan.bn // 256) * 256
    part, count = _SCRATCH.get(device, (None, None))
    if part is None or part.numel() < floats or count.numel() < plan.tiles:
        # a CUDA graph records the zeroing without running it
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the K4 split scratch grows: make the first "
                               "call of this shape outside graph capture")
        if part is None or part.numel() < floats:
            part = torch.empty(floats, dtype=torch.float32, device=device)
        if count is None or count.numel() < plan.tiles:
            count = torch.zeros(max(plan.tiles, 4096), dtype=torch.int32,
                                device=device)
        _SCRATCH[device] = (part, count)
    return part, count


def _launch_args(m: int, n: int, k: int, device, tensor_cores: bool,
                 dtype: torch.dtype) -> tuple:
    """(partials, counters, bm, bn, splits, depth) for the C entry: the
    GEMV and the bf16 route take the device's scratch, the SGEMM and
    3xTF32 routes an (S, M, N) workspace of their own."""
    route, p = _route(m, n, k, tensor_cores, dtype)
    if route in ("gemv", "mma_bf16"):
        part, count = _split_scratch(p, device)
    else:
        count = None
        part = torch.empty((p.splits, m, n), dtype=torch.float32,
                           device=device) if p.splits > 1 else None
    return part, count, p.bm, p.bn, p.splits, p.depth


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _split_product(x2: torch.Tensor, w: torch.Tensor,
                   tensor_cores: bool = False,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x2 @ w (both f32) as the kernel's route sums it for operands of
    ``dtype``: one partial product per range of the route's plan (3xTF32
    on K5's tensor-core route), added in range order."""
    m, k = x2.shape
    route, plan = _route(m, w.shape[1], k, tensor_cores, dtype)
    product = tf32x3.matmul if route == "mma_tf32x3" else torch.matmul
    return split_sum(lambda k0, k1: product(x2[:, k0:k1], w[k0:k1]), k,
                     plan.depth)


def batched_lora_apply_split_plain(x: torch.Tensor, w: torch.Tensor,
                                   a_pages: torch.Tensor,
                                   b_pages: torch.Tensor,
                                   scales: torch.Tensor,
                                   ids: torch.Tensor) -> torch.Tensor:
    """``batched_lora_apply_plain`` with the base product split over K as
    the kernel's route for x's rows and dtype splits it (``plan_gemv`` at
    most ``GEMV_MAX_ROWS`` rows, else ``plan_gemm`` in f32 and
    ``plan_gemm_bf16`` in bf16); (..., N) f32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    idf = page_index(ids.reshape(-1), a_pages.shape[0])
    z = torch.einsum("mk,mrk->mr", x2, a_pages.float()[idf])
    s = scales.float()[idf]
    y = _split_product(x2, w.float(), dtype=x.dtype) + torch.einsum(
        "mr,mnr->mn", s[:, None] * z, b_pages.float()[idf])
    return y.reshape(lead + (w.shape[-1],))


def lora_apply_tf32x3_plain(x: torch.Tensor, w: torch.Tensor,
                            a: torch.Tensor, b: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """K5's routes in PyTorch: above ``GEMV_MAX_ROWS`` rows the base product
    split over K as ``plan_gemm_tc`` splits it, each partial from the three
    TF32 passes (``tf32x3.matmul``); at most that many, the GEMV's IEEE f32
    products split as ``plan_gemv`` splits it; then the shrink and expand
    in IEEE f32; (M, N) f32."""
    xf = x.float()
    z = xf @ a.float().T
    return _split_product(xf, w.float(), tensor_cores=True) + \
        (scale * z) @ b.float().T


# K4's operand dtypes: x, w and the pages all of one of them
OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, t: torch.Tensor, ndim: int, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def _check_pages(name: str, t: torch.Tensor, dtype) -> None:
    """Each page contiguous; the page axis may be strided (a per-layer
    slice of a stacked adapter tree)."""
    _check(name, t, 3, dtype)
    if t.shape[1] * t.shape[2] and t.stride()[1:] != (t.shape[2], 1):
        raise ValueError(f"{name}: every page must be contiguous")


def batched_lora_apply(x: torch.Tensor, w: torch.Tensor,
                       a_pages: torch.Tensor, b_pages: torch.Tensor,
                       scales: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """K4: x (..., K) contiguous; w (K, N) contiguous; a_pages (P, r, K);
    b_pages (P, N, r); scales (P,) f32; ids (...) int32 page index per row,
    taken as ``page_index`` takes it -> (..., N) in x's dtype. x, w and the
    pages are all f32 or all bf16 (``OPERAND_DTYPES``); bf16 operands are
    read as bf16, every product and sum runs in f32 and y is rounded once
    (the reference's Pallas body)."""
    if x.dtype not in OPERAND_DTYPES:
        raise TypeError(f"batched_lora_apply x: expected one of "
                        f"{OPERAND_DTYPES}, got {x.dtype}")
    _check("batched_lora_apply x", x, x.ndim, x.dtype)
    _check("batched_lora_apply w", w, 2, x.dtype)
    _check_pages("batched_lora_apply a_pages", a_pages, x.dtype)
    _check_pages("batched_lora_apply b_pages", b_pages, x.dtype)
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
    if p == 0 and ids.numel():
        raise ValueError("batched_lora_apply: rows but no adapter page")
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
    y = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    z = torch.empty((m, r), dtype=torch.float32, device=x.device)
    part, count, *plan = _launch_args(m, n, k, x.device, False, x.dtype)
    fn = ("batched_lora_apply_bf16" if x.dtype == torch.bfloat16
          else "batched_lora_apply_f32")
    rc = getattr(build.library("lora_apply"), fn)(
        x.data_ptr(), w.data_ptr(), a_pages.data_ptr(), b_pages.data_ptr(),
        scales.data_ptr(), ids.data_ptr(), z.data_ptr(), y.data_ptr(),
        _ptr(part), _ptr(count), m, k, n, r, p, a_pages.stride(0),
        b_pages.stride(0), *plan, _stream(x))
    build.check(rc, fn)
    batched_lora_apply.launches += 1
    if x.dtype == torch.bfloat16:
        batched_lora_apply.launches_bf16 += 1
    return y


def lora_apply(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """K5: x (M, K); w (K, N); a (r, K); b (N, r), all f32 contiguous;
    ``scale`` a Python number -> (M, N) f32. Above ``GEMV_MAX_ROWS`` rows
    x @ W runs as 3xTF32 on the tensor cores (``plan_gemm_tc``)."""
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
    part, count, *plan = _launch_args(m, n, k, x.device, True,
                                      torch.float32)
    fn = "lora_apply_f32"
    rc = getattr(build.library("lora_apply"), fn)(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), z.data_ptr(),
        y.data_ptr(), _ptr(part), _ptr(count), m, k, n, r, float(scale),
        *plan, _stream(x))
    build.check(rc, fn)
    lora_apply.launches += 1
    return y


KERNELS = (batched_lora_apply, lora_apply)
for _k in KERNELS:
    _k.launches = 0
batched_lora_apply.launches_bf16 = 0     # of those launches, the bf16 ones
