"""The port's kernel API, with the wrapper semantics of
``repro/kernels/ops.py``: every TPU kernel reached from there is reached
from here too, on the port's hand-written CUDA kernels (each wrapper
computes its plain PyTorch version for CPU tensors). Not yet here: the
reference's ``factored_stack_lead`` / ``factored_gram_lead`` of the
sharded engine (ROADMAP.md queue 1 item 9). The factored stack entries
take transport-quantized factors (``QuantFactor``: int8 or bf16 payload
and f32 per-column scales) as well as plain tensors: ``dequantize`` turns
them into f32 with one elementwise op before K1, as the reference does
outside its Pallas grids. ``dequantize`` is the port's one decoder of that
layout; aggregation and the transport import it from here.

* the fused factored aggregation (DESIGN.md §4.3) that the kernel
  backend's round path runs: ``factored_stack_layered`` (K1),
  ``factored_gram_layered`` (K2), ``factored_stack_gram_layered`` for a
  shape bucket, and ``factored_stack_gram`` for one adapter (the same
  kernels at L = 1);
* the dense aggregate ``rank_partition_agg`` / ``..._layered`` (K3);
* the fused LoRA applies: single-adapter ``lora_apply`` (K5) and the paged
  multi-adapter ``batched_lora_apply`` of the serving engine (K4);
* the SSD chunked scan of mamba2's prefill ``ssd_scan`` (K6);
* online-softmax attention ``flash_attention`` (K7), which masks on the
  true Lkv and pads nothing, where the reference's wrapper pads Lkv and
  lets the padded keys into a bidirectional softmax (ROADMAP.md queue 3).

For the aggregation: the Eq. 8 empty-partition fallback enters as one extra
"client" whose omega row is the fallback indicator; client ranks are
zero-padded to a multiple of 8 (zero columns change nothing) so
R = M' * r8. Every kernel handles ragged extents itself (d, n, M, K, N,
Lq, Lkv), so nothing else is padded and nothing needs slicing back; inputs
of another float dtype are read as f32, and each entry returns the
reference's output dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.svd import check_fallback_globals
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import rank_partition_agg as rpa
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.lora_apply import batched_lora_apply  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.rank_partition_agg import (gram_left, gram_right,
                                                    weighted_stack_a,
                                                    weighted_stack_b)

# every kernel wrapper of the port, each with its ``launches`` count
KERNELS = (rpa.KERNELS + rpa.DENSE_KERNELS + la.KERNELS + (ssd_scan,)
           + fa.KERNELS)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult``; always contiguous."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x.contiguous()
    widths = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards
    widths[2 * (x.ndim - 1 - (axis % x.ndim)) + 1] = pad
    return F.pad(x, widths)


def is_quantized(x) -> bool:
    """True for a transport ``QuantFactor`` (duck-typed: ``kernels`` never
    imports ``federation``)."""
    return hasattr(x, "q") and hasattr(x, "scale")


def dequantize(x):
    """A ``QuantFactor`` -> f32 payload * scale, one elementwise op; plain
    tensors pass through untouched. The kernels themselves stay
    layout-agnostic."""
    if is_quantized(x):
        return x.q.float() * x.scale
    return x


def _append_fallback_client(bs, as_, omega, global_b, global_a, fallback,
                            *, layer_axes: int):
    """Concatenate the global factors as client M+1 carrying ``fallback``.
    ``layer_axes`` leading axes precede the client axis."""
    check_fallback_globals(fallback, global_b, global_a)
    if fallback is None:
        return bs, as_, omega
    ax = layer_axes
    bs = torch.cat([bs, global_b.unsqueeze(ax).to(bs.dtype)], dim=ax)
    as_ = torch.cat([as_, global_a.unsqueeze(ax).to(as_.dtype)], dim=ax)
    omega = torch.cat([omega, fallback[None].to(omega.dtype)], dim=0)
    return bs, as_, omega


def factored_stack_layered(bs: torch.Tensor, as_: torch.Tensor,
                           omega: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bs (L, M, d, r); as_ (L, M, r, n); omega (M, r) ->
    U_c (L, d, M*r8), V_c (L, M*r8, n) f32 (K1)."""
    bsp = _pad_to(bs.float(), 3, 8)
    asp = _pad_to(as_.float(), 2, 8)
    omp = _pad_to(omega.float(), 1, 8)
    return weighted_stack_b(bsp, omp), weighted_stack_a(asp, omp)


def factored_gram_layered(u_c: torch.Tensor, v_c: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u_c (L, d, R); v_c (L, R, n) -> Gram cores (L, R, R) x2 (K2). R is
    padded to 8 and sliced back to the incoming width."""
    rr = u_c.shape[-1]
    g_u = gram_left(_pad_to(u_c, 2, 8))
    g_v = gram_right(_pad_to(v_c, 1, 8))
    return g_u[:, :rr, :rr], g_v[:, :rr, :rr]


def factored_stack_gram_layered(bs: torch.Tensor, as_: torch.Tensor,
                                omega: torch.Tensor,
                                global_b: Optional[torch.Tensor] = None,
                                global_a: Optional[torch.Tensor] = None,
                                fallback: Optional[torch.Tensor] = None):
    """The whole fused front half for one shape bucket: (u_c, v_c, g_u,
    g_v) for ``svd_realloc_gram``. bs (L, M, d, r); as_ (L, M, r, n);
    omega (M, r) shared across layers; global factors (L, d, r)/(L, r, n)."""
    bs, as_ = dequantize(bs), dequantize(as_)
    bs, as_, omega = _append_fallback_client(bs, as_, omega, global_b,
                                             global_a, fallback,
                                             layer_axes=1)
    u_c, v_c = factored_stack_layered(bs, as_, omega)
    g_u, g_v = factored_gram_layered(u_c, v_c)
    return u_c, v_c, g_u, g_v


def factored_stack_gram(bs: torch.Tensor, as_: torch.Tensor,
                        omega: torch.Tensor,
                        global_b: Optional[torch.Tensor] = None,
                        global_a: Optional[torch.Tensor] = None,
                        fallback: Optional[torch.Tensor] = None):
    """The fused front half for ONE adapter: (u_c, v_c, g_u, g_v) for
    ``svd_realloc_gram``. bs (M, d, r); as_ (M, r, n); omega (M, r);
    optional global factors (d, r) / (r, n) enter as one extra client
    carrying the Eq. 8 fallback. K1 and K2 at L = 1."""
    bs, as_ = dequantize(bs), dequantize(as_)
    bs, as_, omega = _append_fallback_client(bs, as_, omega, global_b,
                                             global_a, fallback,
                                             layer_axes=0)
    u_c, v_c = factored_stack_layered(bs[None], as_[None], omega)
    g_u, g_v = factored_gram_layered(u_c, v_c)
    return u_c[0], v_c[0], g_u[0], g_v[0]


def rank_partition_agg(bs: torch.Tensor, as_: torch.Tensor,
                       omega: torch.Tensor,
                       global_b: Optional[torch.Tensor] = None,
                       global_a: Optional[torch.Tensor] = None,
                       fallback: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """dW = sum_m B_m diag(omega_m) A_m (+ the fallback global slices), K3.
    bs (M, d, r); as_ (M, r, n); omega (M, r); optional global factors
    (d, r) / (r, n) enter as one extra client. Returns (d, n) f32."""
    bs, as_, omega = _append_fallback_client(bs, as_, omega, global_b,
                                             global_a, fallback,
                                             layer_axes=0)
    return rpa.rank_partition_agg(_pad_to(bs.float(), 2, 8),
                                  _pad_to(as_.float(), 1, 8),
                                  _pad_to(omega.float(), 1, 8))


def rank_partition_agg_layered(bs: torch.Tensor, as_: torch.Tensor,
                               omega: torch.Tensor,
                               global_b: Optional[torch.Tensor] = None,
                               global_a: Optional[torch.Tensor] = None,
                               fallback: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Layer-batched dW, one launch per bucket (K3). bs (L, M, d, r); as_
    (L, M, r, n); omega (M, r) shared by all layers; global factors
    (L, d, r) / (L, r, n). Returns (L, d, n) f32."""
    bs, as_, omega = _append_fallback_client(bs, as_, omega, global_b,
                                             global_a, fallback,
                                             layer_axes=1)
    return rpa.rank_partition_agg_layered(_pad_to(bs.float(), 3, 8),
                                          _pad_to(as_.float(), 2, 8),
                                          _pad_to(omega.float(), 1, 8))


def lora_apply(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Fused y = x @ w + scale * (x @ a.T) @ b.T (K5); x (..., K), w (K, N),
    a (r, K), b (N, r). Returns (..., N) in x.dtype."""
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    y = la.lora_apply(x.reshape(-1, k).float().contiguous(),
                      w.float().contiguous(), _pad_to(a.float(), 0, 8),
                      _pad_to(b.float(), 1, 8), scale)
    return y.reshape(lead + (n,)).to(x.dtype)
