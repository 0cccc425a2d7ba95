"""Public wrappers of the port's kernels: the fused factored aggregation
(DESIGN.md §4.3) that the kernel backend's round path runs, and the paged
multi-adapter LoRA apply of the serving engine (``batched_lora_apply``,
K4), the subset of ``repro/kernels/ops.py`` that the port runs.

For the aggregation: the Eq. 8 empty-partition fallback enters as one extra "client" whose
omega row is the fallback indicator; client ranks are zero-padded to a
multiple of 8 (zero columns are spectrum-inert) so R = M' * r8. The
kernels handle ragged d / n extents themselves, so nothing else is padded.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.svd import check_fallback_globals
from repro_torch.kernels import lora_apply, rank_partition_agg
from repro_torch.kernels.lora_apply import batched_lora_apply  # noqa: F401
from repro_torch.kernels.rank_partition_agg import (gram_left, gram_right,
                                                    weighted_stack_a,
                                                    weighted_stack_b)

# every kernel wrapper of the port, each with its ``launches`` count
KERNELS = rank_partition_agg.KERNELS + lora_apply.KERNELS


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
    bs, as_, omega = _append_fallback_client(bs, as_, omega, global_b,
                                             global_a, fallback,
                                             layer_axes=1)
    u_c, v_c = factored_stack_layered(bs, as_, omega)
    g_u, g_v = factored_gram_layered(u_c, v_c)
    return u_c, v_c, g_u, g_v
