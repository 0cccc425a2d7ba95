"""Mamba-2 SSD chunked scan K6 (the dual form, arXiv:2405.21060), ported
from ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` and its wrapper
``repro/kernels/ops.py::ssd_scan``.

``ssd_scan_plain`` is the plain PyTorch version, a port of the reference's
``models/layers/ssd.py::ssd_scan_chunked``: per chunk, the intra-chunk
(C B^T masked by the causal decay) product, the carried state's term, the
state update and the D skip, in f32. The wrapper ``ssd_scan`` computes it
for CPU tensors and launches the CUDA kernel (``csrc/ssd_scan.cu``) for
CUDA tensors, with no fallback: a failed build or launch raises.
``ssd_scan.launches`` counts kernel launches and nothing else. The kernel
has no backward (SSM training through K6 is not ported), so the wrapper
refuses inputs that need a gradient.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rank_partition_agg import _same_device, _stream

MAX_SLICE = 64               # state rows P one block owns (kMaxPS in the .cu)


def _expand_groups(t: torch.Tensor, nheads: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N), head h reading group h // (H / G)."""
    return torch.repeat_interleave(t, nheads // t.shape[-2], dim=-2)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                   chunk: int, init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, L, H, P); dt (B, L, H) post-softplus; a_log (H,); b, c
    (B, L, G, N); d_skip (H,); init_state (B, H, P, N) or None. Returns
    (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32)."""
    bsz, length, nheads, hp = x.shape
    groups, n = b.shape[-2:]
    chunk = _chunk(chunk, length)
    nc = length // chunk
    a_neg = -torch.exp(a_log.float())                            # (H,) < 0

    xf = x.float().reshape(bsz, nc, chunk, nheads, hp)
    dtf = dt.float().reshape(bsz, nc, chunk, nheads)
    bh = _expand_groups(b.float().reshape(bsz, nc, chunk, groups, n), nheads)
    ch = _expand_groups(c.float().reshape(bsz, nc, chunk, groups, n), nheads)
    cum = torch.cumsum(dtf * a_neg, dim=2)                       # inclusive
    dtx = xf * dtf[..., None]                                    # dt folded in
    state = (torch.zeros((bsz, nheads, hp, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    ys = []
    for ci in range(nc):
        dtxq, cq, bq, cumq = dtx[:, ci], ch[:, ci], bh[:, ci], cum[:, ci]
        # mask BEFORE exp: the masked differences are positive
        diff = cumq[:, :, None, :] - cumq[:, None, :, :]         # (B,Q,Q,H)
        lmat = torch.exp(torch.where(causal, diff,
                                     torch.full_like(diff, -1e30)))
        cb = torch.einsum("bihn,bjhn->bijh", cq, bq)
        y_intra = torch.einsum("bijh,bjhp->bihp", cb * lmat, dtxq)
        decay_in = torch.exp(cumq)                               # (B,Q,H)
        y_inter = torch.einsum("bqhn,bhpn,bqh->bqhp", cq, state, decay_in)
        decay_out = torch.exp(cumq[:, -1:, :] - cumq)
        new_contrib = torch.einsum("bqhn,bqhp,bqh->bhpn", bq, dtxq,
                                   decay_out)
        chunk_decay = torch.exp(cumq[:, -1, :])                  # (B,H)
        state = state * chunk_decay[..., None, None] + new_contrib
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, length, nheads, hp)
    y = y + xf.reshape(bsz, length, nheads, hp) \
        * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def _chunk(chunk: int, length: int) -> int:
    """The reference's ``chunk = min(chunk, L)``; L must be a multiple."""
    chunk = min(int(chunk), length)
    if chunk <= 0 or length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the SSD chunk {chunk}")
    return chunk


def _splits(bsz: int, nheads: int, hp: int, device: torch.device) -> int:
    """P-slices per (b, h): enough to keep every slice within 64 state
    rows, then doubled while the grid has fewer blocks than the card has
    SMs and a slice keeps at least 16 rows (each slice recomputes its
    chunk's C B^T, so splitting pays only on a card left part idle)."""
    splits = math.ceil(hp / MAX_SLICE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    while bsz * nheads * splits < sms and math.ceil(hp / (2 * splits)) >= 16:
        splits *= 2
    return splits


def _check_shapes(x, dt, a_log, b, c, d_skip, init_state) -> None:
    if x.ndim != 4 or b.ndim != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} and b "
                         f"{tuple(b.shape)} must be 4-D")
    bsz, length, nheads, hp = x.shape
    groups, n = b.shape[-2:]
    want = {"dt": ((bsz, length, nheads), dt),
            "b": ((bsz, length, groups, n), b),
            "c": ((bsz, length, groups, n), c),
            "a_log": ((nheads,), a_log), "d_skip": ((nheads,), d_skip)}
    if init_state is not None:
        want["init_state"] = ((bsz, nheads, hp, n), init_state)
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_scan {name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
        _same_device(x, t, "ssd_scan")
    if nheads % groups:
        raise ValueError(f"ssd_scan: {nheads} heads do not split into "
                         f"{groups} groups")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
             chunk: int, init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 with the reference's contract (``ops.ssd_scan``): shapes as in
    ``ssd_scan_plain``; ``chunk = min(chunk, L)`` and L must be a multiple
    of it. On the card the inputs are read as f32 (the reference computes
    in f32 whatever x's dtype), y comes back in x's dtype and the final
    state in f32."""
    _check_shapes(x, dt, a_log, b, c, d_skip, init_state)
    bsz, length, nheads, hp = x.shape
    groups, n = b.shape[-2:]
    chunk = _chunk(chunk, length)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a_log, b, c, d_skip, init_state)):
        raise NotImplementedError(
            "ssd_scan has no backward (serving only; SSM training through "
            "K6 is ROADMAP.md queue 2)")
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a_log, b, c, d_skip, chunk, init_state)
    lib = build.library("ssd_scan")
    args = [t.float().contiguous() for t in (x, dt, a_log, b, c, d_skip)]
    init = (None if init_state is None
            else init_state.float().contiguous())
    y = torch.empty((bsz, length, nheads, hp), dtype=torch.float32,
                    device=x.device)
    final = torch.empty((bsz, nheads, hp, n), dtype=torch.float32,
                        device=x.device)
    fn = "ssd_scan_f32"
    rc = getattr(lib, fn)(
        *(t.data_ptr() for t in args),
        None if init is None else init.data_ptr(), y.data_ptr(),
        final.data_ptr(), bsz, length, nheads, hp, groups, n, chunk,
        _splits(bsz, nheads, hp, x.device), _stream(x))
    build.check(rc, fn)
    ssd_scan.launches += 1
    return y.to(x.dtype), final


ssd_scan.launches = 0
