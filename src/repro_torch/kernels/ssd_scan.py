"""Mamba-2 SSD chunked scan K6 (the dual form, arXiv:2405.21060), ported
from ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` and its wrapper
``repro/kernels/ops.py::ssd_scan``.

``ssd_scan_plain`` is the plain PyTorch version, a port of the reference's
``models/layers/ssd.py::ssd_scan_chunked``: per chunk, in order, the
intra-chunk (C B^T masked by the causal decay) product, the carried
state's term, the state update and the D skip, in f32.

The kernel (``csrc/ssd_scan.cu``) computes the same function with the
chunks in parallel, as ``ssd_scan_parallel_plain`` writes it out: C B^T
once per (batch, chunk, group), shared by the group's heads; every
chunk's local state dS_c at once; an in-order pass over the chunks,
S_{c+1} = exp(cum_last) S_c + dS_c; then every chunk's output at once.
Its four products run as 3xTF32 on the tensor cores (f32 accuracy);
``ssd_scan_tf32x3_plain`` repeats that arithmetic on the CPU.
``plan_scan`` is the kernel's host plan: its four launches, their blocks
and the scratch they share.

The wrapper ``ssd_scan`` computes the plain version for CPU tensors and
launches the kernel for CUDA tensors, with no fallback: a failed build or
launch raises. ``ssd_scan.launches`` counts the wrapper's calls that ran
on the card (one a layer's prefill scan), whatever the number of CUDA
launches a call makes (``ScanPlan.launches``), and nothing else. The
kernel has no backward (SSM training through K6 is not ported), so the
wrapper refuses inputs that need a gradient.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, tf32x3
from repro_torch.kernels.rank_partition_agg import _same_device, _stream

# the tiles of csrc/ssd_scan.cu
MAX_SLICE = 64       # state rows P a block owns (kMaxPS)
MAX_STATE = 128      # state width N (kMaxN)
CB_TILE = 64         # C B^T tile of the first launch (kCB)
OUT_ROWS = 128       # chunk rows an output block owns: 4 warps x 32 (kOutRows)
CARRY_THREADS = 256  # threads a block of the carry pass (kCarryThreads)
P_WIDTHS = (16, 32, 64)         # output kernel instances: slice width
N_WIDTHS = (16, 32, 64, 128)    # state kernel instances: state width


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


def _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk, init_state,
                         matmul: Callable, dtype=torch.float32):
    """The kernel's decomposition with ``matmul`` for its four products
    (C B^T, the states, the intra-chunk term, the readout, in that order),
    computed in ``dtype``. Heads are viewed as (G, H / G), so a group's
    C B^T is computed once and broadcast to its heads, never expanded."""
    bsz, length, nheads, hp = x.shape
    groups, n = b.shape[-2:]
    chunk = _chunk(chunk, length)
    nc, rep = length // chunk, nheads // groups
    a_neg = -torch.exp(a_log.to(dtype))
    # heads last-but-one as (G, rep): (B, nc, G, rep, Q, ...)
    xf = x.to(dtype).reshape(bsz, nc, chunk, groups, rep, hp) \
        .permute(0, 1, 3, 4, 2, 5)                               # (.., Q, P)
    dtf = dt.to(dtype).reshape(bsz, nc, chunk, groups, rep) \
        .permute(0, 1, 3, 4, 2)                                  # (.., Q)
    bf = b.to(dtype).reshape(bsz, nc, chunk, groups, n).permute(0, 1, 3, 2, 4)
    cf = c.to(dtype).reshape(bsz, nc, chunk, groups, n).permute(0, 1, 3, 2, 4)
    cum = torch.cumsum(dtf * a_neg.reshape(groups, rep)[..., None], dim=-1)
    last = cum[..., -1:]
    # C B^T once per (batch, chunk, group): (B, nc, G, 1, Q, Q)
    cb = matmul(cf, bf.mT)[:, :, :, None]
    # (a) chunk-local states dS = sum_q (x_q w_q) B_q^T, w_q = dt_q
    # exp(cum_last - cum_q): (B, nc, G, rep, P, N)
    w = dtf * torch.exp(last - cum)
    ds = matmul((xf * w[..., None]).mT, bf[:, :, :, None])
    # (b) the carry, in order: S_0 = init, S_{c+1} = exp(cum_last) S_c + dS_c
    state = (torch.zeros((bsz, groups, rep, hp, n), dtype=dtype,
                         device=x.device) if init_state is None else
             init_state.to(dtype).reshape(bsz, groups, rep, hp, n))
    decay = torch.exp(last[..., 0])                          # (B, nc, G, rep)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = state * decay[:, ci, ..., None, None] + ds[:, ci]
    s_in = torch.stack(entering, dim=1)          # (B, nc, G, rep, P, N)
    # (c) outputs: (C B^T o L dt) x + (C exp(cum)) S^T + D x, masked
    # before exp
    idx = torch.arange(chunk, device=x.device)
    causal = idx[:, None] >= idx[None, :]
    diff = cum[..., :, None] - cum[..., None, :]
    lmat = torch.exp(torch.where(causal, diff, torch.full_like(diff, -1e30)))
    intra = torch.where(causal, cb * lmat * dtf[..., None, :], 0.0)
    readout = cf[:, :, :, None] * torch.exp(cum)[..., None]
    y = matmul(intra, xf) + matmul(readout, s_in.mT)
    y = y + xf * d_skip.to(dtype).reshape(groups, rep)[..., None, None]
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(bsz, length, nheads, hp)
    out = x.dtype if dtype == torch.float32 else dtype
    return y.to(out), state.reshape(bsz, nheads, hp, n)


def ssd_scan_parallel_plain(x, dt, a_log, b, c, d_skip, chunk,
                            init_state=None):
    """The chunk-parallel form of ``ssd_scan_plain`` (the kernel's
    decomposition) with IEEE f32 products."""
    return _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk,
                                init_state, torch.matmul)


def ssd_scan_tf32x3_plain(x, dt, a_log, b, c, d_skip, chunk,
                          init_state=None):
    """The kernel's arithmetic on the CPU: the chunk-parallel form with its
    four products from the three TF32 passes (``tf32x3.matmul``), the
    operands scaled as the kernel scales them (dt and the decay on C B^T,
    exp(cum) on C, dt exp(cum_last - cum) on x)."""
    return _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk,
                                init_state, tf32x3.matmul)


def ssd_scan_f64(x, dt, a_log, b, c, d_skip, chunk, init_state=None):
    """The scan in float64 (y and the state f64): the yardstick of the
    kernel's precision."""
    return _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk,
                                init_state, torch.matmul, torch.float64)


def ssd_scan_one_pass_tf32(x, dt, a_log, b, c, d_skip, chunk,
                           init_state=None):
    """The control that one TF32 pass fails: the chunk-parallel form with
    each of its four products at its most accurate in one TF32 pass
    (``tf32x3.one_pass_matmul``: TF32 operands, sums in f64)."""
    return _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk,
                                init_state, tf32x3.one_pass_matmul,
                                torch.float64)


def one_pass_bound(x, dt, a_log, b, c, d_skip, chunk,
                   init_state=None) -> torch.Tensor:
    """The yardstick that tells f32 accuracy from one TF32 pass, per output
    of y (B, L, H, P), f64: the standard deviation of a one-pass TF32 run's
    error there (``tf32x3.one_pass_sigma``'s formula over the two products
    that make y, the intra-chunk term and the readout, with their operands
    from a float64 run) plus the worst-case rounding of an f32 run,
    (Q + N + 1) eps (the products' summed |terms| + |D x|), which is all
    that bounds an output whose skip term D x outweighs its products. An
    f32-accurate scan stays inside it at every output; a one-pass TF32
    scan's error leaves it."""
    ops = []

    def record(a, b_):
        ops.append((a, b_))
        return a @ b_
    _scan_chunk_parallel(x, dt, a_log, b, c, d_skip, chunk, init_state,
                         record, torch.float64)
    var = sum(a.square() @ b_.square() for a, b_ in ops[2:])
    mag = sum(a.abs() @ b_.abs() for a, b_ in ops[2:])
    bsz, length, nheads, hp = x.shape
    depth = _chunk(chunk, length) + b.shape[-1] + 1
    skip = (x.double() * d_skip.double()[:, None]).abs()
    sigma = 2.0 ** -11 * (2.0 / 3.0) ** 0.5 * var.sqrt()
    bound = (sigma + depth * 2.0 ** -24 * mag).permute(0, 1, 4, 2, 3, 5)
    return bound.reshape(bsz, length, nheads, hp) + depth * 2.0 ** -24 * skip


def _chunk(chunk: int, length: int) -> int:
    """The reference's ``chunk = min(chunk, L)``; L must be a multiple."""
    chunk = min(int(chunk), length)
    if chunk <= 0 or length % chunk:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the SSD chunk {chunk}")
    return chunk


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up4(n: int) -> int:
    return _cdiv(n, 4) * 4


class ScanPlan(NamedTuple):
    """The kernel's four launches for one call: C B^T tiles (``cb``), the
    chunk-local states (``state``, which also writes the cumsums), the
    carry over the chunks (``carry``) and the outputs (``out``); the P
    slices a (batch, chunk, head) is cut into, and the instances' widths.
    The scratch holds C B^T, the cumsums and the states, in that order."""
    chunks: int
    chunk: int
    slices: int
    slice_rows: int
    n_width: int             # the state kernel's instance (state width)
    p_width: int             # the output kernel's instance (slice width)
    cb_blocks: int
    state_blocks: int
    carry_blocks: int
    out_blocks: int
    scratch_floats: int
    flop: float              # products the four launches compute

    @property
    def launches(self) -> int:
        return 4

    def report(self) -> dict:
        return {"route": "mma_tf32x3", "launches": self.launches,
                "blocks": {"cb": self.cb_blocks, "state": self.state_blocks,
                           "carry": self.carry_blocks,
                           "out": self.out_blocks},
                "chunks": self.chunks, "slices": self.slices,
                "slice_rows": self.slice_rows, "n_width": self.n_width,
                "p_width": self.p_width,
                "scratch_mb": self.scratch_floats * 4 / 1e6,
                "flop": self.flop}


@functools.lru_cache(maxsize=256)    # the wrapper plans every call
def plan_scan(bsz: int, length: int, nheads: int, hp: int, groups: int,
              n: int, chunk: int) -> ScanPlan:
    """The plan of ``csrc/ssd_scan.cu`` for x (bsz, length, nheads, hp) and
    b, c (bsz, length, groups, n), chunks of ``chunk`` (already min(chunk,
    L)). P is cut into the fewest slices of at most 64 rows; C B^T into
    64 x 64 tiles on and below the diagonal; the outputs into 128-row
    tiles of a chunk. ``flop`` counts the products computed: C B^T's causal
    half (with the diagonal) a group, and per head the state's B^T (dt x),
    the readout C S and the causal (C B^T o L) (dt x)."""
    if n > MAX_STATE:
        raise ValueError(f"ssd_scan: state width {n} > {MAX_STATE}")
    nc = length // chunk
    slices = _cdiv(hp, MAX_SLICE)
    ps = _cdiv(hp, slices)
    tiles = _cdiv(chunk, CB_TILE)
    qp = tiles * CB_TILE
    jobs = bsz * nc * nheads
    scratch = (_up4(bsz * nc * groups * qp * qp) + _up4(jobs * chunk)
               + _up4(jobs * hp * n))
    causal = chunk * (chunk + 1) / 2
    flop = 2.0 * (bsz * nc * groups * causal * n
                  + jobs * (2 * chunk * hp * n + causal * hp))
    return ScanPlan(
        chunks=nc, chunk=chunk, slices=slices, slice_rows=ps,
        n_width=next(w for w in N_WIDTHS if n <= w),
        p_width=next(w for w in P_WIDTHS if ps <= w),
        cb_blocks=bsz * nc * groups * tiles * (tiles + 1) // 2,
        state_blocks=jobs * slices,
        carry_blocks=_cdiv(bsz * nheads * hp * n // (4 if hp * n % 4 == 0
                                                     else 1), CARRY_THREADS),
        out_blocks=jobs * slices * _cdiv(chunk, OUT_ROWS),
        scratch_floats=scratch, flop=flop)


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
    plan = plan_scan(bsz, length, nheads, hp, groups, n, chunk)
    lib = build.library("ssd_scan")
    args = [t.float().contiguous() for t in (x, dt, a_log, b, c, d_skip)]
    init = (None if init_state is None
            else init_state.float().contiguous())
    y = torch.empty((bsz, length, nheads, hp), dtype=torch.float32,
                    device=x.device)
    final = torch.empty((bsz, nheads, hp, n), dtype=torch.float32,
                        device=x.device)
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=x.device)
    fn = "ssd_scan_f32"
    rc = getattr(lib, fn)(
        *(t.data_ptr() for t in args),
        None if init is None else init.data_ptr(), y.data_ptr(),
        final.data_ptr(), scratch.data_ptr(), plan.scratch_floats, bsz,
        length, nheads, hp, groups, n, chunk, plan.slices, _stream(x))
    build.check(rc, fn)
    ssd_scan.launches += 1
    return y.to(x.dtype), final


ssd_scan.launches = 0
