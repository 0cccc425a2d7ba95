"""Rank-partitioned aggregation kernels K1, K2 (the fused factored path,
DESIGN.md §4.3) and K3 (the dense aggregate), ported from
``repro/kernels/rank_partition_agg.py``.

The aggregate sum_m B_m diag(omega_m) A_m is always U_c @ V_c with U_c
(d, M r) the sqrt(omega)-weighted client B columns and V_c (M r, n) the
matching A rows, so the round never forms the (d, n) update:

* K1 ``weighted_stack_b`` / ``weighted_stack_a`` build U_c / V_c
  (``csrc/weighted_stack.cu``; replaces ``weighted_stack_b_layered_pallas``
  and ``weighted_stack_a_layered_pallas``);
* K2 ``gram_left`` / ``gram_right`` build their (R, R) Gram cores
  G_u = U_c^T U_c and G_v = V_c V_c^T (``csrc/gram.cu``; replaces
  ``gram_left_layered_pallas`` and ``gram_right_layered_pallas``).

K3 ``rank_partition_agg`` / ``rank_partition_agg_layered`` form dW itself
(``csrc/rank_partition_agg.cu``; replaces ``rank_partition_agg_pallas``
and ``rank_partition_agg_layered_pallas``). No round path calls it, in the
reference either: it is reached through the kernel API ``ops``.

K2 and K3 run the SGEMM mainloop of ``csrc/sgemm_f32.cuh`` on the plans
of ``gemm_plan.py`` (tile, and a split of the depth where the tiles alone
do not fill the card); ``*_split_plain`` repeat that arithmetic in
PyTorch: the depth cut as the plan cuts it, one partial product a range,
the partials summed in range order, and for K3 the 16-deep slabs whose
weights are all zero left out, as the kernel leaves them out.

Each kernel has a plain PyTorch version here (``*_plain``) and a wrapper.
The wrapper checks its inputs and allocates the output; for a CPU tensor
it computes the plain version, for a CUDA tensor it launches the kernel
(there is no fallback: a failed launch raises). ``wrapper.launches``
counts kernel launches and nothing else. The bound of each kernel on the
card and what its design does about it are noted in its CUDA source.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm_plan import (SLAB, SMS, GemmPlan, plan_agg,
                                           plan_gram, split_sum)


# -- plain versions ----------------------------------------------------------

def _sqrt_weights(omega: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(omega, min=0.0))


def weighted_stack_b_plain(bs: torch.Tensor, omega: torch.Tensor
                           ) -> torch.Tensor:
    """bs (L, M, d, r); omega (M, r) -> U_c (L, d, M*r), client-major
    column blocks."""
    l, m, d, r = bs.shape
    u = bs * _sqrt_weights(omega)[None, :, None, :]
    return u.permute(0, 2, 1, 3).reshape(l, d, m * r)


def weighted_stack_a_plain(as_: torch.Tensor, omega: torch.Tensor
                           ) -> torch.Tensor:
    """as_ (L, M, r, n); omega (M, r) -> V_c (L, M*r, n)."""
    l, m, r, n = as_.shape
    return (as_ * _sqrt_weights(omega)[None, :, :, None]).reshape(l, m * r, n)


def _mirror_upper(g: torch.Tensor) -> torch.Tensor:
    """Exactly symmetric Gram: the upper triangle mirrored onto the lower
    (a library product need not round (i, j) and (j, i) alike, and
    ``torch.linalg.eigh`` reads only one triangle)."""
    upper = torch.triu(g)
    return upper + torch.triu(g, diagonal=1).mT


def gram_left_plain(u_c: torch.Tensor) -> torch.Tensor:
    """u_c (L, d, R) -> G_u = U_c^T U_c (L, R, R)."""
    return _mirror_upper(u_c.mT @ u_c)


def gram_right_plain(v_c: torch.Tensor) -> torch.Tensor:
    """v_c (L, R, n) -> G_v = V_c V_c^T (L, R, R)."""
    return _mirror_upper(v_c @ v_c.mT)


def rank_partition_agg_plain(bs: torch.Tensor, as_: torch.Tensor,
                             omega: torch.Tensor) -> torch.Tensor:
    """bs (M, d, r); as_ (M, r, n); omega (M, r) -> dW (d, n), the einsum
    of ``ref.rank_partition_agg_ref``; omega applied as given."""
    return torch.einsum("mdr,mr,mrn->dn", bs, omega, as_)


def rank_partition_agg_layered_plain(bs: torch.Tensor, as_: torch.Tensor,
                                     omega: torch.Tensor) -> torch.Tensor:
    """bs (L, M, d, r); as_ (L, M, r, n); omega (M, r) -> dW (L, d, n)."""
    return torch.einsum("lmdr,mr,lmrn->ldn", bs, omega, as_)


# -- the kernels' arithmetic on the CPU ---------------------------------------

def gram_left_split_plain(u_c: torch.Tensor) -> torch.Tensor:
    """``gram_left_plain`` with the depth d split as ``plan_gram`` splits
    it."""
    l, d, rr = u_c.shape
    return _mirror_upper(split_sum(
        lambda k0, k1: u_c[:, k0:k1].mT @ u_c[:, k0:k1], d,
        plan_gram(l, rr, d).depth))


def gram_right_split_plain(v_c: torch.Tensor) -> torch.Tensor:
    """``gram_right_plain`` with the depth n split as ``plan_gram`` splits
    it."""
    l, rr, n = v_c.shape
    return _mirror_upper(split_sum(
        lambda k0, k1: v_c[..., k0:k1] @ v_c[..., k0:k1].mT, n,
        plan_gram(l, rr, n).depth))


def live_slabs(omega: torch.Tensor) -> torch.Tensor:
    """Per 16-deep slab of the depth t = m r + c, whether any of its
    weights is nonzero (NaN counts): the slabs K3 runs."""
    w = omega.reshape(-1)
    w = torch.cat([w, w.new_zeros(-w.numel() % SLAB)])
    return (w.reshape(-1, SLAB) != 0).any(dim=1)


def rank_partition_agg_layered_split_plain(bs: torch.Tensor,
                                           as_: torch.Tensor,
                                           omega: torch.Tensor
                                           ) -> torch.Tensor:
    """``rank_partition_agg_layered_plain`` as K3 sums it: (B omega) @ A
    over the depth t = m r + c, cut as ``plan_agg`` cuts it, each range
    over its live slabs only (``live_slabs``); then NaN over each row with
    a non-finite B entry and each column with a non-finite A entry at a
    depth of a dead slab, where the reference's ``dot(b * om, a)`` has
    0 * inf."""
    l, m, d, r = bs.shape
    n, k = as_.shape[-1], m * r
    b = bs.permute(0, 2, 1, 3).reshape(l, d, k)
    u = b * omega.reshape(k)
    v = as_.reshape(l, k, n)
    cols = live_slabs(omega).repeat_interleave(SLAB)[:k]

    def part(k0, k1):
        idx = cols[k0:k1].nonzero().squeeze(1) + k0
        return u[..., idx] @ v[:, idx]
    out = split_sum(part, k, plan_agg(l, m, d, r, n).depth)
    rows = ~torch.isfinite(b[..., ~cols]).all(dim=-1)          # (l, d)
    col = ~torch.isfinite(v[:, ~cols]).all(dim=1)              # (l, n)
    return out.masked_fill(rows[..., None] | col[:, None], float("nan"))


def rank_partition_agg_split_plain(bs: torch.Tensor, as_: torch.Tensor,
                                   omega: torch.Tensor) -> torch.Tensor:
    """The single-layer K3 as the kernel sums it: the layered one at one
    layer."""
    return rank_partition_agg_layered_split_plain(bs[None], as_[None],
                                                  omega)[0]


# -- wrappers ----------------------------------------------------------------

def _check(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's card: that of
    ``torch.cuda.current_stream(x.device).cuda_stream``, without making a
    Stream object, which costs the host about as much as the launch."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _same_device(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.device != b.device:
        raise ValueError(f"{name}: inputs on {a.device} and {b.device}")


# weighted_stack.cu keeps a block's M r weights in 48 KB of shared memory
MAX_STACK_COLS = 12288


def _stack_cols(m: int, r: int) -> None:
    """The card's limit on a stack's M r columns."""
    if m * r > MAX_STACK_COLS:
        raise ValueError(f"weighted stack: M r = {m * r} columns > "
                         f"{MAX_STACK_COLS}")


def weighted_stack_b(bs: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """K1 (B side): bs (L, M, d, r); omega (M, r) -> U_c (L, d, M*r)."""
    _check("weighted_stack_b bs", bs, 4)
    _check("weighted_stack_b omega", omega, 2)
    _same_device(bs, omega, "weighted_stack_b")
    l, m, d, r = bs.shape
    if tuple(omega.shape) != (m, r):
        raise ValueError(f"omega {tuple(omega.shape)} != {(m, r)}")
    if bs.device.type == "cpu":
        return weighted_stack_b_plain(bs, omega)
    _stack_cols(m, r)
    u = torch.empty((l, d, m * r), dtype=torch.float32, device=bs.device)
    fn = "weighted_stack_b_f32"
    rc = getattr(build.library("weighted_stack"), fn)(
        bs.data_ptr(), omega.data_ptr(), u.data_ptr(), l, m, d, r, SMS,
        _stream(bs))
    build.check(rc, fn)
    weighted_stack_b.launches += 1
    return u


def weighted_stack_a(as_: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """K1 (A side): as_ (L, M, r, n); omega (M, r) -> V_c (L, M*r, n)."""
    _check("weighted_stack_a as_", as_, 4)
    _check("weighted_stack_a omega", omega, 2)
    _same_device(as_, omega, "weighted_stack_a")
    l, m, r, n = as_.shape
    if tuple(omega.shape) != (m, r):
        raise ValueError(f"omega {tuple(omega.shape)} != {(m, r)}")
    if as_.device.type == "cpu":
        return weighted_stack_a_plain(as_, omega)
    _stack_cols(m, r)
    v = torch.empty((l, m * r, n), dtype=torch.float32, device=as_.device)
    fn = "weighted_stack_a_f32"
    rc = getattr(build.library("weighted_stack"), fn)(
        as_.data_ptr(), omega.data_ptr(), v.data_ptr(), l, m, r, n, SMS,
        _stream(as_))
    build.check(rc, fn)
    weighted_stack_a.launches += 1
    return v


# A split's partial tiles and the per-tile counters its last block reads,
# one pair per device, grown on demand and reused (a call allocates only its
# output). The counters start zeroed and every launch leaves them zero;
# calls on one device are ordered by their stream, so two calls on two
# streams at once would share them: the port runs one stream.
_SPLIT_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_args(plan: GemmPlan, device: torch.device
                ) -> Tuple[Optional[int], Optional[int]]:
    """(partials, counters) pointers for the C entry; None for one split."""
    if plan.splits == 1:
        return None, None
    part, count = _SPLIT_SCRATCH.get(device, (None, None))
    grow_part = part is None or part.numel() < plan.blocks * plan.bm * plan.bn
    grow_count = count is None or count.numel() < plan.tiles
    if grow_part or grow_count:
        # a CUDA graph records the zeroing without running it
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the split scratch grows: make the first "
                               "call of this shape outside graph capture")
        if grow_part:
            part = torch.empty(plan.blocks * plan.bm * plan.bn,
                               dtype=torch.float32, device=device)
        if grow_count:
            count = torch.zeros(max(plan.tiles, 4096), dtype=torch.int32,
                                device=device)
        _SPLIT_SCRATCH[device] = (part, count)
    return part.data_ptr(), count.data_ptr()


def _launch_gram(fn: str, x: torch.Tensor, depth: int,
                 rr: int) -> torch.Tensor:
    l = x.shape[0]
    plan = plan_gram(l, rr, depth)
    g = torch.empty((l, rr, rr), dtype=torch.float32, device=x.device)
    rc = getattr(build.library("gram"), fn)(
        x.data_ptr(), g.data_ptr(), *_split_args(plan, x.device), l, depth,
        rr, plan.splits, plan.depth, _stream(x))
    build.check(rc, fn)
    return g


def gram_left(u_c: torch.Tensor) -> torch.Tensor:
    """K2 (left): u_c (L, d, R) -> G_u (L, R, R), exactly symmetric."""
    _check("gram_left u_c", u_c, 3)
    if u_c.device.type == "cpu":
        return gram_left_plain(u_c)
    g = _launch_gram("gram_left_f32", u_c, *u_c.shape[1:])
    gram_left.launches += 1
    return g


def gram_right(v_c: torch.Tensor) -> torch.Tensor:
    """K2 (right): v_c (L, R, n) -> G_v (L, R, R), exactly symmetric."""
    _check("gram_right v_c", v_c, 3)
    if v_c.device.type == "cpu":
        return gram_right_plain(v_c)
    g = _launch_gram("gram_right_f32", v_c, v_c.shape[2], v_c.shape[1])
    gram_right.launches += 1
    return g


# K3's flags: device -> int32 (the two epochs' words, then a tag a row and
# a column), zero when made; and the epoch of the device's last launch
_FLAGS: Dict[torch.device, torch.Tensor] = {}
_EPOCH: Dict[torch.device, int] = {}
FLAG_BYTES_A_BLOCK = 1 << 18    # K3's B and A bytes a flag block may read


def flag_blocks(layers: int, m: int, d: int, r: int, n: int) -> int:
    """K3's flag blocks: one a ``FLAG_BYTES_A_BLOCK`` of the B and A bytes
    the dead slabs could hold (all of the depth, at most), 1 to 2 ``SMS``
    (enough loads in flight to finish before the tiles' first wave)."""
    most = 4 * layers * (d + n) * m * r
    return max(1, min(2 * SMS, -(-most // FLAG_BYTES_A_BLOCK)))


def _flags(ints: int, device: torch.device) -> tuple:
    """(flags pointer, epoch) for K3's next launch on ``device``: at least
    ``ints`` int32s, zero when made (grown, never shrunk), and an epoch one
    past the last, which tags what this launch flags."""
    flags = _FLAGS.get(device)
    epoch = _EPOCH.get(device, 0) + 1
    if flags is None or flags.numel() < ints or epoch >= 2 ** 31 - 1:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K3's flags grow: make the first call of "
                               "this shape outside graph capture")
        flags = torch.zeros(max(ints, 4096), dtype=torch.int32,
                            device=device)
        _FLAGS[device], epoch = flags, 1
    _EPOCH[device] = epoch
    return flags.data_ptr(), epoch


def _launch_agg(bs: torch.Tensor, as_: torch.Tensor, omega: torch.Tensor,
                out: torch.Tensor, layers: int) -> None:
    m, d, r = bs.shape[-3:]
    n = as_.shape[-1]
    plan = plan_agg(layers, m, d, r, n)
    flags, epoch = _flags(2 + layers * (d + n), bs.device)
    fn = "rank_partition_agg_f32"
    rc = getattr(build.library("rank_partition_agg"), fn)(
        bs.data_ptr(), as_.data_ptr(), omega.data_ptr(), out.data_ptr(),
        *_split_args(plan, bs.device), flags, layers, m, d, r, n,
        plan.splits, plan.depth, flag_blocks(layers, m, d, r, n), epoch,
        _stream(bs))
    build.check(rc, fn)


def _check_agg(name: str, bs, as_, omega, lead: int) -> None:
    _check(f"{name} bs", bs, lead + 3)
    _check(f"{name} as_", as_, lead + 3)
    _check(f"{name} omega", omega, 2)
    _same_device(bs, as_, name)
    _same_device(bs, omega, name)
    m, d, r = bs.shape[-3:]
    if as_.shape[:-1] != bs.shape[:-2] + (r,) or \
            tuple(omega.shape) != (m, r):
        raise ValueError(f"{name}: bs {tuple(bs.shape)}, as_ "
                         f"{tuple(as_.shape)}, omega {tuple(omega.shape)} "
                         "do not match")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (bs, as_, omega)):
        raise NotImplementedError(f"{name} has no backward")


def rank_partition_agg(bs: torch.Tensor, as_: torch.Tensor,
                       omega: torch.Tensor) -> torch.Tensor:
    """K3: bs (M, d, r); as_ (M, r, n); omega (M, r), f32 contiguous ->
    dW (d, n) f32. The layered kernel launched at one layer."""
    _check_agg("rank_partition_agg", bs, as_, omega, 0)
    if bs.device.type == "cpu":
        return rank_partition_agg_plain(bs, as_, omega)
    out = torch.empty((bs.shape[1], as_.shape[2]), dtype=torch.float32,
                      device=bs.device)
    _launch_agg(bs, as_, omega, out, 1)
    rank_partition_agg.launches += 1
    return out


def rank_partition_agg_layered(bs: torch.Tensor, as_: torch.Tensor,
                               omega: torch.Tensor) -> torch.Tensor:
    """K3, layered: bs (L, M, d, r); as_ (L, M, r, n); omega (M, r) shared
    by all layers, f32 contiguous -> dW (L, d, n) f32."""
    _check_agg("rank_partition_agg_layered", bs, as_, omega, 1)
    if bs.device.type == "cpu":
        return rank_partition_agg_layered_plain(bs, as_, omega)
    out = torch.empty((bs.shape[0], bs.shape[2], as_.shape[3]),
                      dtype=torch.float32, device=bs.device)
    _launch_agg(bs, as_, omega, out, bs.shape[0])
    rank_partition_agg_layered.launches += 1
    return out


# the fused factored path the round runs (K1, K2), and the dense aggregate
# (K3) that only the kernel API reaches
KERNELS = (weighted_stack_b, weighted_stack_a, gram_left, gram_right)
DENSE_KERNELS = (rank_partition_agg, rank_partition_agg_layered)
for _k in KERNELS + DENSE_KERNELS:
    _k.launches = 0
