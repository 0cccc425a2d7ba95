"""Online-softmax attention K7, ported from
``repro/kernels/flash_attention.py::flash_attention_pallas`` with the
contract of its oracle ``repro/kernels/ref.py::flash_attention_ref``.

q (B, Lq, H, D); k, v (B, Lkv, KVH, D) with H a multiple of KVH (query
head h reads KV head h // (H / KVH)); positions start at 0 for both;
scores (q . k) * D^-0.5, masked where ``causal`` and the key lies after
the query, or where ``window`` > 0 and it lies ``window`` or more before
it, with the finite fill -1e30; softmax over the Lkv keys; output in q's
dtype, computed in f32.

``flash_attention_plain`` is the oracle written in PyTorch; the wrapper
``flash_attention`` computes it for CPU tensors and launches the CUDA
kernel (``csrc/flash_attention.cu``, both products 3xTF32 on the tensor
cores) for CUDA tensors, with no fallback: a failed build or launch
raises. ``plan_attention`` picks the kernel's tiles on the host;
``flash_attention_tf32x3_plain`` repeats its product precision in
PyTorch. The kernel walks only the kv tiles of each block's band, but the
oracle takes p v over all Lkv keys with p = 0 outside a row's band, so a
non-finite value entry there makes its column NaN (0 * inf). Where some
row's band leaves out a key, a pass before the main launch reads V once
for the first and last key with a non-finite entry per (batch, kv head),
and a row whose band leaves one out is summed again over all keys in IEEE
f32, as the oracle sums it. ``flash_attention.launches`` counts the
wrapper's calls that ran on the card (one main launch each, whether or
not the pass over V ran) and nothing else. The kernel has no backward, so
the wrapper refuses inputs that need a gradient. No model calls it (the
reference's models attend in plain jnp too); the kernel API ``ops`` does.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, tf32x3
from repro_torch.kernels.gemm_plan import SMS
from repro_torch.kernels.rank_partition_agg import _same_device, _stream

NEG_INF = -1e30              # the reference's finite mask fill
MAX_HEAD_DIM = 256           # kMaxD in the .cu: the widest instance
# the kernel instances of flash_attention.cu, by head dim: (tile width, to
# which D is zero-padded; keys a kv tile; blocks of four warps an SM its
# registers allow). The kv tile shrinks as D grows so that the shared
# memory holds as many blocks as the registers.
INSTANCES = ((16, 64, 4), (32, 64, 4), (64, 64, 4), (80, 32, 3),
             (128, 32, 3), (192, 32, 2), (256, 16, 2))
MAX_WARPS = 4                # kMaxWarps: a q tile of 16 to 64 rows
SM_SMEM = 233472             # the H100's shared memory an SM, bytes
BLOCK_SMEM = 232448          # ... that one block may take
BLOCK_RESERVED = 1024        # ... that the card keeps for each block


class AttnPlan(NamedTuple):
    """A block of ``warps`` warps owns 16 ``warps`` q rows of one (b, h);
    kv tiles of ``kv_tile`` keys pass through a ring of two slots (K, V)."""
    warps: int
    kv_tile: int
    q_tiles: int
    blocks: int
    smem: int                # dynamic shared memory of a block, bytes
    per_sm: int              # blocks an SM holds by shared memory and threads

    @property
    def q_tile(self) -> int:
        return 16 * self.warps

    def report(self) -> dict:
        return {"route": "mma_tf32x3", "q_tile": self.q_tile,
                "kv_tile": self.kv_tile,
                "blocks": self.blocks, "smem": self.smem,
                "blocks_per_sm": self.per_sm}


def instance(d: int) -> tuple:
    """(tile width, kv tile, blocks an SM by registers) of head dim d."""
    return next(i for i in INSTANCES if d <= i[0])


def _ld_qk(dp: int) -> int:
    """ld_qk in the .cu: a Q or K row's stride, 8 (mod 32) floats."""
    return dp + (40 - dp % 32) % 32


def _ld_v(dp: int) -> int:
    """ld_v: a V row's stride, 4 (mod 16) floats."""
    return dp + (12 if dp % 16 else 4)


def attention_smem(d: int, kv_tile: int, warps: int) -> int:
    """smem_bytes in the .cu: the Q tile and the ring's two slots, bytes,
    at the width of d's instance."""
    dp = instance(d)[0]
    slot = kv_tile * max(_ld_qk(dp), _ld_v(dp))
    return 4 * (16 * warps * _ld_qk(dp) + 2 * slot)


def _per_sm(smem: int, warps: int) -> int:
    return min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // (32 * warps), 32)


@functools.lru_cache(maxsize=1024)   # the wrapper plans every call
def plan_attention(b: int, lq: int, h: int, d: int) -> AttnPlan:
    """The kernel's tiles for q (b, lq, h, d).

    Warps (a q tile of 16 w rows): four, the most the kernel takes, which
    measured fastest at every kernel_ops shape (more warps an SM, and each
    K / V tile read by more of them); fewer where Lq has fewer 16-row
    groups, or where B H tiles would leave an SM without a block. A warp
    wholly past Lq computes nothing, so the rows computed past Lq are under
    16 whatever the tile (L 197: 11 of 208, where the SIMT kernel computed
    59 of 256). kv tile: the instance of D's width (``INSTANCES``), which
    with the ring's two slots lets shared memory hold the blocks the
    registers allow."""
    _, kv, _ = instance(d)
    warps = max(1, min(MAX_WARPS, -(-lq // 16)))
    while warps > 1 and b * h * -(-lq // (16 * warps)) < SMS:
        warps -= 1
    smem = attention_smem(d, kv, warps)
    q_tiles = -(-lq // (16 * warps))
    return AttnPlan(warps, kv, q_tiles, b * h * q_tiles, smem,
                    _per_sm(smem, warps))


def _band(lq: int, lkv: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Lq, Lkv) bool, True where query i may see key j."""
    qpos = torch.arange(lq, device=device)[:, None]
    kpos = torch.arange(lkv, device=device)[None, :]
    mask = torch.ones((lq, lkv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0
                          ) -> torch.Tensor:
    """``ref.flash_attention_ref``: the whole softmax(q k^T * D^-0.5) v in
    f32, GQA by folding the group into the query heads."""
    b, lq, h, d = q.shape
    lkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, lq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    s = torch.where(_band(lq, lkv, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, lq, h, d).to(q.dtype)


def flash_attention_tf32x3_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, causal: bool = True,
                                 window: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: S = q k^T and P V from the three
    TF32 passes (``tf32x3.matmul``), the unnormalised P = exp(s - row max)
    (zero past Lkv, none here), and O = (P V) / row sum, in f32."""
    b, lq, h, d = q.shape
    lkv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, lq, kvh, g, d).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 3, 1)[:, :, None]      # (b, kvh, 1, d, lkv)
    s = tf32x3.matmul(qg, kt) * d ** -0.5                # (b, kvh, g, lq, lkv)
    s = torch.where(_band(lq, lkv, causal, window, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    vt = v.float().permute(0, 2, 1, 3)[:, :, None]      # (b, kvh, 1, lkv, d)
    o = tf32x3.matmul(p, vt) / p.sum(dim=-1, keepdim=True)
    return o.permute(0, 3, 1, 2, 4).reshape(b, lq, h, d).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"flash_attention {name}: expected 4-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"flash_attention {name}: got {t.dtype}")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention {name}: unsupported device "
                             f"{t.device}")
        _same_device(q, t, "flash_attention")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads do not split "
                         f"into {k.shape[2]} KV heads")
    if k.shape[1] < 1:
        raise ValueError("flash_attention: no keys (Lkv = 0)")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """K7: shapes as in ``flash_attention_plain``; any float dtype, read as
    f32 on the card; D at most 256. Lq and Lkv are free: the kernel masks
    on the true Lkv, so nothing is padded."""
    _check(q, k, v, int(window))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention has no backward")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, int(window))
    b, lq, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}, "
                         "beyond the kernel's shared-memory tiles")
    return _launch(q, k, v, causal, int(window), plan_attention(b, lq, h, d))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, plan: AttnPlan) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors with the given plan (the
    wrapper's, or another one a test picks)."""
    b, lq, h, d = q.shape
    lkv, kvh = k.shape[1], k.shape[2]
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    o = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    vrange = torch.empty(2 * b * kvh, dtype=torch.int32, device=q.device)
    fn = "flash_attention_f32"
    rc = getattr(build.library("flash_attention"), fn)(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
        vrange.data_ptr(), b, lq, lkv, h, kvh, d, int(bool(causal)), window,
        d ** -0.5, plan.warps, plan.kv_tile, _stream(q))
    build.check(rc, fn)
    flash_attention.launches += 1
    return o.to(q.dtype)


KERNELS = (flash_attention,)
flash_attention.launches = 0
