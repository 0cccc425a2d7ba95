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
kernel (``csrc/flash_attention.cu``) for CUDA tensors, with no fallback: a
failed build or launch raises. ``flash_attention.launches`` counts kernel
launches and nothing else. The kernel has no backward, so the wrapper
refuses inputs that need a gradient. No model calls it (the reference's
models attend in plain jnp too); the kernel API ``ops`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rank_partition_agg import _same_device, _stream

NEG_INF = -1e30              # the reference's finite mask fill
MAX_HEAD_DIM = 256           # kMaxD in the .cu: the shared-memory tiles


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
    lkv, kvh = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} > {MAX_HEAD_DIM}, "
                         "beyond the kernel's shared-memory tiles")
    qf, kf, vf = (t.float().contiguous() for t in (q, k, v))
    o = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    fn = "flash_attention_f32"
    rc = getattr(build.library("flash_attention"), fn)(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(), b, lq, lkv,
        h, kvh, d, int(bool(causal)), int(window), d ** -0.5, _stream(q))
    build.check(rc, fn)
    flash_attention.launches += 1
    return o.to(q.dtype)


KERNELS = (flash_attention,)
flash_attention.launches = 0
