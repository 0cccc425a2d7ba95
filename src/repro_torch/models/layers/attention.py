"""Softmax attention (port of ``repro/models/layers/attention.py``):
bidirectional and causal full-sequence attention (the ``causal=False`` /
``causal=True`` cases of ``blockwise_attention`` without a window or
softcap) and single-token ``decode_attention`` against a KV cache.

The reference streams KV blocks through an online softmax, which equals a
full softmax; at the port's sequence lengths the full softmax(Q K^T *
scale) V is written out in plain tensor code, scores in f32. GQA: query
head h reads KV head h // (H / KVH), as ``_gqa_group`` groups them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    kvh = t.shape[-2]
    return t if kvh == h else t.repeat_interleave(h // kvh, dim=-2)


def _attend(q, k, v, mask=None) -> torch.Tensor:
    """q (..., Lq, H, D); k, v (..., Lkv, KVH, D); mask broadcastable to
    (..., H, Lq, Lkv), True where a key may be seen."""
    h, d = q.shape[-2:]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))   # (..., H, L, D)
    scores = (qh.float() @ kh.float().mT) * d ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = p.to(vh.dtype) @ vh
    return out.transpose(-3, -2).to(q.dtype)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q (..., L, H, D); k, v (..., L, KVH, D) -> (..., L, H, D)."""
    return _attend(q, k, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0) -> torch.Tensor:
    """Causal: query i (absolute position q_offset + i) sees keys at
    positions <= its own. q (..., Lq, H, D); k, v (..., Lkv, KVH, D)."""
    lq, lkv = q.shape[-3], k.shape[-3]
    q_pos = q_offset + torch.arange(lq, device=q.device)
    kv_pos = torch.arange(lkv, device=q.device)
    return _attend(q, k, v, kv_pos[None, :] <= q_pos[:, None])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) vs cache (B, S, KVH, D).
    ``cache_len`` (scalar or (B,)) masks cache positions >= len."""
    s = k_cache.shape[1]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < lens     # (B|1, S)
    return _attend(q, k_cache, v_cache, valid[:, None, None, :])
