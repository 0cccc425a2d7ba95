"""Softmax attention (port of ``repro/models/layers/attention.py``):
bidirectional and causal full-sequence attention (``blockwise_attention``
with ``causal`` False / True, a sliding window and a softcap), single-token
``decode_attention`` against a KV cache, and the windowed decode
(``decode_attention_windowed``, the reference's
``transformer._decode_attention_windowed``).

The reference streams KV blocks through an online softmax, which equals a
full softmax; at the port's sequence lengths the whole score matrix is
written out in plain tensor code, scores in f32. In f32 that is
softmax(Q K^T * scale) V. Below f32 its rounding points are the
reference's: over full sequences the weights p = exp(s - max) are rounded
to the value dtype before p V (f32 sums) and divided by their f32 sum
after it, as one block of the online softmax does; the decode takes the
normalised softmax, rounded to the value dtype, then p V in f32. (In f32
the two forms differ by rounding only, and the exp form keeps the scores
for the backward beside the weights: 4.5 GiB more in a vit-base round.)
The output is rounded to q's dtype once. The scores are f32 sums of the
inputs' products (the reference's default; its ``bf16_scores`` option
serves its TPU dry run only). GQA: query head h reads KV head
h // (H / KVH), as ``_gqa_group`` groups them.
The softcap bounds the attention scores, ``softcap * tanh(s / softcap)``
before the mask, as the reference does with the config's
``logit_softcap``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _repeat_kv(t: torch.Tensor, h: int) -> torch.Tensor:
    kvh = t.shape[-2]
    return t if kvh == h else t.repeat_interleave(h // kvh, dim=-2)


def _attend(q, k, v, mask=None, softcap: float = 0.0, *,
            normalized: bool = False) -> torch.Tensor:
    """q (..., Lq, H, D); k, v (..., Lkv, KVH, D); mask broadcastable to
    (..., H, Lq, Lkv), True where a key may be seen. ``normalized``: the
    decode's softmax weights; otherwise, below f32, the full-sequence
    form (weights exp(s - max), divided after p V)."""
    h, d = q.shape[-2:]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))   # (..., H, L, D)
    scores = (qh.float() @ kh.float().mT) * d ** -0.5
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    if normalized or vh.dtype == torch.float32:
        out = torch.softmax(scores, dim=-1).to(vh.dtype).float() @ vh.float()
    else:
        p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        out = (p.to(vh.dtype).float() @ vh.float()) / torch.clamp(
            p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.transpose(-3, -2).to(q.dtype)


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q (..., L, H, D); k, v (..., L, KVH, D) -> (..., L, H, D)."""
    return _attend(q, k, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_offset: int = 0, sliding_window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Causal: query i (absolute position q_offset + i) sees keys at
    positions <= its own, and with ``sliding_window`` > 0 only those
    after q_pos - window. q (..., Lq, H, D); k, v (..., Lkv, KVH, D)."""
    lq, lkv = q.shape[-3], k.shape[-3]
    q_pos = q_offset + torch.arange(lq, device=q.device)
    kv_pos = torch.arange(lkv, device=q.device)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if sliding_window:
        mask &= kv_pos[None, :] > q_pos[:, None] - sliding_window
    return _attend(q, k, v, mask, softcap)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, D) vs cache (B, S, KVH, D).
    ``cache_len`` (scalar or (B,)) masks cache positions >= len."""
    return decode_attention_windowed(q, k_cache, v_cache, cache_len, None,
                                     softcap=softcap)


def decode_attention_windowed(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, total, lo, *,
                              softcap: float = 0.0) -> torch.Tensor:
    """Decode attention over the validity window [max(lo, 0), total):
    ``total`` and ``lo`` are scalars or (B,) per-slot bounds (``lo`` None:
    from 0)."""
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    valid = pos < torch.as_tensor(total, device=q.device).reshape(-1, 1)
    if lo is not None:
        valid = valid & (pos >= torch.as_tensor(lo, device=q.device
                                                ).reshape(-1, 1))
    return _attend(q, k_cache, v_cache, valid[:, None, None, :], softcap,
                   normalized=True)
