"""Bidirectional softmax attention (port of
``repro/models/layers/attention.py::blockwise_attention`` without a causal
mask, window or rope).

The reference streams KV blocks through an online softmax, which equals a
full softmax; at the round's sequence lengths the port writes that full
softmax(Q K^T * scale) V out explicitly in plain tensor code.
"""
from __future__ import annotations

import torch


def bidirectional_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """q (..., L, H, D); k, v (..., L, KVH, D) -> (..., L, H, D)."""
    h, d = q.shape[-2:]
    kvh = k.shape[-2]
    if kvh != h:                          # GQA: share each KV head
        k = k.repeat_interleave(h // kvh, dim=-2)
        v = v.repeat_interleave(h // kvh, dim=-2)
    qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))   # (..., H, L, D)
    scores = (qh.float() @ kh.float().mT) * d ** -0.5
    p = torch.softmax(scores, dim=-1)
    out = p.to(vh.dtype) @ vh
    return out.transpose(-3, -2).to(q.dtype)
