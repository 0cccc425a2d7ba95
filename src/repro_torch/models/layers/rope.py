"""Rotary position embeddings (port of ``repro/models/layers/rope.py``).

Standard RoPE with the half-split rotation: the head dim is cut into two
halves (x1, x2) that rotate as (x1 cos - x2 sin, x2 cos + x1 sin). Angles
are computed in f32 from integer positions and the result is cast back to
the input dtype. M-RoPE (Qwen2-VL) is not ported yet.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,) in f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., L, H, D); positions (..., L) integer. Rotation in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)              # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (..., L, D/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., L, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions, theta, sections):
    raise NotImplementedError(
        "M-RoPE (Qwen2-VL) is not ported yet (ROADMAP.md queue 1 item 10)")
