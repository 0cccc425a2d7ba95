"""Rotary position embeddings (port of ``repro/models/layers/rope.py``).

Standard RoPE with the half-split rotation: the head dim is cut into two
halves (x1, x2) that rotate as (x1 cos - x2 sin, x2 cos + x1 sin). Angles
are computed in f32 from integer positions and the result is cast back to
the input dtype.

M-RoPE (Qwen2-VL, arXiv:2409.12191) gives each of the D/2 frequency
indices one of three position streams (temporal, height, width) by
``sections``; with the three streams equal it is standard RoPE.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,) in f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (..., L, H, D) rotated by angles (..., L, D/2), in f32."""
    cos = torch.cos(angles)[..., None, :]                      # (..., L, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., L, H, D); positions (..., L) integer. Rotation in f32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)    # (D/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """M-RoPE. x (..., L, H, D); positions (3, ..., L) integer, the stream
    axis first: (temporal, height, width) ids, each broadcastable against
    x's leading dims (the reference's (3, B, L); (3, C, B, L) at the
    model's client-axis entries). ``sections`` gives the number of
    frequency pairs each stream takes, in order; they sum to D/2."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {d // 2}")
    freqs = rope_freqs(d, theta, device=x.device)              # (D/2,)
    # frequency indices 0,..,0,1,..,1,2,..,2 take streams 0, 1, 2: each
    # section's angles from its own stream (slices, no index tensor)
    pos = positions.to(torch.float32)[..., None]               # (3, ..., L, 1)
    bounds = [0, sections[0], sections[0] + sections[1], d // 2]
    angles = torch.cat([pos[i] * freqs[bounds[i]:bounds[i + 1]]
                        for i in range(3)], dim=-1)            # (..., L, D/2)
    return _rotate(x, angles)
