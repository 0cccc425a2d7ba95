"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434), ported
from ``repro/models/layers/mla.py`` with the client axis written out.

K and V are compressed to a shared latent ``c_kv`` (``kv_lora_rank``)
plus one decoupled RoPE key ``k_rope`` (``qk_rope_head_dim``) that every
head shares; the decode cache holds only these, (512 + 64) floats a token
and layer at DeepSeek-V2's width against 2 x 128 x 128 of per-head K/V.
A full sequence expands the latent to per-head K/V (``kv_b``); a decode
step writes the new token's latent at each row's index and expands the
WHOLE cache again, as the reference does (no weight absorption).

q is ``q_b(rms_norm(q_a(x)))`` with ``q_lora_rank`` > 0, else ``q(x)``;
its adapter rank comes from the target ``q_a_proj`` either way. Both
latent norms use ``rms_norm``'s default eps (1e-6), not the config's.
Scores are scaled by (qk_nope + qk_rope) ** -0.5, q's head dim; v keeps
its own width (the reference pads it to q's and slices the pad off,
which changes no value). The projections take ``dense_apply``'s plain
per-client route: K4 serves none of them, as in the reference.

Shapes: x (C, B, L, d); positions (C, B, L) or (L,); the latents (C, B,
L, kv_lora_rank) and (C, B, L, qk_rope_head_dim), post-RoPE; decode
caches (R, S, ...) with rows R = C * B.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.models.layers import draw
from repro_torch.models.layers.attention import (bidirectional_attention,
                                                 causal_attention,
                                                 decode_attention)
from repro_torch.models.layers.dense import dense_apply, dense_init
from repro_torch.models.layers.norms import rms_norm, rms_norm_init
from repro_torch.models.layers.rope import apply_rope


def mla_init(gen: torch.Generator, d_model: int, num_heads: int,
             cfg: MLAConfig, *, lora_ranks: dict, dtype=torch.float32,
             device=None, out: Optional[dict] = None) -> dict:
    kw = dict(dtype=dtype, device=device)

    def to(key):
        return dict(out=draw.sub(out, key), **kw)
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    params = {}
    if cfg.q_lora_rank:
        params["q_a"] = dense_init(gen, d_model, cfg.q_lora_rank,
                                   lora_rank=lora_ranks.get("q_a_proj", 0),
                                   **to("q_a"))
        params["q_a_norm"] = rms_norm_init(cfg.q_lora_rank, **to("q_a_norm"))
        params["q_b"] = dense_init(gen, cfg.q_lora_rank, num_heads * qk_head,
                                   **to("q_b"))
    else:
        params["q"] = dense_init(gen, d_model, num_heads * qk_head,
                                 lora_rank=lora_ranks.get("q_a_proj", 0),
                                 **to("q"))
    # joint KV compression and the decoupled rope key
    params["kv_a"] = dense_init(gen, d_model,
                                cfg.kv_lora_rank + cfg.qk_rope_head_dim,
                                lora_rank=lora_ranks.get("kv_a_proj", 0),
                                **to("kv_a"))
    params["kv_a_norm"] = rms_norm_init(cfg.kv_lora_rank, **to("kv_a_norm"))
    params["kv_b"] = dense_init(
        gen, cfg.kv_lora_rank,
        num_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim), **to("kv_b"))
    params["o"] = dense_init(gen, num_heads * cfg.v_head_dim, d_model,
                             lora_rank=lora_ranks.get("o_proj", 0),
                             **to("o"))
    return params


def _project_q(params: dict, x: torch.Tensor, num_heads: int,
               cfg: MLAConfig, lk: dict):
    """(q_nope, q_rope), each (..., L, H, *)."""
    if "q_a" in params:
        q = dense_apply(params["q_b"],
                        rms_norm(params["q_a_norm"],
                                 dense_apply(params["q_a"], x, **lk)))
    else:
        q = dense_apply(params["q"], x, **lk)
    q = q.reshape(x.shape[:-1] + (num_heads, -1))
    return q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)


def _latent_kv(params: dict, x: torch.Tensor, cfg: MLAConfig, lk: dict):
    """(normed c_kv (..., R), k_rope (..., rope) before RoPE)."""
    kv = dense_apply(params["kv_a"], x, **lk)
    c_kv, k_rope = kv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim],
                            dim=-1)
    return rms_norm(params["kv_a_norm"], c_kv), k_rope


def _expand_kv(params: dict, c_kv: torch.Tensor, num_heads: int,
               cfg: MLAConfig):
    """Per-head (k_nope, v) from the latent, each (..., S, H, *)."""
    kvb = dense_apply(params["kv_b"], c_kv)
    kvb = kvb.reshape(c_kv.shape[:-1] + (num_heads, -1))
    return kvb.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)


def _heads(q_nope, q_rope, k_nope, k_rope):
    """q and k (..., H, nope + rope): the one rope key broadcast over
    the heads."""
    k_rope = k_rope[..., None, :].expand(k_nope.shape[:-1]
                                         + (k_rope.shape[-1],))
    return (torch.cat([q_nope, q_rope], dim=-1),
            torch.cat([k_nope, k_rope], dim=-1))


def mla_attention(params: dict, x: torch.Tensor, positions,
                  num_heads: int, cfg: MLAConfig, *, rope_theta: float,
                  causal: bool = True, sliding_window: int = 0,
                  lora_rank: int = -1, lora_scale=None):
    """Full-sequence MLA: (out (C, B, L, d), (c_kv, post-RoPE k_rope)) for
    the cache."""
    lk = dict(lora_rank=lora_rank, lora_scale=lora_scale)
    q_nope, q_rope = _project_q(params, x, num_heads, cfg, lk)
    c_kv, k_rope = _latent_kv(params, x, cfg, lk)
    k_nope, v = _expand_kv(params, c_kv, num_heads, cfg)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], positions, rope_theta)[..., 0, :]
    q, k = _heads(q_nope, q_rope, k_nope, k_rope)
    if causal:
        out = causal_attention(q, k, v, sliding_window=sliding_window)
    else:
        out = bidirectional_attention(q, k, v)
    out = out.reshape(x.shape[:-1] + (num_heads * cfg.v_head_dim,))
    return dense_apply(params["o"], out, **lk), (c_kv, k_rope)


def mla_decode(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               cache_len: torch.Tensor, num_heads: int, cfg: MLAConfig, *,
               rope_theta: float, lora_rank: int = -1,
               lora_scale=None) -> torch.Tensor:
    """One token a row against the compressed cache. x (C, B, 1, d);
    positions (C, B, 1); caches (R, S, ...) with R = C * B, updated in
    place at each row's index ``len % S``; ``cache_len`` a scalar or (R,)
    per-row lengths. Returns the attention output (C, B, 1, d)."""
    lk = dict(lora_rank=lora_rank, lora_scale=lora_scale)
    rows, s_cache = cache_ckv.shape[:2]
    q_nope, q_rope = _project_q(params, x, num_heads, cfg, lk)
    c_kv, k_rope = _latent_kv(params, x, cfg, lk)
    q_rope = apply_rope(q_rope, positions, rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], positions, rope_theta)[..., 0, :]
    ar = torch.arange(rows, device=x.device)
    write_idx = (cache_len % s_cache).expand(rows)
    cache_ckv[ar, write_idx] = c_kv.reshape(rows, -1).to(cache_ckv.dtype)
    cache_krope[ar, write_idx] = k_rope.reshape(rows, -1).to(
        cache_krope.dtype)
    k_nope, v = _expand_kv(params, cache_ckv, num_heads, cfg)  # (R, S, H, *)
    q, k = _heads(q_nope, q_rope, k_nope, cache_krope)
    total = torch.clamp(cache_len, max=s_cache - 1) + 1
    out = decode_attention(q.reshape((rows, 1) + q.shape[-2:]), k, v, total)
    out = out.reshape(x.shape[:-1] + (num_heads * cfg.v_head_dim,))
    return dense_apply(params["o"], out, **lk)
