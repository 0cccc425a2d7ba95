"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060), ported from
``repro/models/layers/ssd.py`` with the client axis written out.

Shapes (per mixer), C clients or request slots of B rows each, rows
R = C * B client-major in the states:
  u        (C, B, L, d_model)
  in_proj  -> z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)
  x viewed as (R, L, H, P);   B, C as (R, L, G, N);   H = G * heads_per_group
  conv state (R, K-1, conv_ch) in u's dtype;   SSM state (R, H, P, N) f32

The recurrence per head:  S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T,
y_t = C_t . S_t + D x_t, gated by silu(z) and RMS-normed before out_proj.
A full sequence runs the chunked dual form (``ssd_scan_chunked``, or K6
with ``use_kernel``); one decode token runs the recurrence
(``ssd_decode_step``). The in/out projections take ``dense_apply``'s plain
per-client route in both, as in the reference (K4 serves attention
projections only).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import _expand_groups, ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_scan_chunked
from repro_torch.models.layers.dense import dense_apply, dense_init
from repro_torch.models.layers.norms import rms_norm, rms_norm_init


def ssd_dims(d_model: int, cfg: SSMConfig) -> dict:
    d_inner = cfg.expand * d_model
    nheads = cfg.num_heads or d_inner // cfg.head_dim
    head_dim = d_inner // nheads
    conv_ch = d_inner + 2 * cfg.ngroups * cfg.state_dim
    proj_out = 2 * d_inner + 2 * cfg.ngroups * cfg.state_dim + nheads
    return dict(d_inner=d_inner, nheads=nheads, head_dim=head_dim,
                conv_ch=conv_ch, proj_out=proj_out)


def ssd_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
             lora_ranks: dict, dtype=torch.float32, device=None) -> dict:
    """The reference's leaves and init distributions (the random streams
    differ)."""
    dims = ssd_dims(d_model, cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "in_proj": dense_init(gen, d_model, dims["proj_out"],
                              lora_rank=lora_ranks.get("ssm_in_proj", 0),
                              **kw),
        "out_proj": dense_init(gen, dims["d_inner"], d_model,
                               lora_rank=lora_ranks.get("ssm_out_proj", 0),
                               **kw),
        # depthwise causal conv over [x, B, C] channels
        "conv_w": (torch.randn(cfg.conv_dim, dims["conv_ch"], generator=gen,
                               device=device)
                   * (1.0 / cfg.conv_dim) ** 0.5).to(dtype),
        "conv_b": torch.zeros(dims["conv_ch"], **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, dims["nheads"],
                                          device=device)),
        "D": torch.ones(dims["nheads"], dtype=torch.float32, device=device),
        "dt_bias": torch.zeros(dims["nheads"], dtype=torch.float32,
                               device=device),
        "norm": rms_norm_init(dims["d_inner"], **kw),
    }


def _split_proj(proj: torch.Tensor, d_model: int, cfg: SSMConfig):
    dims = ssd_dims(d_model, cfg)
    d_in, gn, h = dims["d_inner"], cfg.ngroups * cfg.state_dim, dims["nheads"]
    z, x, b, c, dt = torch.split(proj, [d_in, d_in, gn, gn, h], dim=-1)
    return z, x, b, c, dt, dims


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. xbc (R, L, C); w (K, C).

    Returns (out (R, L, C), final_state (R, K-1, C)): the last K-1
    pre-activation inputs."""
    k = w.shape[0]
    rows, length, ch = xbc.shape
    if init_state is None:
        init_state = xbc.new_zeros((rows, k - 1, ch))
    padded = torch.cat([init_state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros((rows, length, ch), dtype=torch.float32,
                      device=xbc.device)
    for i in range(k):   # K is tiny (4): unrolled taps
        out = out + padded[:, i:i + length].float() * w[i].float()
    out = out + bias.float()
    return F.silu(out).to(xbc.dtype), padded[:, length:]


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. x (R, H, P); dt (R, H); b, c (R, G, N); state
    (R, H, P, N). Returns (y (R, H, P), new_state)."""
    nheads = x.shape[1]
    a_neg = -torch.exp(a_log.float())
    bh = _expand_groups(b.float(), nheads)                       # (R,H,N)
    ch = _expand_groups(c.float(), nheads)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(dtf * a_neg)                               # (R,H)
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bhn,bhp,bh->bhpn", bh, xf, dtf))
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    y = y + xf * d_skip.float()[None, :, None]
    return y.to(x.dtype), new_state


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor, lk: dict):
    """rms_norm(norm, y * silu(z)) (eps 1e-6, as the reference), then
    out_proj."""
    y = rms_norm(params["norm"], y * F.silu(z))
    return dense_apply(params["out_proj"], y, **lk)


def ssd_mixer_apply(params: dict, u: torch.Tensor, d_model: int,
                    cfg: SSMConfig, *, lora_rank: int = -1,
                    lora_scale: Optional[torch.Tensor] = None,
                    conv_state: Optional[torch.Tensor] = None,
                    ssm_state: Optional[torch.Tensor] = None,
                    use_kernel: bool = False):
    """Full SSD mixer over sequences u (C, B, L, d_model); the scan runs
    on K6 under ``use_kernel``. Returns (y (C, B, L, d_model),
    (conv_state (R, K-1, conv_ch), ssm_state (R, H, P, N)))."""
    lk = dict(lora_rank=lora_rank, lora_scale=lora_scale)
    lead = u.shape[:2]
    rows, length = lead[0] * lead[1], u.shape[2]
    proj = dense_apply(params["in_proj"], u, **lk)
    z, x, b, c, dt, dims = _split_proj(proj, d_model, cfg)
    nheads, hp = dims["nheads"], dims["head_dim"]
    gn = cfg.ngroups * cfg.state_dim
    xbc = torch.cat([x, b, c], dim=-1).reshape(rows, length, -1)
    xbc, conv_final = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   conv_state)
    x, b, c = torch.split(xbc, [dims["d_inner"], gn, gn], dim=-1)
    x = x.reshape(rows, length, nheads, hp)
    b = b.reshape(rows, length, cfg.ngroups, cfg.state_dim)
    c = c.reshape(rows, length, cfg.ngroups, cfg.state_dim)
    dt_act = F.softplus(dt.float().reshape(rows, length, nheads)
                        + params["dt_bias"].float())
    scan = ssd_scan if use_kernel else ssd_scan_chunked
    y, ssm_final = scan(x, dt_act, params["A_log"], b, c, params["D"],
                        cfg.chunk_size, init_state=ssm_state)
    y = y.reshape(lead + (length, dims["d_inner"]))
    return _gated_out(params, y, z, lk), (conv_final, ssm_final)


def ssd_mixer_decode(params: dict, u: torch.Tensor, d_model: int,
                     cfg: SSMConfig, conv_state: torch.Tensor,
                     ssm_state: torch.Tensor, *, lora_rank: int = -1,
                     lora_scale: Optional[torch.Tensor] = None):
    """One-token decode. u (C, B, 1, d_model); conv_state (R, K-1,
    conv_ch); ssm_state (R, H, P, N). Returns (y (C, B, 1, d_model),
    (new conv_state, new ssm_state))."""
    lk = dict(lora_rank=lora_rank, lora_scale=lora_scale)
    lead = u.shape[:2]
    rows = lead[0] * lead[1]
    proj = dense_apply(params["in_proj"], u, **lk)
    z, x, b, c, dt, dims = _split_proj(proj, d_model, cfg)
    nheads, hp = dims["nheads"], dims["head_dim"]
    gn = cfg.ngroups * cfg.state_dim
    xbc = torch.cat([x, b, c], dim=-1).reshape(rows, 1, -1)
    # conv over [state, new]: window = last K inputs
    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)  # (R,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float()) \
        + params["conv_b"].float()
    xbc_out = F.silu(conv_out).to(u.dtype)                       # (R,C)
    x1, b1, c1 = torch.split(xbc_out, [dims["d_inner"], gn, gn], dim=-1)
    dt1 = F.softplus(dt.reshape(rows, nheads).float()
                     + params["dt_bias"].float())
    y, new_ssm = ssd_decode_step(
        x1.reshape(rows, nheads, hp), dt1, params["A_log"],
        b1.reshape(rows, cfg.ngroups, cfg.state_dim),
        c1.reshape(rows, cfg.ngroups, cfg.state_dim), params["D"], ssm_state)
    y = y.reshape(lead + (1, dims["d_inner"]))
    return _gated_out(params, y, z, lk), (window[:, 1:], new_ssm)
