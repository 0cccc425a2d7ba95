"""SVD-based rank reallocation (FlexLoRA Eq. 3-4), factored routes.

A port of the parts of ``repro/core/svd.py`` that the kernel backend
runs. The aggregate is always U_c @ V_c with U_c (d, R), V_c (R, n), so
the reallocation works on (R, R) cores and never forms the (d, n) update.
Every function here takes any number of leading batch axes.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def check_fallback_globals(fallback, global_b, global_a) -> None:
    """A non-None Eq. 8 fallback REQUIRES both global factors: silently
    dropping it would degrade raFLoRA's empty-partition case to
    FlexLoRA-style zeroing, so fail loudly instead."""
    if fallback is None:
        return
    missing = [name for name, g in (("global_b", global_b),
                                    ("global_a", global_a)) if g is None]
    if missing:
        raise ValueError(
            "Eq. 8 empty-partition fallback is set but "
            f"{' and '.join(missing)} {'is' if len(missing) == 1 else 'are'}"
            " missing; pass the current global adapter factors so the "
            "uncovered rank partitions can retain their global slices")


@contextlib.contextmanager
def _flush_denormals(device: torch.device):
    """Flush denormals to zero around a CPU eigensolve, as XLA's CPU
    backend (the reference) always computes. A Gram core of zero-padded
    client columns has a large exact-zero eigenvalue cluster, and LAPACK's
    f32 eigensolver can fail to converge on it when denormals are kept."""
    if device.type != "cpu" or not torch.set_flush_denormal(True):
        yield
        return
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def svd_realloc_gram(u_c: torch.Tensor, v_c: torch.Tensor,
                     g_u: torch.Tensor, g_v: torch.Tensor, r_max: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factored SVD realloc from precomputed (R, R) Gram cores.

    u_c (..., d, R); v_c (..., R, n); g_u = U_c^T U_c; g_v = V_c V_c^T,
    both EXACTLY symmetric (``torch.linalg.eigh`` reads one triangle,
    where ``jnp.linalg.eigh`` symmetrizes its input):

        G_u = P_u diag(lam_u) P_u^T,  G_v = P_v diag(lam_v) P_v^T,
        U_c V_c = Q_u [S_u (P_u^T P_v) S_v] Q_v^T,  S = sqrt(lam).

    The SVD of the bracketed core gives the spectrum; the truncated factors
    fold Q_u / Q_v back through one product per side. The Gram squaring
    halves the attainable precision, so rank is cut at
    lam > R * eps * lam_max. Returns (B_g (..., d, r_max),
    A_g (..., r_max, n), sigma (..., r_max)).
    """
    u_c = u_c.float()
    v_c = v_c.float()
    eps = torch.finfo(torch.float32).eps
    rr = u_c.shape[-1]

    def _whiten(gram):
        with _flush_denormals(gram.device):
            lam, p = torch.linalg.eigh(gram.float())
        lam = torch.clamp(lam, min=0.0)
        keep = lam > rr * eps * lam.amax(dim=-1, keepdim=True)
        root = torch.sqrt(lam)
        s = torch.where(keep, root, torch.zeros_like(root))
        inv = torch.where(keep, 1.0 / torch.where(keep, root,
                                                  torch.ones_like(root)),
                          torch.zeros_like(root))
        return s, inv, p

    s_u, inv_u, p_u = _whiten(g_u)
    s_v, inv_v, p_v = _whiten(g_v)
    core = (s_u[..., :, None] * (p_u.mT @ p_v)) * s_v[..., None, :]
    w1, s, w2t = torch.linalg.svd(core, full_matrices=False)
    left = p_u @ (inv_u[..., :, None] * w1)                   # (..., R, R)
    right = (w2t * inv_v[..., None, :]) @ p_v.mT              # (..., R, R)
    k = min(rr, r_max)
    b_g = (u_c @ left[..., :, :k]) * s[..., None, :k]         # (..., d, k)
    a_g = right[..., :k, :] @ v_c                             # (..., k, n)
    s = s[..., :k]
    if k < r_max:
        pad = r_max - k
        b_g = F.pad(b_g, (0, pad))
        a_g = F.pad(a_g, (0, 0, 0, pad))
        s = F.pad(s, (0, pad))
    return b_g, a_g, s


def factored_from_weighted(bs: torch.Tensor, as_: torch.Tensor,
                           omega: torch.Tensor,
                           global_b: Optional[torch.Tensor] = None,
                           global_a: Optional[torch.Tensor] = None,
                           fallback: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked factors of sum_k B_k diag(omega_k) A_k [+ fallback], one
    adapter: bs (M, d, r); as_ (M, r, n); omega (M, r). The per-client
    diagonal is split sqrt-symmetrically between the two factors.
    Returns u_c (d, M*r [+ r]), v_c (matching, n)."""
    check_fallback_globals(fallback, global_b, global_a)
    m, d, r = bs.shape
    n = as_.shape[-1]
    sq = torch.sqrt(torch.clamp(omega.float(), min=0.0))       # (M, r)
    u_c = (bs.float() * sq[:, None, :]).permute(1, 0, 2).reshape(d, m * r)
    v_c = (as_.float() * sq[:, :, None]).reshape(m * r, n)
    if fallback is not None:
        fb = torch.sqrt(torch.clamp(fallback.float(), min=0.0))
        u_c = torch.cat([u_c, global_b.float() * fb[None, :]], dim=1)
        v_c = torch.cat([v_c, global_a.float() * fb[:, None]], dim=0)
    return u_c, v_c
