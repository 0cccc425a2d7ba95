"""SVD-based rank reallocation (FlexLoRA Eq. 3-4), a port of
``repro/core/svd.py``: the dense route, the factored QR route and the
Gram-core route of the kernel backend.

``svd_realloc_dense`` is the paper-faithful path: materialize the (d, n)
aggregate, full SVD, truncate to r_max. The two factored routes use that
the aggregate is always U_c @ V_c with U_c (d, R), V_c (R, n), so they
work on (R, R) cores and never form the (d, n) update:
``svd_realloc_factored`` QR-reduces both sides, ``svd_realloc_gram`` takes
the Gram cores that the kernels K1 and K2 build. Every function here takes
any number of leading batch axes (the library's SVD, QR and eigensolver
batch natively, where the reference vmaps its one-slice pipeline), and
every contraction runs in IEEE f32, never TF32 (``ieee_f32``).
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
def ieee_f32():
    """Keep the CUDA matmuls inside in IEEE f32, whatever the caller set:
    the reference contracts at f32 accuracy, and TF32 would break the
    dense route's tolerances (ROADMAP.md rules)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
    k = min(rr, r_max)
    with ieee_f32():
        core = (s_u[..., :, None] * (p_u.mT @ p_v)) * s_v[..., None, :]
        w1, s, w2t = torch.linalg.svd(core, full_matrices=False)
        left = p_u @ (inv_u[..., :, None] * w1)               # (..., R, R)
        right = (w2t * inv_v[..., None, :]) @ p_v.mT          # (..., R, R)
        b_g = (u_c @ left[..., :, :k]) * s[..., None, :k]     # (..., d, k)
        a_g = right[..., :k, :] @ v_c                         # (..., k, n)
    s = s[..., :k]
    if k < r_max:
        pad = r_max - k
        b_g = F.pad(b_g, (0, pad))
        a_g = F.pad(a_g, (0, 0, 0, pad))
        s = F.pad(s, (0, pad))
    return b_g, a_g, s


def svd_realloc_dense(dw: torch.Tensor, r_max: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paper-faithful: SVD of the dense aggregate dw (..., d, n). Returns
    (B_g = U[:, :r_max] * sigma (..., d, r_max), A_g = V^T[:r_max]
    (..., r_max, n), sigma (..., r_max))."""
    u, s, vt = torch.linalg.svd(dw.float(), full_matrices=False)
    u, s, vt = u[..., :r_max], s[..., :r_max], vt[..., :r_max, :]
    return u * s[..., None, :], vt, s


def svd_realloc_factored(u_c: torch.Tensor, v_c: torch.Tensor, r_max: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD of U_c @ V_c without forming it, through QR of both sides:
    U_c = Q_u R_u, V_c^T = Q_v R_v, U_c V_c = Q_u (R_u R_v^T) Q_v^T, so the
    spectrum is the (R, R) core's. u_c (..., d, R); v_c (..., R, n).
    Returns (B_g (..., d, r_max), A_g (..., r_max, n), sigma). If
    R < r_max the trailing singular values are exactly zero and the
    factors are zero-padded (the aggregate has algebraic rank <= R)."""
    u_c = u_c.float()
    v_c = v_c.float()
    with ieee_f32():
        q_u, r_u = torch.linalg.qr(u_c)                 # (..., d, R), (R, R)
        q_v, r_v = torch.linalg.qr(v_c.mT)              # (..., n, R), (R, R)
        u_s, s, vt_s = torch.linalg.svd(r_u @ r_v.mT, full_matrices=False)
        u_full = q_u @ u_s                              # (..., d, R)
        vt_full = vt_s @ q_v.mT                         # (..., R, n)
    r = u_c.shape[-1]
    if r >= r_max:
        u_full = u_full[..., :r_max]
        vt_full = vt_full[..., :r_max, :]
        s = s[..., :r_max]
    else:
        pad = r_max - r
        u_full = F.pad(u_full, (0, pad))
        vt_full = F.pad(vt_full, (0, 0, 0, pad))
        s = F.pad(s, (0, pad))
    return u_full * s[..., None, :], vt_full, s


def factored_stack_batched(bs: torch.Tensor, as_: torch.Tensor,
                           omega: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked factors of sum_k B_k diag(omega_k) A_k for any batch
    axes between the client and matrix axes: bs (M, *B, d, r); as_
    (M, *B, r, n); omega (M, r). The per-client diagonal is split
    sqrt-symmetrically between the two factors. Returns u_c (*B, d, M*r),
    client-major column blocks, and v_c (*B, M*r, n)."""
    m, r = bs.shape[0], bs.shape[-1]
    d, n = bs.shape[-2], as_.shape[-1]
    lead = tuple(bs.shape[1:-2])
    sq = torch.sqrt(torch.clamp(omega.float(), min=0.0))       # (M, r)
    u_parts = bs.float() * sq.reshape((m,) + (1,) * len(lead) + (1, r))
    v_parts = as_.float() * sq.reshape((m,) + (1,) * len(lead) + (r, 1))
    u_c = u_parts.movedim(0, -2).reshape(lead + (d, m * r))
    v_c = v_parts.movedim(0, -3).reshape(lead + (m * r, n))
    return u_c, v_c


def factored_append_fallback(u_c: torch.Tensor, v_c: torch.Tensor,
                             global_b: torch.Tensor, global_a: torch.Tensor,
                             fallback: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append the Eq. 8 empty-partition fallback columns to a (batched)
    factored stack: u_c (*B, d, R), global_b (*B, d, r_max)."""
    fb = torch.sqrt(torch.clamp(fallback.float(), min=0.0))
    u_c = torch.cat([u_c, global_b.float() * fb[None, :]], dim=-1)
    v_c = torch.cat([v_c, global_a.float() * fb[:, None]], dim=-2)
    return u_c, v_c


def factored_from_weighted(bs: torch.Tensor, as_: torch.Tensor,
                           omega: torch.Tensor,
                           global_b: Optional[torch.Tensor] = None,
                           global_a: Optional[torch.Tensor] = None,
                           fallback: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``factored_stack_batched`` plus the Eq. 8 fallback columns: bs
    (M, *B, d, r); as_ (M, *B, r, n); omega (M, r). Returns u_c
    (*B, d, M*r [+ r]), v_c (matching, n)."""
    check_fallback_globals(fallback, global_b, global_a)
    u_c, v_c = factored_stack_batched(bs, as_, omega)
    if fallback is not None:
        u_c, v_c = factored_append_fallback(u_c, v_c, global_b, global_a,
                                            fallback)
    return u_c, v_c


def dense_fallback_term(global_b: torch.Tensor, global_a: torch.Tensor,
                        fallback: torch.Tensor) -> torch.Tensor:
    """The Eq. 8 empty-partition term G_B diag(fallback) G_A, for global
    factors with any leading batch axes."""
    with ieee_f32():
        return torch.einsum("...dr,r,...rn->...dn", global_b.float(),
                            fallback.float(), global_a.float())


def dense_from_weighted(bs: torch.Tensor, as_: torch.Tensor,
                        omega: torch.Tensor,
                        global_b: Optional[torch.Tensor] = None,
                        global_a: Optional[torch.Tensor] = None,
                        fallback: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Materialize sum_k B_k diag(omega_k) A_k (+ the global fallback
    slices): bs (M, *B, d, r); as_ (M, *B, r, n) -> (*B, d, n) f32."""
    check_fallback_globals(fallback, global_b, global_a)
    with ieee_f32():
        dw = torch.einsum("m...dr,mr,m...rn->...dn", bs.float(),
                          omega.float(), as_.float())
    if fallback is not None:
        dw = dw + dense_fallback_term(global_b, global_a, fallback)
    return dw
