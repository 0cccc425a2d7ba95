"""Fused factored aggregation kernels K1 and K2 (DESIGN.md §4.3), ported
from ``repro/kernels/rank_partition_agg.py``.

The aggregate sum_m B_m diag(omega_m) A_m is always U_c @ V_c with U_c
(d, M r) the sqrt(omega)-weighted client B columns and V_c (M r, n) the
matching A rows, so the round never forms the (d, n) update:

* K1 ``weighted_stack_b`` / ``weighted_stack_a`` build U_c / V_c
  (``csrc/weighted_stack.cu``; replaces ``weighted_stack_b_layered_pallas``
  and ``weighted_stack_a_layered_pallas``);
* K2 ``gram_left`` / ``gram_right`` build their (R, R) Gram cores
  G_u = U_c^T U_c and G_v = V_c V_c^T (``csrc/gram.cu``; replaces
  ``gram_left_layered_pallas`` and ``gram_right_layered_pallas``).

Each kernel has a plain PyTorch version here (``*_plain``) and a wrapper.
The wrapper checks its inputs and allocates the output; for a CPU tensor
it computes the plain version, for a CUDA tensor it launches the kernel
(there is no fallback: a failed launch raises). ``wrapper.launches``
counts kernel launches and nothing else. The bound of each kernel on the
card and what its design does about it are noted in its CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


# -- plain versions ----------------------------------------------------------

def _sqrt_weights(omega: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(omega, min=0.0))


def weighted_stack_b_plain(bs: torch.Tensor, omega: torch.Tensor
                           ) -> torch.Tensor:
    """bs (L, M, d, r); omega (M, r) -> U_c (L, d, M*r), client-major
    column blocks."""
    l, m, d, r = bs.shape
    u = bs * _sqrt_weights(omega)[None, :, None, :]
    return u.permute(0, 2, 1, 3).reshape(l, d, m * r)


def weighted_stack_a_plain(as_: torch.Tensor, omega: torch.Tensor
                           ) -> torch.Tensor:
    """as_ (L, M, r, n); omega (M, r) -> V_c (L, M*r, n)."""
    l, m, r, n = as_.shape
    return (as_ * _sqrt_weights(omega)[None, :, :, None]).reshape(l, m * r, n)


def _mirror_upper(g: torch.Tensor) -> torch.Tensor:
    """Exactly symmetric Gram: the upper triangle mirrored onto the lower
    (a library product need not round (i, j) and (j, i) alike, and
    ``torch.linalg.eigh`` reads only one triangle)."""
    upper = torch.triu(g)
    return upper + torch.triu(g, diagonal=1).mT


def gram_left_plain(u_c: torch.Tensor) -> torch.Tensor:
    """u_c (L, d, R) -> G_u = U_c^T U_c (L, R, R)."""
    return _mirror_upper(u_c.mT @ u_c)


def gram_right_plain(v_c: torch.Tensor) -> torch.Tensor:
    """v_c (L, R, n) -> G_v = V_c V_c^T (L, R, R)."""
    return _mirror_upper(v_c @ v_c.mT)


# -- wrappers ----------------------------------------------------------------

def _check(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _same_device(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.device != b.device:
        raise ValueError(f"{name}: inputs on {a.device} and {b.device}")


def weighted_stack_b(bs: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """K1 (B side): bs (L, M, d, r); omega (M, r) -> U_c (L, d, M*r)."""
    _check("weighted_stack_b bs", bs, 4)
    _check("weighted_stack_b omega", omega, 2)
    _same_device(bs, omega, "weighted_stack_b")
    l, m, d, r = bs.shape
    if tuple(omega.shape) != (m, r):
        raise ValueError(f"omega {tuple(omega.shape)} != {(m, r)}")
    if bs.device.type == "cpu":
        return weighted_stack_b_plain(bs, omega)
    u = torch.empty((l, d, m * r), dtype=torch.float32, device=bs.device)
    fn = "weighted_stack_b_f32"
    rc = getattr(build.library("weighted_stack"), fn)(
        bs.data_ptr(), omega.data_ptr(), u.data_ptr(), l, m, d, r,
        _stream(bs))
    build.check(rc, fn)
    weighted_stack_b.launches += 1
    return u


def weighted_stack_a(as_: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """K1 (A side): as_ (L, M, r, n); omega (M, r) -> V_c (L, M*r, n)."""
    _check("weighted_stack_a as_", as_, 4)
    _check("weighted_stack_a omega", omega, 2)
    _same_device(as_, omega, "weighted_stack_a")
    l, m, r, n = as_.shape
    if tuple(omega.shape) != (m, r):
        raise ValueError(f"omega {tuple(omega.shape)} != {(m, r)}")
    if as_.device.type == "cpu":
        return weighted_stack_a_plain(as_, omega)
    v = torch.empty((l, m * r, n), dtype=torch.float32, device=as_.device)
    fn = "weighted_stack_a_f32"
    rc = getattr(build.library("weighted_stack"), fn)(
        as_.data_ptr(), omega.data_ptr(), v.data_ptr(), l, m, r, n,
        _stream(as_))
    build.check(rc, fn)
    weighted_stack_a.launches += 1
    return v


def gram_left(u_c: torch.Tensor) -> torch.Tensor:
    """K2 (left): u_c (L, d, R) -> G_u (L, R, R), exactly symmetric."""
    _check("gram_left u_c", u_c, 3)
    l, d, rr = u_c.shape
    if u_c.device.type == "cpu":
        return gram_left_plain(u_c)
    g = torch.empty((l, rr, rr), dtype=torch.float32, device=u_c.device)
    fn = "gram_left_f32"
    rc = getattr(build.library("gram"), fn)(
        u_c.data_ptr(), g.data_ptr(), l, d, rr, _stream(u_c))
    build.check(rc, fn)
    gram_left.launches += 1
    return g


def gram_right(v_c: torch.Tensor) -> torch.Tensor:
    """K2 (right): v_c (L, R, n) -> G_v (L, R, R), exactly symmetric."""
    _check("gram_right v_c", v_c, 3)
    l, rr, n = v_c.shape
    if v_c.device.type == "cpu":
        return gram_right_plain(v_c)
    g = torch.empty((l, rr, rr), dtype=torch.float32, device=v_c.device)
    fn = "gram_right_f32"
    rc = getattr(build.library("gram"), fn)(
        v_c.data_ptr(), g.data_ptr(), l, n, rr, _stream(v_c))
    build.check(rc, fn)
    gram_right.launches += 1
    return g


KERNELS = (weighted_stack_b, weighted_stack_a, gram_left, gram_right)
for _k in KERNELS:
    _k.launches = 0
