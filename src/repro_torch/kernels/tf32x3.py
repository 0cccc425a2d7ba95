"""The 3xTF32 arithmetic of ``csrc/mma_tf32x3.cuh`` in PyTorch, for the
plain versions that repeat the precision of K5's tensor-core route and of
K7 (``lora_apply.lora_apply_tf32x3_plain``,
``flash_attention.flash_attention_tf32x3_plain``).

Each f32 operand is split in two TF32 values, hi = rna(a) and
lo = rna(a - hi), rna rounding to the nearest TF32 value (10 mantissa
bits) with ties away from zero on the int32 view, as ``cvt.rna.tf32.f32``
does (the card rounds lo with that instruction). A product is summed as
lo_a hi_b + hi_a lo_b + hi_a hi_b: every TF32 x TF32 product is exact in
f32, so the three f32 matrix products here hold the same terms as the
kernels' three tensor-core passes, summed in another order.

A product with an infinite or NaN operand comes out NaN from the passes
(where a - hi is NaN, lo is NaN); the kernels then sum each NaN output
again in IEEE f32, so ``matmul`` replaces its NaN outputs by the f32
product's: +-inf, or NaN for inf * 0, opposite infinities and NaN
operands, where the f32 product has them. Finite outputs are the three
passes' sums, bit for bit.

``one_pass_matmul`` and ``one_pass_sigma`` are the yardstick that tells
the three passes from one: the most accurate one-pass TF32 product, and
the spread of its error.
"""
from __future__ import annotations

import torch

_ROUND = 0x1000           # half of the 13 mantissa bits TF32 drops
_KEEP = -0x2000           # 0xffffe000 as an int32: sign, exponent, 10 bits


def _rna(a: torch.Tensor) -> torch.Tensor:
    """a rounded to TF32 on the int32 view (the sum wraps as the card's
    unsigned add does)."""
    return ((a.view(torch.int32) + _ROUND) & _KEEP).view(torch.float32)


def split_tf32(a: torch.Tensor) -> tuple:
    """(hi, lo) f32 tensors holding TF32 values with a ~ hi + lo: hi + lo is
    within 2^-22 |a| of a, and each has its low 13 mantissa bits zero; an
    infinite or NaN a has a NaN lo."""
    a = a.float().contiguous()
    hi = _rna(a)
    d = (a - hi).contiguous()
    return hi, torch.where(torch.isnan(d), d, _rna(d))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (f32, batched as ``@`` is) from the three TF32 passes, each
    NaN output summed again in IEEE f32 (the kernels' repair)."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = al @ bh + ah @ bl + ah @ bh
    nan = torch.isnan(out)
    return torch.where(nan, a.float() @ b.float(), out) if bool(nan.any()) \
        else out


def one_pass_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from one TF32 pass at its most accurate: the operands' hi
    parts multiplied and summed in f64 (an f64 tensor)."""
    return split_tf32(a)[0].double() @ split_tf32(b)[0].double()


def one_pass_sigma(a: torch.Tensor, b: torch.Tensor) -> float:
    """The standard deviation of a one-pass TF32 product's error at a @ b's
    largest output scale. Rounding an operand to TF32 leaves a relative
    error spread evenly over +-2^-11, of variance 2^-22 / 3, so a term
    a_ik b_kj errs with variance (2 / 3) 2^-22 a_ik^2 b_kj^2 and output
    (i, j) with standard deviation 2^-11 sqrt(2 / 3) sqrt(sum_k a_ik^2
    b_kj^2); the largest over the outputs. An f32-accurate product stays
    far inside it at every output; a one-pass product's largest error over
    more than a few outputs lies beyond it."""
    a2, b2 = a.double().square(), b.double().square()
    return 2.0 ** -11 * (2.0 / 3.0) ** 0.5 * float((a2 @ b2).max()) ** 0.5
