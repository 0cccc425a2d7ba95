"""K6's chunk-parallel decomposition (``repro_torch.kernels.ssd_scan``) held
to the JAX package on shared numpy inputs: the plain form the kernel
computes (C B^T once per group, chunk-local states, the in-order carry,
then every chunk's outputs), the same form with the kernel's 3xTF32
products (``ssd_scan_tf32x3_plain``), the kernel's host plan
(``plan_scan``) and the yardstick that tells 3xTF32 from one TF32 pass.

Tolerance: the reference's own for the scan, atol 2e-4, rtol 1e-3
(``tests/test_kernels.py::TestSSDScanKernel``). The kernel itself runs on
the card only (``test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ssd_scan as k6
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

SCAN_TOL = dict(atol=2e-4, rtol=1e-3)
FORMS = {"parallel": k6.ssd_scan_parallel_plain,
         "tf32x3": k6.ssd_scan_tf32x3_plain}
# (B, L, H, P, G, N, chunk): the odd one (3 groups, P 24, N 20, Q 32),
# hymba's P 50 (2 groups, Q 40), one chunk (nc = 1), four chunks of 16
SHAPES = {"odd-g3-p24-n20": (2, 96, 12, 24, 3, 20, 32),
          "hymba-p50": (2, 80, 4, 50, 2, 16, 40),
          "nc1": (1, 32, 4, 8, 2, 16, 32),
          "nc4": (1, 64, 4, 16, 1, 32, 16)}


def _inputs(seed, bsz, length, nheads, hp, groups, n, init):
    """x, dt (post-softplus), a_log, b, c, d_skip and the initial state (or
    None) as numpy f32, the reference test's distributions."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(bsz, length, nheads, hp)),
            np.log1p(np.exp(rng.normal(size=(bsz, length, nheads)))),
            0.5 * rng.normal(size=(nheads,)),
            0.3 * rng.normal(size=(bsz, length, groups, n)),
            0.3 * rng.normal(size=(bsz, length, groups, n)),
            rng.normal(size=(nheads,))]
    state = rng.normal(size=(bsz, nheads, hp, n)) if init else None
    arrs = [a.astype(np.float32) for a in arrs]
    return arrs, None if state is None else state.astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a.copy())


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_chunk_parallel_forms_match_references(name, init, form):
    """Each form against the token-by-token recurrence and the reference's
    chunked form, y and the final state."""
    bsz, length, nheads, hp, groups, n, chunk = SHAPES[name]
    arrs, state = _inputs(len(name) + init, bsz, length, nheads, hp, groups,
                          n, init)
    y, s = FORMS[form](*map(_t, arrs), chunk, init_state=_t(state))
    assert y.shape == (bsz, length, nheads, hp) and y.dtype == torch.float32
    assert s.shape == (bsz, nheads, hp, n) and s.dtype == torch.float32
    for ref_y, ref_s in (
            jref.ssd_scan_sequential_ref(*map(_j, arrs),
                                         init_state=_j(state)),
            jref.ssd_scan_ref(*map(_j, arrs), chunk, init_state=_j(state))):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **SCAN_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), **SCAN_TOL)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("name", ["nc1", "nc4"])
def test_chunk_parallel_forms_match_reference_pallas_kernel(name, form):
    """Each form against the reference's Pallas ``ops.ssd_scan`` (interpret
    mode on the CPU), with an initial state."""
    bsz, length, nheads, hp, groups, n, chunk = SHAPES[name]
    arrs, state = _inputs(7, bsz, length, nheads, hp, groups, n, True)
    y, s = FORMS[form](*map(_t, arrs), chunk, init_state=_t(state))
    jy, js = jops.ssd_scan(*map(_j, arrs), chunk=chunk,
                           init_state=_j(state))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCAN_TOL)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_chunk_parallel_carry_continues(form):
    """Scanning the first half, then the second half from its final state,
    equals one scan of the whole (the prefill-continuation invariant)."""
    arrs, _ = _inputs(5, 1, 64, 4, 8, 1, 16, False)
    x, dt, alog, b, c, d = map(_t, arrs)
    scan = FORMS[form]
    y1, s1 = scan(x[:, :32], dt[:, :32], alog, b[:, :32], c[:, :32], d, 16)
    y2, s2 = scan(x[:, 32:], dt[:, 32:], alog, b[:, 32:], c[:, 32:], d, 16,
                  init_state=s1)
    y, s = scan(x, dt, alog, b, c, d, 16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **SCAN_TOL)


def test_groups_share_one_cb_product():
    """C B^T is computed once per (batch, chunk, group) and broadcast to
    the group's heads: a recording product sees (B, nc, G, Q, Q) for it,
    and the heads' products see G x (H / G) leading axes."""
    arrs, _ = _inputs(9, 2, 64, 6, 8, 3, 16, False)
    shapes = []

    def record(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return a @ b
    k6._scan_chunk_parallel(*map(_t, arrs), 32, None, record)
    assert shapes[0] == ((2, 2, 3, 32, 16), (2, 2, 3, 16, 32))   # C B^T
    assert [s[0][:4] for s in shapes[1:]] == [(2, 2, 3, 2)] * 3


@pytest.mark.parametrize("shape", [(2, 96, 12, 24, 3, 20, 32),
                                   (1, 512, 4, 64, 1, 128, 256)],
                         ids=["odd", "mamba2-width"])
def test_tf32x3_form_is_f32_accurate_and_one_pass_is_not(shape):
    """The yardstick of the card check, on the card check's data (dt about
    0.02 and A about -0.4, so a chunk's state carries into the next): against
    a float64 run, the 3xTF32 form's y stays inside ``one_pass_bound`` (a
    one-pass TF32 run's error sigma plus f32's rounding bound) at every
    output, by far, and the one-pass run leaves it."""
    bsz, length, nheads, hp, groups, n, chunk = shape
    arrs, _ = _inputs(11, bsz, length, nheads, hp, groups, n, False)
    arrs[1] = np.log1p(np.exp(np.log(np.expm1(arrs[1])) - 4.0))
    arrs[2] = arrs[2] - 1.0
    arrs = list(map(_t, arrs))
    want = k6.ssd_scan_f64(*arrs, chunk)[0]
    assert want.dtype == torch.float64
    bound = k6.one_pass_bound(*arrs, chunk)
    assert bound.shape == want.shape
    y = k6.ssd_scan_tf32x3_plain(*arrs, chunk)[0]
    one_pass = k6.ssd_scan_one_pass_tf32(*arrs, chunk)[0]
    assert float(((y.double() - want).abs() / bound).max()) <= 0.1
    assert float(((one_pass - want).abs() / bound).max()) > 1


# -- the plan -----------------------------------------------------------

def test_plan_scan_at_mamba2_prefill():
    """mamba2-1.3b's prefill layer (B 4, L 1024, H 64, P 64, G 1, N 128,
    chunk 256): five launches (the last the repair of NaN outputs); 10 C
    B^T tiles a (batch, chunk, group), one state job a (batch, chunk,
    head), two 128-row output tiles of it; the work done, 13.04 GFLOP,
    against the recurrence's 8.59; the scratch ends with the max |C| and
    max |B| of the 4 diagonal C B^T tiles a (batch, chunk, group), then
    the repair's flags, the call's and one a (batch, chunk, head), rounded
    up to 4."""
    plan = k6.plan_scan(4, 1024, 64, 64, 1, 128, 256)
    assert plan.launches == 5
    assert (plan.chunks, plan.slices, plan.slice_rows) == (4, 1, 64)
    assert (plan.n_width, plan.p_width) == (128, 64)
    assert (plan.cb_blocks, plan.state_blocks, plan.carry_blocks,
            plan.out_blocks) == (160, 1024, 2048, 2048)
    assert plan.scratch_floats == 4 * 4 * 256 * 256 + 1024 * 256 \
        + 1024 * 64 * 128 + 2 * 4 * 4 * 4 + 1028
    assert plan.flop == pytest.approx(13.036e9, rel=1e-3)
    rep = plan.report()
    assert rep["route"] == "mma_tf32x3" and rep["launches"] == 5
    assert rep["blocks"]["out"] == 2048 and rep["blocks"]["repair"] == 64


@pytest.mark.parametrize("shape,want", [
    ((2, 96, 12, 24, 3, 20, 32), (3, 1, 24, 32, 32, 18, 72, 72)),
    ((2, 200, 4, 50, 2, 16, 40), (5, 1, 50, 16, 64, 20, 40, 40)),
    ((1, 64, 2, 128, 1, 16, 64), (1, 2, 64, 16, 64, 1, 4, 4)),
    ((1, 24, 4, 8, 2, 16, 24), (1, 1, 8, 16, 16, 2, 4, 4))])
def test_plan_scan_odd_shapes(shape, want):
    """(chunks, slices, slice rows, state width, slice width, C B^T, state
    and output blocks): P 128 cut in two slices of 64, ragged P and N
    rounded up to the instances' widths, one 64-tile of C B^T a group
    below 64 tokens, and the scratch covers C B^T (Q rounded up to 64),
    the cumsums, the states, the diagonal tiles' max |C| and max |B| and
    the repair's flags."""
    plan = k6.plan_scan(*shape)
    got = (plan.chunks, plan.slices, plan.slice_rows, plan.n_width,
           plan.p_width, plan.cb_blocks, plan.state_blocks, plan.out_blocks)
    assert got == want
    bsz, length, h, p, g, n, q = shape
    jobs = bsz * (length // q) * h
    qp = -(-q // 64) * 64
    assert plan.scratch_floats >= bsz * (length // q) * g * qp * qp \
        + jobs * q + jobs * p * n + 2 * bsz * (length // q) * g * qp // 64 \
        + 1 + jobs


def test_plan_scan_refuses_a_wide_state():
    with pytest.raises(ValueError, match="state width"):
        k6.plan_scan(1, 64, 2, 8, 1, 130, 32)
