"""The port's dense and factored SVD reallocation and its stack helpers
(``repro_torch.core.svd``) held to ``repro.core.svd`` on the cases of
tests/test_svd.py and tests/test_aggregation.py: the same numpy inputs
through both packages, spectra and products B_g A_g (sign-stable, unlike
raw SVD factors) at the reference's 1e-4, the stack builders to float
rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svd as jsvd
from repro.core.partitions import omega_flexlora, omega_raflora
from repro_torch.core import svd as tsvd

LEVELS = [4, 8, 16]
R_MAX = 16
D, N = 24, 40

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


def _stack(seed, ranks, lead=()):
    """Zero-padded client stacks bs (M, *lead, D, R_MAX), as_ (M, *lead,
    R_MAX, N), zero beyond each client's rank."""
    rng = np.random.default_rng(seed)
    bs = rng.normal(size=(len(ranks),) + lead + (D, R_MAX))
    as_ = rng.normal(size=(len(ranks),) + lead + (R_MAX, N))
    for k, r in enumerate(ranks):
        bs[k, ..., r:] = 0.0
        as_[k, ..., r:, :] = 0.0
    return bs.astype(np.float32), as_.astype(np.float32)


def _globals(seed, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (D, R_MAX)).astype(np.float32),
            rng.normal(size=lead + (R_MAX, N)).astype(np.float32))


def _t(*xs):
    return tuple(None if x is None else torch.from_numpy(np.asarray(x))
                 for x in xs)


def _j(*xs):
    return tuple(None if x is None else jnp.asarray(x) for x in xs)


def _assert_realloc(t_res, j_res, atol=1e-4):
    (tb, ta, ts), (jb, ja, js) = t_res, j_res
    assert tuple(tb.shape) == jb.shape and tuple(ta.shape) == ja.shape
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=atol)
    np.testing.assert_allclose((tb @ ta).numpy(),
                               np.asarray(jb) @ np.asarray(ja), atol=atol)


@pytest.mark.parametrize("seed,ranks", [(0, [4, 8, 16]),
                                        (1, [4, 4, 8, 8, 16, 16]),
                                        (2, [16]), (3, [4] * 5)])
def test_dense_and_factored_realloc_match_reference(seed, ranks):
    """FlexLoRA-weighted heterogeneous stacks through both routes of both
    packages; the port's two routes agree with each other too."""
    bs, as_ = _stack(seed, ranks)
    omega = omega_flexlora(ranks, np.linspace(5, 30, len(ranks)), R_MAX)
    dw_t = tsvd.dense_from_weighted(*_t(bs, as_, omega))
    dw_j = jsvd.dense_from_weighted(*_j(bs, as_, omega))
    np.testing.assert_allclose(dw_t.numpy(), np.asarray(dw_j), atol=1e-5)
    dense_t = tsvd.svd_realloc_dense(dw_t, R_MAX)
    _assert_realloc(dense_t, jsvd.svd_realloc_dense(dw_j, R_MAX))
    uv_t = tsvd.factored_from_weighted(*_t(bs, as_, omega))
    uv_j = jsvd.factored_from_weighted(*_j(bs, as_, omega))
    fact_t = tsvd.svd_realloc_factored(*uv_t, R_MAX)
    _assert_realloc(fact_t, jsvd.svd_realloc_factored(*uv_j, R_MAX))
    _assert_realloc(fact_t, tuple(x.numpy() for x in dense_t))


def test_fallback_augmented_stack_matches_reference():
    """raFLoRA's Eq. 8 fallback enters the dense term and the factored
    stack as in the reference, and both routes agree."""
    ranks = [4, 4]                       # partitions (4, 8], (8, 16] empty
    bs, as_ = _stack(7, ranks)
    omega, fb = omega_raflora(ranks, [3.0, 5.0], LEVELS)
    assert fb.any()
    g_b, g_a = _globals(99)
    args = (bs, as_, omega, g_b, g_a, fb)
    dw_t = tsvd.dense_from_weighted(*_t(*args))
    np.testing.assert_allclose(
        dw_t.numpy(), np.asarray(jsvd.dense_from_weighted(*_j(*args))),
        atol=1e-5)
    np.testing.assert_allclose(
        tsvd.dense_fallback_term(*_t(g_b, g_a, fb)).numpy(),
        np.asarray(jsvd.dense_fallback_term(*_j(g_b, g_a, fb))), atol=1e-5)
    u_t, v_t = tsvd.factored_from_weighted(*_t(*args))
    u_j, v_j = jsvd.factored_from_weighted(*_j(*args))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-6)
    fact_t = tsvd.svd_realloc_factored(u_t, v_t, R_MAX)
    _assert_realloc(fact_t, jsvd.svd_realloc_factored(u_j, v_j, R_MAX))
    _assert_realloc(fact_t, tuple(
        x.numpy() for x in tsvd.svd_realloc_dense(dw_t, R_MAX)))
    with pytest.raises(ValueError, match="global"):
        tsvd.dense_from_weighted(*_t(bs, as_, omega, None, None, fb))


def test_factored_zero_pads_rank_deficient():
    """R < r_max: trailing singular values and factor columns exactly
    zero, as in the reference; the product is U_c V_c."""
    rng = np.random.default_rng(5)
    u_c = rng.normal(size=(D, 6)).astype(np.float32)
    v_c = rng.normal(size=(6, N)).astype(np.float32)
    b, a, s = tsvd.svd_realloc_factored(*_t(u_c, v_c), R_MAX)
    assert tuple(b.shape) == (D, R_MAX) and tuple(a.shape) == (R_MAX, N)
    assert bool((s[6:] == 0).all()) and not bool(b[:, 6:].any())
    assert not bool(a[6:].any())
    np.testing.assert_allclose((b @ a).numpy(), u_c @ v_c, atol=1e-4)
    _assert_realloc((b, a, s), jsvd.svd_realloc_factored(
        *_j(u_c, v_c), R_MAX))


def test_dense_and_factored_identical_spectrum():
    """tests/test_aggregation.py::test_factored_svd_identical_spectrum."""
    rng = np.random.default_rng(3)
    u_c = rng.normal(size=(D, 12)).astype(np.float32)
    v_c = rng.normal(size=(12, N)).astype(np.float32)
    dense = tsvd.svd_realloc_dense(torch.from_numpy(u_c @ v_c), R_MAX)
    fact = tsvd.svd_realloc_factored(*_t(u_c, v_c), R_MAX)
    _assert_realloc(dense, tuple(x.numpy() for x in fact))


def test_batched_helpers_match_reference_and_slices():
    """The batch-axis builders (M, 2, 3, d, r) against the reference's and
    against the per-slice 3-D path; the batched SVDs against a loop."""
    ranks = [4, 8, 16]
    lead = (2, 3)
    bs, as_ = _stack(21, ranks, lead)
    omega, fb = omega_raflora(ranks, [2.0, 3.0, 4.0], LEVELS)
    g_b, g_a = _globals(22, lead)
    u_t, v_t = tsvd.factored_stack_batched(*_t(bs, as_, omega))
    u_j, v_j = jsvd.factored_stack_batched(*_j(bs, as_, omega))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-6)
    fb = np.linspace(0.0, 1.0, R_MAX).astype(np.float32)
    uf_t, vf_t = tsvd.factored_append_fallback(u_t, v_t, *_t(g_b, g_a, fb))
    uf_j, vf_j = jsvd.factored_append_fallback(u_j, v_j, *_j(g_b, g_a, fb))
    np.testing.assert_allclose(uf_t.numpy(), np.asarray(uf_j), rtol=1e-6)
    np.testing.assert_allclose(vf_t.numpy(), np.asarray(vf_j), rtol=1e-6)
    dw_t = tsvd.dense_from_weighted(*_t(bs, as_, omega, g_b, g_a, fb))
    term_j = jsvd.dense_fallback_term(*_j(g_b, g_a, fb))
    fact_b = tsvd.svd_realloc_factored(uf_t, vf_t, R_MAX)
    dense_b = tsvd.svd_realloc_dense(dw_t, R_MAX)
    for i in range(lead[0]):
        for j in range(lead[1]):
            sl = (slice(None), i, j)
            dw_ij = jsvd.dense_from_weighted(*_j(
                bs[sl], as_[sl], omega, g_b[i, j], g_a[i, j], fb))
            np.testing.assert_allclose(dw_t[i, j].numpy(),
                                       np.asarray(dw_ij), atol=1e-5)
            np.testing.assert_allclose(
                np.asarray(term_j[i, j]),
                np.asarray(jsvd.dense_fallback_term(*_j(
                    g_b[i, j], g_a[i, j], fb))), atol=1e-6)
            want = jsvd.svd_realloc_dense(dw_ij, R_MAX)
            _assert_realloc(tuple(x[i, j] for x in dense_b), want)
            _assert_realloc(tuple(x[i, j] for x in fact_b), want)
