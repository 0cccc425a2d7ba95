"""Kernels K1 (sqrt(omega)-weighted stacks) and K2 (Gram cores) of the
PyTorch port, held to the JAX package's oracles (``kernels/ref.py``) and
to one interpret-mode call of its fused Pallas entry point.

On the CPU every wrapper takes its kernel's plain PyTorch version; the
kernel-vs-plain cases live in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import svd as jsvd
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.core import svd as tsvd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rank_partition_agg as rpa

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


def _stacks(seed, layers, m, d, r, n):
    rng = np.random.default_rng(seed)
    bs = rng.normal(size=(layers, m, d, r)).astype(np.float32)
    as_ = rng.normal(size=(layers, m, r, n)).astype(np.float32)
    omega = rng.uniform(size=(m, r)).astype(np.float32)
    omega[0, r // 2:] = 0.0           # a low-rank client
    omega[-1, 0] = -0.5               # clamped to 0 by sqrt(max(., 0))
    return bs, as_, omega


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


SHAPES = [(2, 3, 24, 8, 40), (1, 3, 300, 8, 520), (2, 2, 17, 12, 9)]


@pytest.mark.parametrize("layers,m,d,r,n", SHAPES)
def test_weighted_stacks_match_oracle(layers, m, d, r, n):
    """K1 plain versions vs ``ref.factored_stack_ref`` per layer, including
    the odd d=300, n=520 extents of TestPadToTile. Elementwise f32 sqrt and
    multiply on both sides: agreement to 1e-6 relative."""
    bs, as_, omega = _stacks(0, layers, m, d, r, n)
    u = rpa.weighted_stack_b(_t(bs), _t(omega)).numpy()
    v = rpa.weighted_stack_a(_t(as_), _t(omega)).numpy()
    assert u.shape == (layers, d, m * r) and v.shape == (layers, m * r, n)
    for ll in range(layers):
        u_ref, v_ref = ref.factored_stack_ref(jnp.asarray(bs[ll]),
                                              jnp.asarray(as_[ll]),
                                              jnp.asarray(omega))
        np.testing.assert_allclose(u[ll], np.asarray(u_ref), rtol=1e-6)
        np.testing.assert_allclose(v[ll], np.asarray(v_ref), rtol=1e-6)


@pytest.mark.parametrize("layers,d,rr,n", [(2, 24, 24, 40), (1, 300, 24, 520),
                                           (1, 100, 256, 132)])
def test_gram_cores_match_oracle_and_are_symmetric(layers, d, rr, n):
    """K2 plain versions vs ``ref.gram_cores_ref`` (TestPadToTile's
    atol=2e-3, rtol=1e-5: f32 sums in another order), and EXACTLY
    symmetric, as ``torch.linalg.eigh`` reads one triangle."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(layers, d, rr)).astype(np.float32)
    v = rng.normal(size=(layers, rr, n)).astype(np.float32)
    g_u = rpa.gram_left(_t(u)).numpy()
    g_v = rpa.gram_right(_t(v)).numpy()
    for ll in range(layers):
        gu_ref, gv_ref = ref.gram_cores_ref(jnp.asarray(u[ll]),
                                            jnp.asarray(v[ll]))
        np.testing.assert_allclose(g_u[ll], np.asarray(gu_ref),
                                   atol=2e-3, rtol=1e-5)
        np.testing.assert_allclose(g_v[ll], np.asarray(gv_ref),
                                   atol=2e-3, rtol=1e-5)
        assert np.array_equal(g_u[ll], g_u[ll].T)
        assert np.array_equal(g_v[ll], g_v[ll].T)


@pytest.mark.parametrize("with_fallback", [False, True])
def test_fused_entry_matches_pallas_interpret(with_fallback):
    """``ops.factored_stack_gram_layered`` of both packages on one small
    bucket (r=5 pads to 8; the Eq. 8 fallback rides as client M+1). The
    JAX side runs its Pallas grids in interpret mode. Stacks agree to 1e-6
    relative, Gram cores to TestPadToTile's atol=1e-3, rtol=1e-5."""
    layers, m, d, r, n = 2, 3, 20, 5, 36
    bs, as_, omega = _stacks(2, layers, m, d, r, n)
    rng = np.random.default_rng(3)
    gb = ga = fb = None
    if with_fallback:
        gb = rng.normal(size=(layers, d, r)).astype(np.float32)
        ga = rng.normal(size=(layers, r, n)).astype(np.float32)
        fb = np.array([0, 0, 1, 1, 1], np.float32)
    j = jops.factored_stack_gram_layered(
        jnp.asarray(bs), jnp.asarray(as_), jnp.asarray(omega),
        None if gb is None else jnp.asarray(gb),
        None if ga is None else jnp.asarray(ga),
        None if fb is None else jnp.asarray(fb))
    t = tops.factored_stack_gram_layered(
        _t(bs), _t(as_), _t(omega), None if gb is None else _t(gb),
        None if ga is None else _t(ga), None if fb is None else _t(fb))
    width = (m + with_fallback) * 8
    assert t[0].shape == (layers, d, width)
    for got, want, tol in zip(t, j, [dict(rtol=1e-6)] * 2
                              + [dict(atol=1e-3, rtol=1e-5)] * 2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("with_fallback", [False, True])
def test_factored_from_weighted_matches_reference(with_fallback):
    """The one-adapter stack assembly of ``core/svd.py`` (the layout every
    stack above reuses): same columns as the reference, 1e-6 relative."""
    _, m, d, r, n = 1, 3, 16, 4, 12
    bs, as_, omega = _stacks(4, 1, m, d, r, n)
    rng = np.random.default_rng(5)
    gb = rng.normal(size=(d, r)).astype(np.float32)
    ga = rng.normal(size=(r, n)).astype(np.float32)
    fb = np.array([0, 0, 1, 1], np.float32) if with_fallback else None
    jb, ja = jsvd.factored_from_weighted(
        jnp.asarray(bs[0]), jnp.asarray(as_[0]), jnp.asarray(omega),
        jnp.asarray(gb), jnp.asarray(ga),
        None if fb is None else jnp.asarray(fb))
    tb, ta = tsvd.factored_from_weighted(
        _t(bs[0]), _t(as_[0]), _t(omega), _t(gb), _t(ga),
        None if fb is None else _t(fb))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    # and the layered K1 plain path builds the same client columns
    u = rpa.weighted_stack_b(_t(bs), _t(omega))[0]
    np.testing.assert_array_equal(u.numpy(), tb.numpy()[:, :m * r])


def test_cpu_wrappers_take_plain_path_and_count_no_launch():
    tops.reset_launches()
    bs, as_, omega = _stacks(6, 1, 2, 8, 8, 8)
    u = rpa.weighted_stack_b(_t(bs), _t(omega))
    v = rpa.weighted_stack_a(_t(as_), _t(omega))
    rpa.gram_left(u)
    rpa.gram_right(v)
    assert [k.launches for k in rpa.KERNELS] == [0, 0, 0, 0]
    torch.testing.assert_close(
        u, rpa.weighted_stack_b_plain(_t(bs), _t(omega)), rtol=0, atol=0)


def test_wrappers_check_their_inputs():
    bs, _, omega = _stacks(7, 1, 2, 8, 8, 8)
    with pytest.raises(TypeError):
        rpa.weighted_stack_b(_t(bs).double(), _t(omega).double())
    with pytest.raises(ValueError, match="omega"):
        rpa.weighted_stack_b(_t(bs), _t(omega)[:1])
    with pytest.raises(ValueError, match="contiguous"):
        rpa.gram_left(_t(bs[0, 0]).mT[None])
    with pytest.raises(ValueError, match="3-D"):
        rpa.gram_right(_t(bs))
