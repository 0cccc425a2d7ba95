"""K3 (the dense rank-partitioned aggregate) and K5 (the single-adapter
fused LoRA apply) of the PyTorch port, held to the JAX package's oracles
``ref.rank_partition_agg_ref`` and ``ref.lora_apply_ref`` at the
tolerances of ``tests/test_kernels.py`` (``TestRankPartitionAggKernel``,
``TestPadToTile``, ``TestLoRAApplyKernel``).

On the CPU each wrapper takes its kernel's plain PyTorch version; every
case runs the plain version, the kernel wrapper and the ``ops`` entry
point. The kernel-vs-plain cases live in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rank_partition_agg as rpa
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- K3 -----------------------------------------------------------------------

def _agg_case(seed, m, d, r, n, layers=None):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    return (rng.normal(size=lead + (m, d, r)).astype(np.float32),
            rng.normal(size=lead + (m, r, n)).astype(np.float32),
            rng.uniform(size=(m, r)).astype(np.float32))


AGG_SINGLE = {"plain": rpa.rank_partition_agg_plain,
              "wrapper": rpa.rank_partition_agg,
              "ops": tops.rank_partition_agg}
AGG_LAYERED = {"plain": rpa.rank_partition_agg_layered_plain,
               "wrapper": rpa.rank_partition_agg_layered,
               "ops": tops.rank_partition_agg_layered}


@pytest.mark.parametrize("entry", list(AGG_SINGLE))
@pytest.mark.parametrize("m,d,r,n", [
    (2, 64, 8, 64), (6, 128, 32, 96), (10, 64, 64, 64),
    (3, 300, 8, 520)])
def test_rank_partition_agg_matches_oracle(entry, m, d, r, n):
    """TestRankPartitionAggKernel.test_sweep and TestPadToTile's odd
    d=300, n=520: atol 1e-4, as the reference test holds its kernel."""
    bs, as_, om = _agg_case(d + r, m, d, r, n)
    got = AGG_SINGLE[entry](_t(bs), _t(as_), _t(om))
    want = ref.rank_partition_agg_ref(jnp.asarray(bs), jnp.asarray(as_),
                                      jnp.asarray(om))
    assert tuple(got.shape) == (d, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("entry", list(AGG_LAYERED))
@pytest.mark.parametrize("layers,m,d,r,n", [(2, 3, 300, 8, 520),
                                            (3, 2, 24, 12, 17)])
def test_rank_partition_agg_layered_matches_oracle(entry, layers, m, d, r, n):
    """TestPadToTile.test_layered_kernel_odd_shapes (and a ragged r=12 that
    ``ops`` pads to 16), each layer against the oracle at atol 1e-4."""
    bs, as_, om = _agg_case(layers + d, m, d, r, n, layers)
    got = AGG_LAYERED[entry](_t(bs), _t(as_), _t(om))
    assert tuple(got.shape) == (layers, d, n)
    for ll in range(layers):
        want = ref.rank_partition_agg_ref(jnp.asarray(bs[ll]),
                                          jnp.asarray(as_[ll]),
                                          jnp.asarray(om))
        np.testing.assert_allclose(got[ll].numpy(), np.asarray(want),
                                   atol=1e-4)


def _fallback_case(seed, m, d, r, n, layers=None):
    bs, as_, om = _agg_case(seed, m, d, r, n, layers)
    rng = np.random.default_rng(seed + 1)
    lead = () if layers is None else (layers,)
    gb = rng.normal(size=lead + (d, r)).astype(np.float32)
    ga = rng.normal(size=lead + (r, n)).astype(np.float32)
    fb = (np.arange(r) >= r // 2).astype(np.float32)
    return bs, as_, om, gb, ga, fb


@pytest.mark.parametrize("d,r,n", [(64, 16, 64), (300, 8, 520)])
def test_ops_fallback_client(d, r, n):
    """TestRankPartitionAggKernel.test_fallback_client, and the odd shape
    with the fallback: the global factors enter as one more client
    weighted by the fallback indicator (atol 1e-4)."""
    bs, as_, om, gb, ga, fb = _fallback_case(9, 3, d, r, n)
    got = tops.rank_partition_agg(*map(_t, (bs, as_, om, gb, ga, fb)))
    want = ref.rank_partition_agg_ref(jnp.asarray(bs), jnp.asarray(as_),
                                      jnp.asarray(om)) + (gb * fb) @ ga
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ops_layered_fallback_client():
    """The layered entry with per-layer global factors (L, d, r) / (L, r, n)
    and one fallback row shared by the layers."""
    bs, as_, om, gb, ga, fb = _fallback_case(4, 3, 300, 8, 520, layers=2)
    got = tops.rank_partition_agg_layered(*map(_t, (bs, as_, om, gb, ga, fb)))
    for ll in range(2):
        want = ref.rank_partition_agg_ref(
            jnp.asarray(bs[ll]), jnp.asarray(as_[ll]),
            jnp.asarray(om)) + (gb[ll] * fb) @ ga[ll]
        np.testing.assert_allclose(got[ll].numpy(), np.asarray(want),
                                   atol=1e-4)


def test_ops_fallback_needs_global_factors():
    bs, as_, om, gb, _, fb = _fallback_case(2, 2, 16, 8, 16)
    with pytest.raises(ValueError, match="global_a"):
        tops.rank_partition_agg(_t(bs), _t(as_), _t(om), _t(gb), None, _t(fb))


def test_negative_omega_is_applied_as_given():
    """Unlike K1's sqrt(max(omega, 0)), K3 multiplies by omega itself: a
    negative weight subtracts its client (the oracle's contract)."""
    bs, as_, om = _agg_case(5, 3, 24, 8, 20)
    om[1] = -om[1]
    got = tops.rank_partition_agg(_t(bs), _t(as_), _t(om)).numpy()
    want = ref.rank_partition_agg_ref(jnp.asarray(bs), jnp.asarray(as_),
                                      jnp.asarray(om))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_agg_wrappers_check_inputs_and_count_no_cpu_launch():
    bs, as_, om = map(_t, _agg_case(1, 2, 8, 8, 8))
    tops.reset_launches()
    rpa.rank_partition_agg(bs, as_, om)
    rpa.rank_partition_agg_layered(bs[None], as_[None], om)
    assert [k.launches for k in rpa.DENSE_KERNELS] == [0, 0]
    with pytest.raises(ValueError, match="do not match"):
        rpa.rank_partition_agg(bs, as_[:, :4].contiguous(), om)
    with pytest.raises(TypeError):
        rpa.rank_partition_agg(bs.double(), as_, om)
    with pytest.raises(NotImplementedError, match="backward"):
        rpa.rank_partition_agg(bs.requires_grad_(), as_, om)


# -- K5 -----------------------------------------------------------------------

LORA = {"plain": la.lora_apply_plain, "wrapper": la.lora_apply,
        "ops": tops.lora_apply}


def _lora_case(seed, m, k, n, r, lead=None):
    rng = np.random.default_rng(seed)
    x_shape = (m, k) if lead is None else lead + (k,)
    return (rng.normal(size=x_shape).astype(np.float32),
            (0.05 * rng.normal(size=(k, n))).astype(np.float32),
            (0.1 * rng.normal(size=(r, k))).astype(np.float32),
            (0.1 * rng.normal(size=(n, r))).astype(np.float32))


def _oracle(x, w, a, b, scale, dtype=jnp.float32):
    return np.asarray(ref.lora_apply_ref(
        *(jnp.asarray(t).astype(dtype) for t in (x, w, a, b)), scale),
        np.float32)


@pytest.mark.parametrize("entry", list(LORA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [
    (64, 128, 64, 8), (128, 256, 192, 16), (64, 64, 64, 64),
    (256, 128, 128, 32)])
def test_lora_apply_matches_oracle(entry, dtype, m, k, n, r):
    """TestLoRAApplyKernel.test_shape_dtype_sweep: scale 0.5, atol = rtol =
    1e-5 in f32 and 3e-2 in bf16 (inputs rounded to bf16 alike on both
    sides, computed in f32, the result rounded back to bf16). The kernel
    wrapper takes f32 only, so its bf16 case goes through a cast."""
    case = _lora_case(m * 1000 + k + n + r, m, k, n, r)
    tdt = getattr(torch, dtype)
    args = [_t(t).to(tdt) for t in case]
    if entry == "wrapper" and dtype == "bfloat16":
        got = la.lora_apply(*(t.float() for t in args), 0.5).to(tdt)
    else:
        got = LORA[entry](*args, 0.5)
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               _oracle(*case, 0.5, getattr(jnp, dtype)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("entry", list(LORA))
def test_zero_adapter_is_plain_matmul(entry):
    """TestLoRAApplyKernel.test_zero_adapter_is_plain_matmul (atol 1e-4)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    w = rng.normal(size=(64, 64)).astype(np.float32)
    a, b = np.zeros((8, 64), np.float32), np.zeros((64, 8), np.float32)
    got = LORA[entry](*map(_t, (x, w, a, b)), 1.0)
    np.testing.assert_allclose(got.numpy(), x @ w, atol=1e-4)


def test_ops_lora_apply_odd_leading_shape():
    """TestLoRAApplyKernel.test_ops_wrapper_pads_odd_shapes: x (3, 17, 100)
    through ``ops`` (leading axes flattened, r = 12 padded to 16), scale
    0.7, atol 1e-4."""
    x, w, a, b = _lora_case(3, None, 100, 72, 12, lead=(3, 17))
    got = tops.lora_apply(*map(_t, (x, w, a, b)), 0.7)
    assert tuple(got.shape) == (3, 17, 72)
    want = _oracle(x.reshape(-1, 100), w, a, b, 0.7).reshape(3, 17, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("entry", list(LORA))
def test_lora_apply_non_divisible(entry):
    """TestLoRAApplyKernel.test_direct_call_pads_non_divisible: M=300,
    K=130, N=520, r=12, scale 1.7, atol 1e-4."""
    case = _lora_case(9, 300, 130, 520, 12)
    got = LORA[entry](*map(_t, case), 1.7)
    np.testing.assert_allclose(got.numpy(), _oracle(*case, 1.7), atol=1e-4)


def test_lora_wrapper_checks_inputs_and_counts_no_cpu_launch():
    x, w, a, b = map(_t, _lora_case(1, 4, 8, 6, 2))
    tops.reset_launches()
    la.lora_apply(x, w, a, b, 2.0)
    assert la.lora_apply.launches == 0
    with pytest.raises(ValueError, match="do not match"):
        la.lora_apply(x, w, a, b.T.contiguous(), 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        la.lora_apply(x, w.T.contiguous().T, a, b)
    with pytest.raises(TypeError):
        la.lora_apply(x.double(), w, a, b)
    with pytest.raises(NotImplementedError, match="backward"):
        la.lora_apply(x, w.requires_grad_(), a, b)
