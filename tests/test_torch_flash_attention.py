"""K7, online-softmax attention, of the PyTorch port: the cases of
``tests/test_flash_attention.py`` held to the JAX oracle
``ref.flash_attention_ref`` at that file's tolerance (atol 2e-5, rtol
1e-4), plus the ragged non-causal case that the reference's own
``ops.flash_attention`` gets wrong (it pads Lkv and lets the padded keys
into the softmax; ROADMAP.md queue 3).

On the CPU the wrapper takes the kernel's plain PyTorch version; every
case runs the plain version, the kernel wrapper and the ``ops`` entry
point. The kernel-vs-plain cases live in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.models.layers.attention import causal_attention
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

TOL = {"atol": 2e-5, "rtol": 1e-4}
ENTRIES = {"plain": fa.flash_attention_plain, "wrapper": fa.flash_attention,
           "ops": tops.flash_attention}


def _qkv(seed, b, lq, h, kvh, d, lkv=None):
    rng = np.random.default_rng(seed)
    lkv = lq if lkv is None else lkv
    return (rng.normal(size=(b, lq, h, d)).astype(np.float32),
            rng.normal(size=(b, lkv, kvh, d)).astype(np.float32),
            rng.normal(size=(b, lkv, kvh, d)).astype(np.float32))


def _check(entry, qkv, causal, window=0):
    got = ENTRIES[entry](*(torch.from_numpy(t) for t in qkv), causal=causal,
                         window=window)
    want = ref.flash_attention_ref(*(jnp.asarray(t) for t in qkv),
                                   causal=causal, window=window)
    assert tuple(got.shape) == qkv[0].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("B,L,H,KVH,D", [
    (2, 48, 4, 2, 16), (1, 64, 8, 1, 32), (2, 64, 6, 6, 16),
    (1, 128, 4, 4, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_sweep(entry, B, L, H, KVH, D, causal):
    """TestFlashAttention.test_sweep: GQA groups 2, 8, 1, 1."""
    _check(entry, _qkv(B * 100 + L + H, B, L, H, KVH, D), causal)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("window", [4, 16, 40])
def test_sliding_window(entry, window):
    """TestFlashAttention.test_sliding_window: L 40, causal."""
    _check(entry, _qkv(7, 1, 40, 4, 2, 16), True, window)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_ragged_length(entry):
    """TestFlashAttention.test_ragged_length_padding: L 33, causal."""
    _check(entry, _qkv(9, 2, 33, 4, 4, 16), True)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_ragged_non_causal(entry):
    """L 200, bidirectional, GQA 4/2: the reference's ops wrapper pads Lkv
    to 256 and misses the oracle here (the next test); the port masks on
    the true Lkv and holds the oracle's tolerance."""
    _check(entry, _qkv(200, 1, 200, 4, 2, 16), False)


def test_reference_ops_misses_the_oracle_where_the_port_holds_it():
    """The same L 200 bidirectional inputs through the reference's own
    ``ops.flash_attention`` (interpret mode): Lkv padded to 256 is passed
    as the true length, so the 56 zero keys enter the softmax with score 0
    and the output misses the oracle by about 0.085, far beyond the
    tolerance. The causal mask hides the fault (a padded key lies after
    every real query), so only bidirectional ragged lengths show it."""
    qkv = _qkv(200, 1, 200, 4, 2, 16)
    jqkv = [jnp.asarray(t) for t in qkv]
    want = np.asarray(ref.flash_attention_ref(*jqkv, causal=False))
    gap = np.abs(np.asarray(jops.flash_attention(*jqkv, causal=False))
                 - want).max()
    assert gap > 1e-2
    got = tops.flash_attention(*(torch.from_numpy(t) for t in qkv),
                               causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("lq,lkv,causal,window", [
    (40, 100, False, 0), (40, 100, True, 0), (100, 40, True, 0),
    (50, 20, False, 4), (50, 20, True, 4)])
def test_unequal_lengths(entry, lq, lkv, causal, window):
    """Lq != Lkv, positions from 0 on both sides (``ops`` has no offset).
    The last two leave rows that see no key at all (q >= Lkv - 1 +
    window): the oracle's softmax over an all-fill row averages every key."""
    _check(entry, _qkv(lq + lkv, 2, lq, 4, 2, 16, lkv), causal, window)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_matches_model_attention(entry):
    """TestFlashAttention.test_matches_model_blockwise_path, against the
    port's ``causal_attention`` (the model's causal path)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(11, 2, 64, 8, 2, 32))
    got = ENTRIES[entry](q, k, v, causal=True)
    torch.testing.assert_close(got, causal_attention(q, k, v), **TOL)


def test_bf16_inputs_come_back_in_bf16():
    """Computed in f32 whatever q's dtype, returned in q's dtype, as the
    oracle does."""
    qkv = _qkv(3, 1, 24, 2, 1, 16)
    got = tops.flash_attention(*(torch.from_numpy(t).bfloat16() for t in qkv))
    want = ref.flash_attention_ref(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in qkv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 1, 8, 4, 2, 16))
    tops.reset_launches()
    fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == 0
    with pytest.raises(ValueError, match="KV heads"):
        fa.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 16), v[:, :, :1]
                           .expand(1, 8, 3, 16))
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, k, v[..., :8])
    with pytest.raises(ValueError, match="Lkv = 0"):
        fa.flash_attention(q, k[:, :0], v[:, :0])
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q.requires_grad_(), k, v)


# a value entry past the band: the key lies outside some rows' band, and
# the oracle's p v over all Lkv keys (p = 0 there) gives those rows NaN
# in its column (0 * inf), whatever the rest of the row
PAST_BAND = {"causal": (40, True, 0, 30), "causal-window": (40, True, 8, 3),
             "window": (40, False, 8, 3), "causal-lkv-gt-lq": (48, True, 0,
                                                               44)}


@pytest.mark.parametrize("value", [np.inf, np.nan], ids=["inf", "nan"])
@pytest.mark.parametrize("case", list(PAST_BAND))
def test_value_past_the_band_nans_its_column_as_reference(case, value):
    """One non-finite V entry (key ``kv``, column 5) that some rows' band
    leaves out: the plain version (the card's target) has the oracle's
    NaN and +-inf places, NaN at every row that does not see the key, and
    its finite values within the file's tolerance. The causal call with
    Lkv > Lq puts it at a key no row sees."""
    lkv, causal, window, kv = PAST_BAND[case]
    q, k, v = _qkv(37, 1, 40, 2, 1, 16, lkv)
    v[0, kv, 0, 5] = value
    got = fa.flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                   causal=causal, window=window).numpy()
    want = np.asarray(ref.flash_attention_ref(
        *(jnp.asarray(t) for t in (q, k, v)), causal=causal, window=window))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    rows = np.arange(40)
    unseen = np.zeros(40, bool) if not causal else kv > rows
    if window:
        unseen |= kv <= rows - window
    assert unseen.any() and np.isnan(want[0, unseen][:, :, 5]).all()
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], **TOL)
