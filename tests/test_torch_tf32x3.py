"""The 3xTF32 arithmetic of the PyTorch port (``kernels/tf32x3.py``, the
CPU emulation of ``csrc/mma_tf32x3.cuh``), the plain version that repeats
K7's tensor-core precision held to the JAX oracle
``ref.flash_attention_ref`` at the kernel's unchanged tolerance (K5's is
held in ``test_torch_lora_apply.py``), and the host planners of the two
kernels (``gemm_plan.plan_gemm_tc``, ``flash_attention.plan_attention``).

The kernels themselves run on the card only (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import tf32x3
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

EPS = np.finfo(np.float32).eps
ATTN_TOL = {"atol": 2e-5, "rtol": 1e-4}   # tests/test_flash_attention.py


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().view(np.uint32)


# -- the split ----------------------------------------------------------------

@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_split_tf32_halves(scale):
    """hi + lo is within 2^-22 |a| of a, and both halves are TF32 values:
    their 13 low mantissa bits are zero."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    a = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi, lo = tf32x3.split_tf32(a)
    err = (hi.double() + lo.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -22 * a.double().abs()).all())
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    assert bool((lo.abs() <= 2.0 ** -11 * a.abs()).all())


def test_split_tf32_rounds_to_nearest_ties_away():
    """cvt.rna's rounding: a tie (half of TF32's last place) goes away from
    zero, below it goes down; zero and infinity keep their class in hi,
    and the lo of an infinity or a NaN is NaN, so that every product that
    meets one is NaN."""
    raw = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000,
                    0x00000000, 0x7F800000, 0xFF800000, 0x7FFFFFFF,
                    0xFFFFFFFF], np.uint32)
    a = torch.from_numpy(raw.view(np.int32)).view(torch.float32)
    hi, lo = tf32x3.split_tf32(a)
    assert list(_bits(hi)[:7]) == [0x3F802000, 0xBF802000, 0x3F800000,
                                   0x3F804000, 0, 0x7F800000, 0xFF800000]
    assert bool(torch.isnan(lo[5:]).all()) and not lo[:5].isnan().any()
    # a remainder of one TF32 place: lo holds it exactly
    assert float(hi[3]) + float(lo[3]) == float(a[3])


@pytest.mark.parametrize("m,k,n", [(40, 3584, 64), (7, 300, 33)])
def test_tf32x3_matmul_is_f32_accurate(m, k, n):
    """The three passes against a float64 product: within the rounding of a
    K-deep f32 sum, K eps max(|a| |b|), and over 100 times closer than one
    TF32 pass (three digits)."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    tol = k * EPS * float((np.abs(a) @ np.abs(b)).max())
    got = tf32x3.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    err = np.abs(got - want).max()
    assert err <= tol
    hi_a, _ = tf32x3.split_tf32(torch.from_numpy(a))
    hi_b, _ = tf32x3.split_tf32(torch.from_numpy(b))
    assert np.abs((hi_a @ hi_b).numpy() - want).max() > 100 * err


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
def test_tf32x3_matmul_turns_a_non_finite_operand_into_nan(bad):
    """As on the card, and once a pinned divergence from the IEEE product:
    a @ b with special values gives the f32 product's classes (the passes'
    NaN outputs summed again in IEEE f32). An infinite
    entry of a gives +-inf along its row, NaN where it meets a zero of b
    (inf * 0) or an infinity of the other sign, +-inf where it meets an
    infinity of b; a NaN entry makes its row NaN. Every output equals the
    f32 product's class and sign, and the finite ones are within K eps of
    it; the rows that meet no special value are bit-equal to those of
    the same inputs with the special values left out."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(40, 9)).astype(np.float32))
    clean = tf32x3.matmul(a, b)
    a[2, 7] = bad
    b[7, 3] = 0.0                      # inf * 0
    a[4, 11] = -bad                    # against b's infinities below
    b[11, 5], b[11, 6] = float("inf"), float("-inf")
    got, want = tf32x3.matmul(a, b), a @ b
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    special = ~torch.isfinite(want)
    assert torch.equal(got[special & ~want.isnan()],
                       want[special & ~want.isnan()])
    if bad != bad:
        assert bool(got[[2, 4]].isnan().all())
    else:
        assert bool(got[2].isinf().sum() == 7) and bool(got[2, 3].isnan())
    tol = 40 * EPS * float((a.abs() @ b.abs())[~special].max())
    assert float((got - want)[~special].abs().max()) <= tol
    keep = [0, 1, 3, 5]
    assert torch.equal(got[keep][:, [0, 1, 2, 4, 7, 8]],
                       clean[keep][:, [0, 1, 2, 4, 7, 8]])


@pytest.mark.parametrize("m,k,n", [(64, 3584, 256), (300, 130, 520)])
def test_one_pass_sigma_tells_three_passes_from_one(m, k, n):
    """The yardstick the card holds K5's tensor-core route to: against a
    float64 product, the three passes stay within a one-pass TF32
    product's error sigma (``one_pass_sigma``), and the most accurate
    one-pass product (``one_pass_matmul``) goes beyond it, at Qwen2-7B's
    depth and at the reference test's odd shape."""
    rng = np.random.default_rng(m + k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(k, n)) * k ** -0.5)
                         .astype(np.float32))
    want = a.double() @ b.double()
    tol = tf32x3.one_pass_sigma(a, b)
    assert float((tf32x3.matmul(a, b).double() - want).abs().max()) <= tol
    assert float((tf32x3.one_pass_matmul(a, b) - want).abs().max()) > tol


# -- K7's plain version of the tensor-core route against the JAX oracle -------

@pytest.mark.parametrize("b,lq,lkv,h,kvh,d,causal,window", [
    (1, 40, 40, 2, 1, 256, True, 0),      # gemma-2b's head dim, MQA
    (2, 48, 48, 4, 2, 16, True, 0),
    (1, 64, 64, 4, 4, 64, False, 0),
    (1, 50, 50, 2, 2, 36, True, 8),       # D zero-padded to 40, a window
    (2, 50, 20, 4, 2, 16, False, 4)])     # rows that see no key
def test_flash_attention_tf32x3_plain_matches_oracle(b, lq, lkv, h, kvh, d,
                                                     causal, window):
    """K7's arithmetic (both products 3xTF32, O = (P V) / row sum) against
    ``ref.flash_attention_ref`` at the reference test's tolerance."""
    rng = np.random.default_rng(lq * 7 + d)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in (
        (b, lq, h, d), (b, lkv, kvh, d), (b, lkv, kvh, d)))
    want = ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window)
    got = fa.flash_attention_tf32x3_plain(*map(torch.from_numpy, (q, k, v)),
                                          causal, window)
    assert tuple(got.shape) == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


# -- K7's planner ---------------------------------------------------------------

ATTN_SHAPES = {"qwen2-7b prefill": (4, 1024, 28, 128),
               "vit-base": (32, 197, 12, 64),
               "hymba-1.5b window": (1, 4096, 25, 64),
               "gemma-2b mqa": (1, 2048, 8, 256)}


@pytest.mark.parametrize("lq", [1, 16, 17, 63, 65, 197, 1024, 4096])
@pytest.mark.parametrize("b,h,d", [(1, 1, 16), (32, 12, 64), (1, 8, 256)])
def test_plan_attention_covers_every_q_row_once(lq, b, h, d):
    """The q tiles of a (b, h) cover rows 0 .. Lq - 1 once: Lq rows fit the
    tiles, and the last tile starts before Lq."""
    plan = fa.plan_attention(b, lq, h, d)
    assert 1 <= plan.warps <= fa.MAX_WARPS and plan.q_tile == 16 * plan.warps
    assert (plan.q_tiles - 1) * plan.q_tile < lq <= plan.q_tiles * plan.q_tile
    assert plan.blocks == b * h * plan.q_tiles


def test_plan_attention_wastes_few_rows_at_vit_base():
    """L 197 on four warps a block: the last of 4 tiles holds 5 rows, but
    its three warps wholly past Lq skip their products, so the warps
    compute 208 rows, 11 past Lq (5.3%), where the SIMT kernel computed
    all 256 (23%); B H tiles fill the card many times over."""
    plan = fa.plan_attention(*ATTN_SHAPES["vit-base"])
    assert plan.warps == 4 and plan.q_tiles == 4
    held = plan.q_tiles * plan.q_tile - 197
    computed = -(-197 // 16) * 16 - 197     # warps wholly past Lq skip
    assert (held, computed) == (59, 11)
    assert held / 256 > 0.23 and computed / 208 < 0.06
    assert plan.blocks >= gp.SMS


@pytest.mark.parametrize("case", list(ATTN_SHAPES))
def test_plan_attention_fits_two_blocks_an_sm(case):
    """At every kernel_ops shape, D 256 included, the shared memory holds
    as many blocks as the registers allow, at least two an SM (the kv tile
    shrinks with D), four warps a block."""
    b, lq, h, d = ATTN_SHAPES[case]
    plan = fa.plan_attention(b, lq, h, d)
    width, kv, reg_blocks = fa.instance(d)
    assert plan.warps == 4 and plan.kv_tile == kv
    assert plan.per_sm >= reg_blocks >= 2
    assert reg_blocks * (plan.smem + fa.BLOCK_RESERVED) <= fa.SM_SMEM
    assert plan.smem == fa.attention_smem(d, plan.kv_tile, plan.warps)
    if d == 256:
        assert plan.kv_tile == 16


@pytest.mark.parametrize("lq,b,h,warps", [(1, 1, 4, 1), (17, 1, 1, 1),
                                          (17, 64, 4, 2), (100, 2, 128, 4)])
def test_plan_attention_takes_fewer_warps_for_short_or_few_rows(lq, b, h,
                                                                warps):
    """No more warps than Lq has 16-row groups, and fewer where B H tiles
    would leave SMs without a block."""
    assert fa.plan_attention(b, lq, h, 64).warps == warps


@pytest.mark.parametrize("d", list(range(1, 257, 5)) + [64, 80, 128, 192,
                                                        256])
def test_plan_attention_never_exceeds_a_block_of_smem(d):
    """No plan, nor any warps the kernel accepts with the planned kv tile,
    asks for more than the 227 KB a block may take; the padded
    strides keep the fragment loads on distinct banks."""
    plan = fa.plan_attention(2, 300, 4, d)
    width, kv, _ = fa.instance(d)
    assert width >= d and width % 8 == 0 and plan.kv_tile == kv
    assert max(fa.attention_smem(d, kv, w)
               for w in range(1, 5)) <= fa.BLOCK_SMEM
    assert fa._ld_qk(width) % 32 == 8 and fa._ld_qk(width) >= width
    assert fa._ld_v(width) % 16 == 4 and fa._ld_v(width) >= width


# -- K5's planner ---------------------------------------------------------------

@pytest.mark.parametrize("k", [3584, 130, 37, 600, 1024])
@pytest.mark.parametrize("m,n", [(128, 3584), (128, 512), (40, 40),
                                 (4096, 3584), (300, 520)])
def test_plan_gemm_tc_splits_cover_k_once(m, n, k):
    """The tensor-core route's ranges tile [0, K) with no gap and no
    overlap, one range a split, each but the last a multiple of its
    32-deep slab and at least ``MIN_SPLIT_DEPTH`` deep when split; all
    blocks in one wave of one block an SM."""
    plan = gp.plan_gemm_tc(m, n, k)
    ranges = gp.split_ranges(k, plan.depth)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.depth % gp.TC_SLAB == 0
    assert (plan.bm, plan.bn) == gp.TC_TILE
    if plan.splits > 1:
        assert plan.depth >= gp.MIN_SPLIT_DEPTH
        assert plan.blocks <= gp.TC_RESIDENT * gp.SMS


@pytest.mark.parametrize("m,n,want", [
    (4096, 3584, (1, 896)), (4096, 512, (2, 256)),
    (128, 3584, (9, 252)), (128, 512, (28, 112))])
def test_plan_gemm_tc_fills_the_card_at_qwen2_shapes(m, n, want):
    """Qwen2-7B's q and k projections (K 3584), two blocks an SM: at 4096
    rows q's 896 tiles run unsplit and k's 128 in 2 splits (256 blocks);
    at 128 rows q's 28 tiles in 9 splits of 416 (252 blocks) and k's 4 in
    28 of 128 (112 blocks, the 128-deep floor): every SM has a block. K5
    reports the route; K4 keeps its own plan and route."""
    plan = gp.plan_gemm_tc(m, n, 3584)
    assert (plan.splits, plan.blocks) == want
    assert plan.blocks >= 0.84 * gp.SMS
    assert la.describe_plan(m, n, 3584, tensor_cores=True) == {
        "route": "mma_tf32x3", **plan.report()}
    assert la.describe_plan(m, n, 3584) == {
        "route": "sgemm", **gp.plan_gemm(m, n, 3584).report()}
