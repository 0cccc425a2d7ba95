"""K4's host plans for its GEMV (at most 32 rows, both dtypes) and its bf16
tensor-core route (above 32 rows), the routes ``describe_plan`` reports, and
``batched_lora_apply_split_plain`` -- the kernels' arithmetic with K cut as
those plans cut it -- held to the JAX package's oracle
``ref.batched_lora_apply_ref`` in f32 and with bf16 operands."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import lora_apply as la
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

# (K, N) of the q, k, v, o projections the plans are sized for
QWEN2 = {"q": (3584, 3584), "k": (3584, 512), "v": (3584, 512),
         "o": (3584, 3584)}
LLAMA4 = {"q": (5120, 5120), "k": (5120, 1024), "v": (5120, 1024),
          "o": (5120, 5120)}
PLANS = {"gemv_f32": lambda m, n, k: gp.plan_gemv(m, n, k, 4),
         "gemv_bf16": lambda m, n, k: gp.plan_gemv(m, n, k, 2),
         "mma_bf16": gp.plan_gemm_bf16}
SLABS = {"gemv_f32": gp.GEMV_SLAB, "gemv_bf16": gp.GEMV_SLAB,
         "mma_bf16": gp.BF16_SLAB}


@pytest.mark.parametrize("k", [5120, 3584, 130, 37, 72])
@pytest.mark.parametrize("route,m,n", [
    ("gemv_f32", 4, 3584), ("gemv_f32", 32, 512), ("gemv_f32", 1, 40),
    ("gemv_bf16", 4, 5120), ("gemv_bf16", 32, 1024), ("gemv_bf16", 7, 520),
    ("mma_bf16", 128, 5120), ("mma_bf16", 128, 1024), ("mma_bf16", 33, 520),
    ("mma_bf16", 4096, 512)])
def test_plans_cover_k_exactly_once(route, m, n, k):
    """The planned ranges tile [0, K) with no gap and no overlap, one a
    split; each but the last ``depth`` deep, a multiple of the route's
    slab; the tiles cover M and N; the GEMV's x range fits its shared
    memory."""
    plan = PLANS[route](m, n, k)
    ranges = gp.split_ranges(k, plan.depth)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 - k0 == plan.depth for k0, k1 in ranges[:-1])
    assert plan.depth % SLABS[route] == 0
    assert 0 < ranges[-1][1] - ranges[-1][0] <= plan.depth
    assert plan.tiles == -(-m // plan.bm) * -(-n // plan.bn)
    if route.startswith("gemv"):
        assert plan.bm in gp.GEMV_ROWS and plan.bm * plan.depth <= \
            gp.GEMV_SMEM_FLOATS
        assert plan.bn * (4 if route == "gemv_f32" else 2) == \
            gp.GEMV_STRIP_BYTES
    else:
        assert (plan.bm, plan.bn) in gp.BF16_TILES
        if plan.splits > 1:
            assert plan.depth >= gp.MIN_SPLIT_DEPTH


@pytest.mark.parametrize("model", ["qwen2-7b", "llama4-maverick"])
@pytest.mark.parametrize("proj", ["q", "k", "v", "o"])
def test_plans_fill_a_wave_at_served_shapes(model, proj):
    """At Qwen2-7B's and Llama-4 Maverick's q/k/v/o the GEMV at 4 and 32
    rows (f32 and bf16 strips) and the bf16 route at 128 rows give every
    one of the 132 SMs a block."""
    k, n = (QWEN2 if model == "qwen2-7b" else LLAMA4)[proj]
    for m in (4, 32):
        for size in (4, 2):
            assert gp.plan_gemv(m, n, k, size).blocks >= gp.SMS
    assert gp.plan_gemm_bf16(128, n, k).blocks >= gp.SMS


def test_plans_at_llama4_and_qwen2():
    """The plans the served shapes get (the GEMV at 4 rows, the bf16 route
    at 128): Llama-4's bf16 q/o 80 strips x 3 splits of 1792, k/v 16 x 14
    of 384; Qwen2-7B's f32 q/o 112 x 2 of 1792, k/v 16 x 14 of 256;
    Llama-4's 128-row q/o 40 tiles of 128 x 128 x 6 splits of 864, k/v 32
    of 64 x 64 x 8 of 640."""
    got = {(m, n, k, size): gp.plan_gemv(m, n, k, size)[:4]
           for m, n, k, size in ((4, 5120, 5120, 2), (4, 1024, 5120, 2),
                                 (4, 3584, 3584, 4), (4, 512, 3584, 4))}
    assert list(got.values()) == [(4, 64, 3, 1792), (4, 64, 14, 384),
                                  (4, 32, 2, 1792), (4, 32, 14, 256)]
    assert gp.plan_gemm_bf16(128, 5120, 5120)[:4] == (128, 128, 6, 864)
    assert gp.plan_gemm_bf16(128, 1024, 5120)[:4] == (64, 64, 8, 640)


# Nemotron-4-340B's six projections (bf16, main path 19) and Granite-3-8B's
# four (f32, main path 18), (K, N)
NEMOTRON = {"q": (18432, 18432), "k": (18432, 1536), "v": (18432, 1536),
            "o": (18432, 18432), "up": (18432, 73728),
            "down": (73728, 18432)}
GRANITE = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
           "o": (4096, 4096)}
# (bm, bn, splits, depth, tiles) and the split scratch in bytes at 4 and
# 128 rows: the GEMV's and the bf16 route's partials (splits x tiles x a
# tile's floats rounded up to 256), the SGEMM's (S, M, N) workspace
SERVED_PLANS = {
    ("nemotron-4-340b", "q", 4): ((4, 64, 8, 2304, 288), 2359296),
    ("nemotron-4-340b", "k", 4): ((4, 64, 11, 1792, 24), 270336),
    ("nemotron-4-340b", "up", 4): ((4, 64, 8, 2304, 1152), 9437184),
    ("nemotron-4-340b", "down", 4): ((4, 64, 29, 2560, 288), 8552448),
    ("nemotron-4-340b", "q", 128): ((128, 128, 4, 4608, 144), 37748736),
    ("nemotron-4-340b", "k", 128): ((128, 128, 11, 1696, 12), 8650752),
    ("nemotron-4-340b", "up", 128): ((128, 128, 1, 18432, 576), 0),
    ("nemotron-4-340b", "down", 128): ((128, 128, 4, 18432, 144), 37748736),
    ("granite-3-8b", "q", 4): ((4, 32, 2, 2048, 128), 262144),
    ("granite-3-8b", "k", 4): ((4, 32, 8, 512, 32), 262144),
    ("granite-3-8b", "q", 128): ((128, 128, 4, 1024, 32), 8388608),
    ("granite-3-8b", "k", 128): ((128, 128, 16, 256, 8), 8388608)}


def _served_plan(model, proj, m):
    """(plan, the scratch bytes its launch takes) of K4 at ``m`` rows of
    a served projection: Nemotron's bf16, Granite's f32."""
    k, n = (NEMOTRON if model == "nemotron-4-340b" else GRANITE)[proj]
    dtype = torch.bfloat16 if model == "nemotron-4-340b" else torch.float32
    route, plan = la._route(m, n, k, False, dtype)
    if plan.splits == 1:
        return route, plan, 0
    if route == "sgemm":
        return route, plan, plan.splits * m * n * 4
    return route, plan, 4 * plan.splits * plan.tiles * \
        -(-plan.bm * plan.bn // 256) * 256


@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("model,proj", [("nemotron-4-340b", p)
                                        for p in NEMOTRON] +
                         [("granite-3-8b", p) for p in GRANITE])
def test_plans_at_nemotron_and_granite(model, proj, m):
    """K4's plans at Nemotron-4-340B's q/k/v/o/up/down (bf16) and
    Granite-3-8B's q/k/v/o (f32), at 4 rows (decode) and 4 x 32 (prefill):
    the GEMV at 4 rows, every range at least ``GEMV_SLAB`` deep and x's
    rows within ``GEMV_SMEM_FLOATS`` (at K 73728 that takes 29 splits;
    blocks in several waves of the 264 resident slots at up and down);
    above 32 rows the bf16 tensor cores or the SGEMM; ``split_sum``'s
    ranges cover K once; the plan and its scratch bytes as stated in
    ``SERVED_PLANS`` where the projection is listed (v and o share k's
    and q's)."""
    route, plan, scratch = _served_plan(model, proj, m)
    k, _ = (NEMOTRON if model == "nemotron-4-340b" else GRANITE)[proj]
    assert route == ("gemv" if m == 4 else
                     "mma_bf16" if model == "nemotron-4-340b" else "sgemm")
    ranges = gp.split_ranges(k, plan.depth)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    covered = gp.split_sum(lambda k0, k1: torch.ones(k1 - k0).sum(), k,
                           plan.depth)
    assert float(covered) == k
    if route == "gemv":
        assert all(k1 - k0 >= gp.GEMV_SLAB for k0, k1 in ranges)
        assert plan.bm * plan.depth <= gp.GEMV_SMEM_FLOATS
    key = (model, {"v": "k", "o": "q"}.get(proj, proj), m)
    assert (tuple(plan), scratch) == SERVED_PLANS[key]


@pytest.mark.parametrize("m,n,k", [(4, 512, 3584), (32, 40, 130),
                                   (33, 520, 37), (128, 5120, 5120)])
def test_describe_plan_reports_each_route(m, n, k):
    """Up to 32 rows both dtypes report the GEMV with its split (K5 too);
    above, f32 the SIMT SGEMM, bf16 the bf16 tensor cores and K5 3xTF32,
    each with its planner's plan."""
    if m <= la.GEMV_MAX_ROWS:
        for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
            assert la.describe_plan(m, n, k, dtype=dtype) == {
                "route": "gemv", **gp.plan_gemv(m, n, k, size).report()}
        assert la.describe_plan(m, n, k, tensor_cores=True)["route"] == "gemv"
        return
    assert la.describe_plan(m, n, k) == {
        "route": "sgemm", **gp.plan_gemm(m, n, k).report()}
    assert la.describe_plan(m, n, k, dtype=torch.bfloat16) == {
        "route": "mma_bf16", **gp.plan_gemm_bf16(m, n, k).report()}
    assert la.describe_plan(m, n, k, tensor_cores=True) == {
        "route": "mma_tf32x3", **gp.plan_gemm_tc(m, n, k).report()}


def _case(seed, m, k, n, p=3, r=16):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(m, k)).astype(np.float32),
            "w": (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32),
            "a_pages": (rng.normal(size=(p, r, k)) * k ** -0.5
                        ).astype(np.float32),
            "b_pages": rng.normal(size=(p, n, r)).astype(np.float32),
            "scales": rng.uniform(0.5, 2.0, size=(p,)).astype(np.float32),
            "ids": rng.integers(0, p, size=(m,)).astype(np.int32)}


SHAPES = [(m, k, n) for m in (4, 32, 33) for k, n in ((37, 40), (130, 520))]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_plain_matches_ref_in_f32(m, k, n):
    """f32: within (K + r) eps max(|x| |W| + |s| (|x| |A|^T) |B|^T), the
    worst-case rounding of the f32 sums, at ragged K and N on both sides
    of the 32-row boundary (the GEMV's split, then the SGEMM's)."""
    case = _case(m + k + n, m, k, n)
    got = la.batched_lora_apply_split_plain(
        **{key: torch.from_numpy(v) for key, v in case.items()})
    want = np.asarray(ref.batched_lora_apply_ref(
        **{key: jnp.asarray(v) for key, v in case.items()}))
    idf = case["ids"]
    mag = np.abs(case["x"]).astype(np.float64) @ np.abs(case["w"]) + \
        np.abs(case["scales"][idf])[:, None] * np.einsum(
            "mr,mnr->mn", np.einsum("mk,mrk->mr", np.abs(case["x"]),
                                    np.abs(case["a_pages"][idf])),
            np.abs(case["b_pages"][idf]))
    tol = (k + case["a_pages"].shape[1]) * np.finfo(np.float32).eps * \
        mag.max()
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_split_plain_matches_ref_with_bf16_operands(m, k, n):
    """x, W and the pages as bf16 on both sides (the GEMV's split at most
    32 rows, the bf16 route's above): the split version's f32 sums rounded
    to bf16 once lie within one bf16 ulp of each row's largest |value| of
    the reference's bf16 output."""
    case = _case(7 * m + k + n, m, k, n)
    cast = ("x", "w", "a_pages", "b_pages")
    t = {key: (torch.from_numpy(v).bfloat16() if key in cast
               else torch.from_numpy(v)) for key, v in case.items()}
    got = la.batched_lora_apply_split_plain(**t).bfloat16().float().numpy()
    want = np.asarray(ref.batched_lora_apply_ref(
        **{key: jnp.asarray(v, jnp.bfloat16 if key in cast else None)
           for key, v in case.items()}).astype(jnp.float32))
    row = np.abs(want).max(axis=-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(row)) - 7)
    assert (np.abs(got - want) <= ulp).all()
