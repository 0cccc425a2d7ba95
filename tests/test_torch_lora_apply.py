"""K4, the paged multi-adapter LoRA apply of the serving path, held to the
JAX package's oracle ``ref.batched_lora_apply_ref`` and to one
interpret-mode call of its Pallas entry ``ops.batched_lora_apply``.

On the CPU the wrapper takes the kernel's plain PyTorch version; the
kernel-vs-plain cases live in ``test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import ops as tops
from repro_torch.models.layers.dense import dense_apply
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

K, N, RANKS = 72, 56, (4, 8, 16)


def _case(seed, lead=(5, 7), k=K, n=N, ranks=RANKS, r_max=16):
    """Pages with zero columns beyond each page's true rank (the store's
    packing), scales 2/r, random ids over the pages."""
    rng = np.random.default_rng(seed)
    p = len(ranks)
    mask = (np.arange(r_max)[None, :] < np.asarray(ranks)[:, None])
    a = rng.normal(size=(p, r_max, k)).astype(np.float32) * mask[:, :, None]
    b = rng.normal(size=(p, n, r_max)).astype(np.float32) * mask[:, None, :]
    return {
        "x": rng.normal(size=lead + (k,)).astype(np.float32),
        "w": (0.1 * rng.normal(size=(k, n))).astype(np.float32),
        "a_pages": a, "b_pages": b,
        "scales": np.asarray([2.0 / r for r in ranks], np.float32),
        "ids": rng.integers(0, p, size=lead).astype(np.int32),
    }


def _torch(case):
    return {k: torch.from_numpy(v) for k, v in case.items()}


def _oracle(case):
    return np.asarray(ref.batched_lora_apply_ref(
        **{k: jnp.asarray(v) for k, v in case.items()}))


@pytest.mark.parametrize("fn", [la.batched_lora_apply_plain,
                                la.batched_lora_apply, tops.batched_lora_apply],
                         ids=["plain", "wrapper", "ops"])
def test_matches_ref_oracle(fn):
    """K=72, N=56, P=3 pages at ranks 4/8/16, x (5, 7, K), random ids:
    atol 1e-5 in f32 (one f32 dot of depth K, summed in another order)."""
    case = _case(0)
    got = fn(**_torch(case))
    assert got.shape == (5, 7, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _oracle(case), atol=1e-5,
                               rtol=0)


def test_matches_pallas_entry_in_interpret_mode():
    """The JAX package's SGMV-grouped Pallas entry (interpret mode), once
    at a tiny odd size; the port gathers per row, so the grouping and its
    zero filler rows must not matter."""
    case = _case(1, lead=(11,), k=40, n=24, ranks=(8, 4))
    want = np.asarray(jops.batched_lora_apply(
        **{k: jnp.asarray(v) for k, v in case.items()}))
    got = la.batched_lora_apply(**_torch(case))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _bad_page_case(seed):
    """``_case`` with every page-id rule of the reference's getitem: past
    the end (P, P + 3), from the end (-1, -P), past the start (-P - 1)."""
    case = _case(seed, lead=(8,), k=40, n=24)
    p = case["a_pages"].shape[0]
    case["ids"] = np.array([0, p, p + 3, -1, -p, -p - 1, 1, 2], np.int32)
    return case


@pytest.mark.parametrize("fn", [la.batched_lora_apply_plain,
                                la.batched_lora_apply, tops.batched_lora_apply,
                                la.batched_lora_apply_split_plain],
                         ids=["plain", "wrapper", "ops", "split_plain"])
def test_page_ids_as_ref_oracle(fn):
    """Page ids outside [0, P) as ``ref.batched_lora_apply_ref`` gathers
    them (``a_pages[ids]``: a negative id counts from the end, then the id
    is clamped to [0, P - 1]), by every CPU route of K4 and by
    ``page_index`` itself, at the oracle's tolerance."""
    case = _bad_page_case(3)
    got = fn(**_torch(case))
    np.testing.assert_allclose(got.numpy(), _oracle(case), atol=1e-5,
                               rtol=0)
    assert la.page_index(torch.from_numpy(case["ids"]), 3).tolist() == \
        [0, 2, 2, 2, 0, 0, 1, 2]


def test_pallas_entry_differs_from_its_oracle_on_negative_page_ids():
    """A reference inconsistency (ROADMAP.md queue 3), pinned: the JAX
    package's Pallas entry (interpret mode) clamps ids past the end as its
    oracle does, but not a negative id, which its SGMV grouping places
    elsewhere (-1 reads page 1 here, not page P - 1); the port holds to
    the oracle."""
    case = _bad_page_case(4)
    want = _oracle(case)
    got = np.asarray(jops.batched_lora_apply(
        **{k: jnp.asarray(v) for k, v in case.items()}))
    rows = np.abs(got - want).max(axis=-1) > 1e-3
    assert not rows[[0, 1, 2, 6, 7]].any() and rows[3]


def test_zero_rank_columns_are_inert():
    """Against a per-row reference that truncates each page to its TRUE
    rank (not padding), computed in f64: the zero columns change nothing
    beyond f32 rounding (atol 1e-5)."""
    case = _case(2)
    got = la.batched_lora_apply(**_torch(case)).numpy().reshape(-1, N)
    x = case["x"].reshape(-1, K).astype(np.float64)
    ids = case["ids"].reshape(-1)
    for t in range(x.shape[0]):
        p = ids[t]
        r = RANKS[p]
        a, b = case["a_pages"][p, :r], case["b_pages"][p, :, :r]
        want = x[t] @ case["w"] + case["scales"][p] * (x[t] @ a.T) @ b.T
        np.testing.assert_allclose(got[t], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ids_dtype", [np.int32, np.int64],
                         ids=["int32", "int64"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_ops_entry_keeps_reference_contract(dtype, tol, ids_dtype):
    """``ops.batched_lora_apply`` reads x, w and the pages of any float
    dtype as f32, takes integer ids of any width and returns x.dtype,
    as the reference's entry does (``TestBatchedLoRAApplyKernel::
    test_heterogeneous_ranks_vs_per_request_dense``: tol 1e-4 in f32,
    3e-2 in bf16). Held to the reference's entry (interpret mode) on the
    same inputs and to the oracle in f32 on the inputs as rounded to
    ``dtype``. All-bf16 operands reach the raw wrapper as bf16
    (``test_ops_entry_passes_all_bf16_operands_through``); it refuses
    int64 ids (``test_wrapper_checks_its_inputs``)."""
    case = _case(6)
    case["ids"] = case["ids"].astype(ids_dtype)
    t = _torch(case)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cast = ("x", "w", "a_pages", "b_pages")
    got = tops.batched_lora_apply(**{k: (v.to(dtype) if k in cast else v)
                                     for k, v in t.items()})
    assert got.dtype == dtype and got.shape == (5, 7, N)
    want = np.asarray(jops.batched_lora_apply(**{
        k: jnp.asarray(v, jdt if k in cast else None)
        for k, v in case.items()}), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    rounded = {k: (np.asarray(jnp.asarray(v, jdt), np.float32)
                   if k in cast else v) for k, v in case.items()}
    np.testing.assert_allclose(got.float().numpy(), _oracle(rounded),
                               atol=tol, rtol=tol)


def test_ops_entry_takes_non_contiguous_pages():
    """The entry copies a page that is not contiguous (the raw wrapper
    refuses it) and reads a strided page axis in place; either way the
    result equals the call on contiguous pages."""
    t = _torch(_case(7))
    a_t = t["a_pages"].transpose(1, 2).contiguous().transpose(1, 2)
    b_t = t["b_pages"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        la.batched_lora_apply(**dict(t, a_pages=a_t))
    want = tops.batched_lora_apply(**t)
    got = tops.batched_lora_apply(**dict(t, a_pages=a_t, b_pages=b_t))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stacked = torch.stack([t["a_pages"], 2 * t["a_pages"]], dim=1)[:, 0]
    assert tops._pages(stacked).data_ptr() == stacked.data_ptr()
    torch.testing.assert_close(
        tops.batched_lora_apply(**dict(t, a_pages=stacked)), want, rtol=0,
        atol=0)


def _bf16(case):
    return {k: (v.bfloat16() if k in ("x", "w", "a_pages", "b_pages")
                else v) for k, v in _torch(case).items()}


def test_wrapper_takes_bf16_operands_as_its_plain_version():
    """The raw wrapper takes x, W and the pages all bf16 (a bf16 model's
    serve): on the CPU its plain version, computed in f32 and rounded to
    bf16 once, so within one bf16 ulp of each row's largest |value| of the
    oracle on the same bf16 values; no launch counted."""
    case = _bf16(_case(8))
    tops.reset_launches()
    got = la.batched_lora_apply(**case)
    assert got.dtype == torch.bfloat16 and got.shape == (5, 7, N)
    torch.testing.assert_close(got, la.batched_lora_apply_plain(**case),
                               rtol=0, atol=0)
    want = _oracle({k: (v.float() if v.is_floating_point() else v).numpy()
                    for k, v in case.items()})
    row = np.abs(want).max(axis=-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(row)) - 7)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()
    assert la.batched_lora_apply.launches == 0
    assert la.batched_lora_apply.launches_bf16 == 0


def test_wrapper_refuses_mixed_operand_dtypes():
    """x, W and the pages all of one dtype of ``OPERAND_DTYPES``: a bf16 W
    under an f32 x, or f16 operands, raise."""
    case = _torch(_case(9))
    with pytest.raises(TypeError):
        la.batched_lora_apply(**dict(case, w=case["w"].bfloat16()))
    with pytest.raises(TypeError):
        la.batched_lora_apply(**_bf16(_case(9)) | {"a_pages":
                                                   case["a_pages"]})
    with pytest.raises(TypeError):
        la.batched_lora_apply(**{k: (v.half() if v.is_floating_point()
                                     and k != "scales" else v)
                                 for k, v in case.items()})


@pytest.mark.parametrize("mixed", [False, True], ids=["bf16", "mixed"])
def test_ops_entry_passes_all_bf16_operands_through(monkeypatch, mixed):
    """``ops.batched_lora_apply`` hands all-bf16 operands to the wrapper as
    they are (K4's bf16 instance on the card) and reads any mix as f32;
    both return x's dtype."""
    seen = []
    inner = la.batched_lora_apply

    def spy(x, w, a, b, s, ids):
        seen.append({t.dtype for t in (x, w, a, b)})
        return inner(x, w, a, b, s, ids)
    monkeypatch.setattr(la, "batched_lora_apply", spy)
    case = _bf16(_case(10))
    if mixed:
        case["w"] = case["w"].float()
    got = tops.batched_lora_apply(**case)
    assert got.dtype == torch.bfloat16
    assert seen == [{torch.float32 if mixed else torch.bfloat16}]


def test_cpu_wrapper_counts_no_launch():
    tops.reset_launches()
    la.batched_lora_apply(**_torch(_case(3)))
    assert [k.launches for k in tops.KERNELS] == [0] * len(tops.KERNELS)


def test_strided_page_axis_is_accepted():
    """A per-layer slice t[:, li] of a (C, L, r, K) adapter leaf keeps each
    page contiguous with a strided page axis; the wrapper takes it as is."""
    case = _torch(_case(4))
    stacked_a = torch.stack([case["a_pages"], 2 * case["a_pages"]], dim=1)
    stacked_b = torch.stack([case["b_pages"], 2 * case["b_pages"]], dim=1)
    got = la.batched_lora_apply(case["x"], case["w"], stacked_a[:, 0],
                                stacked_b[:, 0], case["scales"], case["ids"])
    torch.testing.assert_close(got, la.batched_lora_apply(**case), rtol=0,
                               atol=0)


def test_wrapper_checks_its_inputs():
    case = _torch(_case(5))
    with pytest.raises(TypeError):
        la.batched_lora_apply(**dict(case, x=case["x"].double()))
    with pytest.raises(TypeError):
        la.batched_lora_apply(**dict(case, ids=case["ids"].long()))
    with pytest.raises(ValueError, match="rows"):
        la.batched_lora_apply(**dict(case, ids=case["ids"][:, :3]))
    with pytest.raises(ValueError, match="contiguous"):
        la.batched_lora_apply(**dict(
            case, a_pages=case["a_pages"].mT.contiguous().mT))
    with pytest.raises(ValueError, match="do not match"):
        la.batched_lora_apply(**dict(case, scales=case["scales"][:2]))
    with pytest.raises(NotImplementedError, match="backward"):
        la.batched_lora_apply(**dict(case,
                                     x=case["x"].clone().requires_grad_()))


def test_dense_kernel_route_matches_plain_route():
    """``dense_apply(use_kernel=True)`` (K4 with ids = the row's slot, bias
    added after) equals the plain per-client path: slot c's rows use slot
    c's factors and scale (rtol 1e-5: outputs reach ~30 at unit inputs)."""
    rng = np.random.default_rng(6)
    c, t, d_in, d_out, r = 3, 4, 24, 20, 8
    params = {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        "w": rng.normal(size=(d_in, d_out)),
        "b": rng.normal(size=(d_out,)),
        "lora_a": rng.normal(size=(c, r, d_in)),
        "lora_b": rng.normal(size=(c, d_out, r))}.items()}
    x = torch.from_numpy(rng.normal(size=(c, 1, t, d_in)).astype(np.float32))
    scales = torch.tensor([1.0, 0.5, 2.0])
    for rank in (-1, 4):
        want = dense_apply(params, x, lora_scale=scales, lora_rank=rank)
        got = dense_apply(params, x, lora_scale=scales, lora_rank=rank,
                          use_kernel=True)
        assert got.shape == (c, 1, t, d_out)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


# -- the SGEMM route's plan and its split over K ----------------------------

QWEN_128 = {"q": (128, 3584, 3584), "k": (128, 512, 3584)}   # (m, n, k)


@pytest.mark.parametrize("k", [3584, 130, 37, 72])
@pytest.mark.parametrize("m,n", [(128, 3584), (128, 512), (40, 40),
                                 (4096, 3584), (300, 520), (33, 23)])
def test_plan_splits_cover_k_once(m, n, k):
    """The planned ranges tile [0, K) with no gap and no overlap, one range
    a split; each but the last is ``depth`` deep, a multiple of the slab."""
    plan = la.plan_gemm(m, n, k)
    ranges = la.split_ranges(k, plan.depth)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k1 - k0 == plan.depth for k0, k1 in ranges[:-1])
    assert plan.depth % la.SLAB == 0 and 0 < ranges[-1][1] - ranges[-1][0] \
        <= plan.depth
    if plan.splits > 1:
        assert plan.depth >= la.MIN_SPLIT_DEPTH
    assert (plan.bm, plan.bn) in la.TILES
    assert plan.tiles == -(-m // plan.bm) * -(-n // plan.bn)


@pytest.mark.parametrize("m,n,k", [(4096, 3584, 3584), (4096, 512, 3584),
                                   (2048, 1024, 777), (1024, 2048, 64)])
def test_plan_runs_unsplit_when_tiles_fill_the_card(m, n, k):
    plan = la.plan_gemm(m, n, k)
    assert plan.tiles >= la.WAVE and plan.splits == 1
    assert plan.depth >= k


@pytest.mark.parametrize("proj", list(QWEN_128))
def test_plan_fills_the_card_at_qwen2_128_rows(proj):
    """Qwen2-7B's prefill projections at 128 rows: q (and o) 28 tiles of
    128 x 128 in 9 splits of 400 (252 blocks, two an SM on most SMs), k
    (and v) 8 tiles of 64 x 128 in 16 splits of 224; at least one wave of
    blocks, all resident at once, every split >= 128 deep."""
    m, n, k = QWEN_128[proj]
    plan = la.plan_gemm(m, n, k)
    want = {"q": (128, 128, 9, 400), "k": (64, 128, 16, 224)}[proj]
    assert (plan.bm, plan.bn, plan.splits, plan.depth) == want
    assert la.WAVE <= plan.blocks <= la.RESIDENT * la.SMS
    assert all(k1 - k0 >= la.MIN_SPLIT_DEPTH
               for k0, k1 in la.split_ranges(k, plan.depth))
    assert la.describe_plan(m, n, k) == {
        "route": "sgemm", "tile": list(want[:2]), "splits": want[2],
        "depth": want[3], "blocks": plan.blocks}
    assert la.describe_plan(la.GEMV_MAX_ROWS, n, k) == {
        "route": "gemv", **la.plan_gemv(la.GEMV_MAX_ROWS, n, k).report()}


def _split_tol(x, w, a, b, s):
    """(K + r) eps max(|x| |W| + |s| (|x| |A|^T) |B|^T), rows of pages
    gathered already: the worst-case rounding of the f32 sums."""
    x, w, a, b = (np.abs(t.astype(np.float64)) for t in (x, w, a, b))
    mag = x @ w + np.abs(s)[:, None] * np.einsum(
        "mr,mnr->mn", np.einsum("mk,mrk->mr", x, a), b)
    return (w.shape[0] + a.shape[1]) * np.finfo(np.float32).eps * mag.max()


@pytest.mark.parametrize("m,k,n,r", [
    (40, 1024, 40, 8),       # one tile: 8 splits of 128
    (70, 600, 24, 5),        # 5 splits, the last 88 deep (not a slab)
    (35, 72, 56, 16),        # one split
    (20, 300, 30, 4),        # the GEMV route: IEEE f32, 3 splits of 128
    (40, 3584, 64, 16),      # Qwen2-7B's depth: 28 splits of 128
    (300, 130, 520, 12),     # the reference test's odd shape
    (128, 256, 192, 16)])
def test_lora_apply_split_plain_matches_oracle(m, k, n, r):
    """K5's arithmetic in PyTorch (``lora_apply_tf32x3_plain``: above 32
    rows ``plan_gemm_tc``'s ranges, 3xTF32 partials summed in range order;
    at most 32, the GEMV's IEEE f32 products over ``plan_gemv``'s ranges) against ``ref.lora_apply_ref`` (JAX, CPU) at the kernel's unchanged
    tolerance (K + r) eps max(|x||W| + |s||x||A|^T|B|^T)."""
    rng = np.random.default_rng(m + k + n + r)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.normal(size=(r, k)) * k ** -0.5).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    want = np.asarray(ref.lora_apply_ref(*map(jnp.asarray, (x, w, a, b)),
                                         -0.75))
    got = la.lora_apply_tf32x3_plain(*map(torch.from_numpy, (x, w, a, b)),
                                     -0.75)
    tol = _split_tol(x, w, np.broadcast_to(a, (m, r, k)),
                     np.broadcast_to(b, (m, n, r)), np.full(m, 0.75))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("lead,k,n", [((2, 20), 1024, 40), ((70,), 600, 24),
                                      ((5, 7), K, N)])
def test_batched_lora_apply_split_plain_matches_oracle(lead, k, n):
    """K4's split emulation against ``ref.batched_lora_apply_ref`` (JAX,
    CPU) at the kernel's tolerance, pages at ranks 4/8/16 and random ids;
    the first two shapes split K (8 and 5 ranges)."""
    case = _case(7, lead=lead, k=k, n=n)
    got = la.batched_lora_apply_split_plain(**_torch(case))
    assert got.shape == lead + (n,)
    idf = case["ids"].reshape(-1)
    tol = _split_tol(case["x"].reshape(-1, k), case["w"],
                     case["a_pages"][idf], case["b_pages"][idf],
                     case["scales"][idf])
    np.testing.assert_allclose(got.numpy(), _oracle(case), atol=tol, rtol=0)
