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
    assert la.describe_plan(la.GEMV_MAX_ROWS, n, k) == {"route": "gemv"}


def _split_tol(x, w, a, b, s):
    """(K + r) eps max(|x| |W| + |s| (|x| |A|^T) |B|^T), rows of pages
    gathered already: the worst-case rounding of the f32 sums."""
    x, w, a, b = (np.abs(t.astype(np.float64)) for t in (x, w, a, b))
    mag = x @ w + np.abs(s)[:, None] * np.einsum(
        "mr,mnr->mn", np.einsum("mk,mrk->mr", x, a), b)
    return (w.shape[0] + a.shape[1]) * np.finfo(np.float32).eps * mag.max()


@pytest.mark.parametrize("m,k,n,r", [
    (40, 1024, 40, 8),       # one 64 x 128 tile: 8 splits of 128
    (70, 600, 24, 5),        # 5 splits, the last 88 deep (not a slab)
    (35, 72, 56, 16),        # one split
    (20, 300, 30, 4)])       # the GEMV route: one range
def test_lora_apply_split_plain_matches_oracle(m, k, n, r):
    """K5's split emulation against ``ref.lora_apply_ref`` (JAX, CPU) at
    the kernel's tolerance (K + r) eps max(|x||W| + |s||x||A|^T|B|^T)."""
    rng = np.random.default_rng(m + k + n + r)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.normal(size=(r, k)) * k ** -0.5).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    want = np.asarray(ref.lora_apply_ref(*map(jnp.asarray, (x, w, a, b)),
                                         -0.75))
    got = la.lora_apply_split_plain(*map(torch.from_numpy, (x, w, a, b)),
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
