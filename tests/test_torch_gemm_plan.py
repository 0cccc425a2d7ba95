"""The shared SGEMM planner of the PyTorch port (``kernels/gemm_plan.py``)
for K2 (Gram cores) and K3 (the dense rank-partitioned aggregate), and the
CPU emulations of the two kernels' arithmetic (``*_split_plain``: the
depth cut as the plan cuts it, the partials summed in range order, K3's
all-zero-weight slabs left out) held to the JAX package's oracles
``ref.gram_cores_ref`` and ``ref.rank_partition_agg_ref``.

The kernels themselves run on the card only (``test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.partitions import omega_raflora
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import rank_partition_agg as rpa

torch.set_num_threads(1)

EPS = np.finfo(np.float32).eps
# the vit-base round's buckets (name, layers, d, n) and R = 6 clients x 32
VIT_BUCKETS = [("attn_qkvo", 48, 768, 768), ("mlp_down", 12, 3072, 768),
               ("mlp_up", 12, 768, 3072)]
VIT_R = 192


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the plans ----------------------------------------------------------------

@pytest.mark.parametrize("layers,depth,want", [
    (48, 768, (4, 192, 1152)),    # attn_qkvo: 288 tiles, half the slots
    (12, 3072, (11, 288, 792)),   # up/down over 3072: 72 tiles
    (12, 768, (5, 160, 360))])    # up/down over 768
def test_gram_plans_at_the_vit_base_buckets(layers, depth, want):
    """K2 at R = 192: 64-wide tiles, 6 of 9 on or above the diagonal. The
    round's (layer, tile) blocks fill none of the buckets' resident slots
    (4 an SM), so each bucket splits its depth: the split that gives the
    busiest SM the least depth to sum, wave after wave."""
    plan = gp.plan_gram(layers, VIT_R, depth)
    assert (plan.bm, plan.bn) == (gp.GRAM_TILE, gp.GRAM_TILE)
    assert (plan.splits, plan.depth, plan.blocks) == want
    assert plan.tiles == layers * 6 < gp.GRAM_RESIDENT * gp.SMS
    assert plan.depth >= gp.MIN_SPLIT_DEPTH


def test_gram_plans_per_side_of_the_round():
    """Each bucket's left side runs over d and its right side over n."""
    got = {(name, side): gp.plan_gram(layers, VIT_R, depth).report()
           for name, layers, d, n in VIT_BUCKETS
           for side, depth in (("left", d), ("right", n))}
    assert got[("attn_qkvo", "left")] == got[("attn_qkvo", "right")] == {
        "tile": [64, 64], "splits": 4, "depth": 192, "blocks": 1152}
    assert got[("mlp_down", "left")] == got[("mlp_up", "right")] == {
        "tile": [64, 64], "splits": 11, "depth": 288, "blocks": 792}
    assert got[("mlp_down", "right")] == got[("mlp_up", "left")] == {
        "tile": [64, 64], "splits": 5, "depth": 160, "blocks": 360}


@pytest.mark.parametrize("layers,m,d,r,n,want", [
    (48, 6, 768, 32, 768, (1, 192, 3456)),
    (12, 6, 3072, 32, 768, (1, 192, 3456)),
    (12, 6, 768, 32, 3072, (1, 192, 3456)),
    (1, 10, 768, 64, 768, (5, 128, 72)),     # bench_kernels' shape
    (1, 4, 300, 16, 520, (1, 64, 25))])      # odd, with fallback
def test_agg_plans(layers, m, d, r, n, want):
    """K3 on 64 x 128 tiles: the vit-base buckets fill the card's resident
    slots (3 an SM) many times over and run unsplit; one layer of M 10,
    d 768, r 64 has 72 tiles over a depth of 640 and splits it 5 ways
    (360 blocks, about three an SM); the odd shape is too shallow to
    split."""
    plan = gp.plan_agg(layers, m, d, r, n)
    assert (plan.bm, plan.bn) == gp.AGG_TILE
    assert (plan.splits, plan.depth, plan.tiles) == want


PLANS = {"gram L 1 R 24": lambda k: gp.plan_gram(1, 24, k),
         "gram L 12 R 200": lambda k: gp.plan_gram(12, 200, k),
         "agg L 1 d 300 n 520": lambda k: gp.plan_agg(1, 1, 300, k, 520),
         "agg L 3 d 64 n 96": lambda k: gp.plan_agg(3, 1, 64, k, 96)}


@pytest.mark.parametrize("kind", list(PLANS))
@pytest.mark.parametrize("k", [3072, 600, 37, 16, 0])
def test_split_plans_cover_the_depth_once(kind, k):
    """The planned ranges tile [0, depth) with no gap and no overlap, one
    range a split, each but the last a multiple of the slab deep."""
    plan = PLANS[kind](k)
    ranges = gp.split_ranges(k, plan.depth)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan.depth % gp.SLAB == 0 and plan.depth >= k / plan.splits
    if plan.splits > 1:
        assert plan.depth >= gp.MIN_SPLIT_DEPTH


def _tile_of(x, tiles):
    """gram.cu's blockIdx.x -> (bi, bj) walk, as the kernel does it."""
    bi = 0
    while x >= tiles - bi:
        x -= tiles - bi
        bi += 1
    return bi, bi + x


@pytest.mark.parametrize("rr", [8, 64, 65, 192, 200, 1024])
def test_upper_tiles_are_each_covered_once(rr):
    """The kernel's linear block index reaches every tile (i <= j) of the
    upper triangle once and no other; the plan launches that many."""
    t = -(-rr // gp.GRAM_TILE)
    want = {(i, j) for i in range(t) for j in range(t) if i <= j}
    got = [_tile_of(x, t) for x in range(t * (t + 1) // 2)]
    assert len(got) == len(set(got)) and set(got) == want
    assert got == sorted(want)          # row by row, as the triangle goes
    assert gp.plan_gram(3, rr, 64).tiles == 3 * len(want)


def test_live_slabs_at_the_round_weights():
    """At the smoke's raFLoRA weights (ranks 4, 8, 8, 16, 16 at levels up to
    32) plus the Eq. 8 fallback client, 6 of the 12 slabs of 16 rank
    columns hold a nonzero weight: each sampled client's first 16, the
    fallback's last 16."""
    omega, fallback = omega_raflora((4, 8, 8, 16, 16),
                                    (120, 80, 100, 60, 140),
                                    (4, 8, 16, 24, 32))
    w = torch.tensor(np.concatenate([omega, fallback[None]]),
                     dtype=torch.float32)
    live = rpa.live_slabs(w)
    assert live.tolist() == [True, False] * 5 + [False, True]
    assert int((w != 0).sum()) == 68        # the bound's nonzero columns


def test_live_slabs_cross_clients_and_count_nan():
    """A slab spans two clients where r % 16 != 0; NaN counts as live."""
    w = torch.zeros(5, 8)
    w[1, 7] = 0.5             # slab 0 (clients 0, 1)
    w[4, 0] = float("nan")    # slab 2 (client 4, padded)
    assert rpa.live_slabs(w).tolist() == [True, False, True]


# -- the split emulations against the JAX oracles -----------------------------

@pytest.mark.parametrize("layers,depth,rr", [
    (1, 600, 24),     # 5 splits of 128, the last 88 deep
    (2, 300, 200),    # ragged R: 4 tiles a side, the last 8 wide
    (3, 37, 64)])     # one split, depth off the slab
def test_gram_split_plain_matches_oracle(layers, depth, rr):
    """K2's split emulations against ``ref.gram_cores_ref`` within
    depth eps max column norm^2 (the worst-case rounding of a length-depth
    f32 dot product), exactly symmetric."""
    rng = np.random.default_rng(depth + rr)
    u = rng.normal(size=(layers, depth, rr)).astype(np.float32)
    v = rng.normal(size=(layers, rr, depth)).astype(np.float32)
    g_u = rpa.gram_left_split_plain(_t(u)).numpy()
    g_v = rpa.gram_right_split_plain(_t(v)).numpy()
    assert g_u.shape == g_v.shape == (layers, rr, rr)
    for ll in range(layers):
        gu_ref, gv_ref = ref.gram_cores_ref(jnp.asarray(u[ll]),
                                            jnp.asarray(v[ll]))
        np.testing.assert_allclose(
            g_u[ll], np.asarray(gu_ref), rtol=0,
            atol=depth * EPS * float((u[ll] ** 2).sum(axis=0).max()))
        np.testing.assert_allclose(
            g_v[ll], np.asarray(gv_ref), rtol=0,
            atol=depth * EPS * float((v[ll] ** 2).sum(axis=1).max()))
        assert np.array_equal(g_u[ll], g_u[ll].T)
        assert np.array_equal(g_v[ll], g_v[ll].T)
    if depth == 600:
        assert gp.plan_gram(layers, rr, depth).splits == 5


def _agg_inputs(seed, layers, m, d, r, n):
    rng = np.random.default_rng(seed)
    bs = rng.normal(size=(layers, m, d, r)).astype(np.float32)
    as_ = rng.normal(size=(layers, m, r, n)).astype(np.float32)
    omega = rng.uniform(size=(m, r)).astype(np.float32)
    omega[1] = -omega[1]                 # a negative weight subtracts
    omega[2:4] = 0.0                     # with r 8: slab 1 all zero
    omega[5, r // 2:] = 0.0              # a client below r_max
    return bs, as_, omega


@pytest.mark.parametrize("layers,m,d,r,n,splits", [
    (1, 12, 300, 24, 520, 2),   # d 300 / n 520, slabs across clients
    (2, 40, 64, 8, 96, 2),      # r 8: two clients a slab
    (3, 6, 24, 12, 17, 1)])     # r 12 (the raw wrapper's odd r)
def test_agg_split_plain_matches_oracle(layers, m, d, r, n, splits):
    """K3's split emulation (the all-zero slabs skipped) against
    ``ref.rank_partition_agg_ref`` per layer within (M r + 2) eps
    max(|B| |omega| |A|)."""
    bs, as_, omega = _agg_inputs(m + d, layers, m, d, r, n)
    assert gp.plan_agg(layers, m, d, r, n).splits == splits
    live = rpa.live_slabs(_t(omega))
    assert not bool(live.all())          # at least one slab is skipped
    got = rpa.rank_partition_agg_layered_split_plain(_t(bs), _t(as_),
                                                     _t(omega)).numpy()
    assert got.shape == (layers, d, n)
    for ll in range(layers):
        want = np.asarray(ref.rank_partition_agg_ref(
            jnp.asarray(bs[ll]), jnp.asarray(as_[ll]), jnp.asarray(omega)))
        mag = np.einsum("mdr,mr,mrn->dn", np.abs(bs[ll]), np.abs(omega),
                        np.abs(as_[ll]))
        np.testing.assert_allclose(got[ll], want, rtol=0,
                                   atol=(m * r + 2) * EPS * mag.max())
    one = rpa.rank_partition_agg_split_plain(_t(bs[0]), _t(as_[0]),
                                             _t(omega))
    want0 = np.asarray(ref.rank_partition_agg_ref(
        jnp.asarray(bs[0]), jnp.asarray(as_[0]), jnp.asarray(omega)))
    np.testing.assert_allclose(one.numpy(), want0, rtol=0,
                               atol=(m * r + 2) * EPS * float(np.einsum(
                                   "mdr,mr,mrn->dn", np.abs(bs[0]),
                                   np.abs(omega), np.abs(as_[0])).max()))
