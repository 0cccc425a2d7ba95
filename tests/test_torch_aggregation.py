"""The port's aggregation math held to the JAX package: rank partitions
and energy metrics exactly (numpy on both sides), the Gram-core SVD
reallocation and the grouped kernel-backend aggregation at the kernel
path's tolerances (TestFusedFactoredProperty: spectra within
1e-3 * sigma_max, products within 2e-3 * sigma_max -- the Gram route works
at ~sqrt(eps) relative precision, DESIGN.md §4.3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import energy as jenergy
from repro.core import partitions as jparts
from repro.core.svd import svd_realloc_gram as j_realloc
from repro_torch.core import aggregation as tagg
from repro_torch.core import energy as tenergy
from repro_torch.core import partitions as tparts
from repro_torch.core.svd import svd_realloc_gram as t_realloc

LEVELS = (4, 8, 16)
RANK_CASES = [[4, 8, 16, 16], [4, 4, 8], [16], [8, 4, 8, 4, 4]]

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


@pytest.mark.parametrize("ranks", RANK_CASES)
def test_partitions_exact(ranks):
    n_k = [1.0 + 2 * i for i in range(len(ranks))]
    np.testing.assert_array_equal(tparts.omega_flexlora(ranks, n_k, 16),
                                  jparts.omega_flexlora(ranks, n_k, 16))
    t_om, t_fb = tparts.omega_raflora(ranks, n_k, LEVELS)
    j_om, j_fb = jparts.omega_raflora(ranks, n_k, LEVELS)
    np.testing.assert_array_equal(t_om, j_om)
    np.testing.assert_array_equal(t_fb, j_fb)
    np.testing.assert_array_equal(tparts.coverage(LEVELS, ranks),
                                  jparts.coverage(LEVELS, ranks))
    np.testing.assert_array_equal(tparts.boundary_of_index(LEVELS),
                                  jparts.boundary_of_index(LEVELS))
    assert tparts.partition_bounds(LEVELS) == jparts.partition_bounds(LEVELS)


def test_energy_exact():
    rng = np.random.default_rng(0)
    t_tr, j_tr = tenergy.EnergyTrace(LEVELS), jenergy.EnergyTrace(LEVELS)
    for _ in range(3):
        sigma = np.sort(rng.uniform(size=16).astype(np.float32))[::-1]
        assert (tenergy.higher_rank_energy_ratio(sigma, 4)
                == jenergy.higher_rank_energy_ratio(sigma, 4))
        assert tenergy.effective_rank(sigma) == jenergy.effective_rank(sigma)
        t_tr.record(sigma)
        j_tr.record(sigma)
    assert t_tr.state_dict() == j_tr.state_dict()
    np.testing.assert_array_equal(t_tr.higher_rank_ratio,
                                  j_tr.higher_rank_ratio)
    assert t_tr.collapsed() == j_tr.collapsed()


@pytest.mark.parametrize("present", [None, [True, False, True]])
def test_cohort_weights_exact(present):
    n_k, stal = [3.0, 5.0, 2.0], [0, 2, 1]
    np.testing.assert_array_equal(
        tagg.staleness_discount(n_k, stal, 0.5),
        jagg.staleness_discount(n_k, stal, 0.5))
    np.testing.assert_array_equal(
        tagg.cohort_weights(n_k, stal, present, 0.5),
        jagg.cohort_weights(n_k, stal, present, 0.5))


def _assert_products(t_b, t_a, t_s, j_b, j_a, j_s):
    scale = max(1.0, float(np.abs(np.asarray(j_s)).max()))
    np.testing.assert_allclose(t_s, np.asarray(j_s), atol=1e-3 * scale)
    np.testing.assert_allclose(
        t_b @ t_a, np.asarray(j_b) @ np.asarray(j_a), atol=2e-3 * scale)


@pytest.mark.parametrize("d,rr,n,r_max", [(24, 16, 40, 16), (30, 40, 18, 16),
                                          (12, 8, 10, 16)])
def test_svd_realloc_gram_matches_reference(d, rr, n, r_max):
    """Rank-deficient (R < r_max zero-pads) and R > r_max (truncates)."""
    rng = np.random.default_rng(d + rr)
    u = rng.normal(size=(2, d, rr)).astype(np.float32)
    v = rng.normal(size=(2, rr, n)).astype(np.float32)
    for ll in range(2):
        gu = u[ll].T @ u[ll]
        gv = v[ll] @ v[ll].T
        gu, gv = np.triu(gu) + np.triu(gu, 1).T, np.triu(gv) + np.triu(gv, 1).T
        j = j_realloc(jnp.asarray(u[ll]), jnp.asarray(v[ll]),
                      jnp.asarray(gu), jnp.asarray(gv), r_max)
        t = t_realloc(*(torch.from_numpy(x) for x in (u[ll], v[ll], gu, gv)),
                      r_max)
        assert t[0].shape == (d, r_max) and t[1].shape == (r_max, n)
        _assert_products(*(x.numpy() for x in t), *j)


def _groups(seed, group_ranks, n_adapters, layers, d, n, r_max):
    """Per-rank-group factor stacks with zeros beyond each client's rank,
    the layout the batched engine's masked training produces."""
    rng = np.random.default_rng(seed)
    g_bs, g_as = [], []
    for ranks in group_ranks:
        bt, at = [], []
        for _ in range(n_adapters):
            b = rng.normal(size=(len(ranks), layers, d, r_max))
            a = rng.normal(size=(len(ranks), layers, r_max, n))
            for j, r in enumerate(ranks):
                b[j, ..., r:] = 0.0
                a[j, ..., r:, :] = 0.0
            bt.append(b.astype(np.float32))
            at.append(a.astype(np.float32))
        g_bs.append(bt)
        g_as.append(at)
    gb = [rng.normal(size=(layers, d, r_max)).astype(np.float32)
          for _ in range(n_adapters)]
    ga = [rng.normal(size=(layers, r_max, n)).astype(np.float32)
          for _ in range(n_adapters)]
    return g_bs, g_as, gb, ga


@pytest.mark.parametrize("method", ["flexlora", "raflora"])
@pytest.mark.parametrize("group_ranks", [[[4, 16], [8]], [[4, 4], [8]]],
                         ids=["covered", "eq8_fallback"])
def test_aggregate_grouped_kernel_matches_reference(method, group_ranks):
    """A two-group, two-adapter, two-layer bucket through both packages'
    ``Aggregator.aggregate_grouped`` with ``backend="kernel"`` (the JAX
    side's Pallas grids in interpret mode)."""
    layers, d, n, r_max = 2, 20, 28, max(LEVELS)
    g_bs, g_as, gb, ga = _groups(11, group_ranks, 2, layers, d, n, r_max)
    ranks = [r for g in group_ranks for r in g]
    n_k = [10 + 5 * i for i in range(len(ranks))]
    jr = jagg.Aggregator(method, LEVELS, backend="kernel").aggregate_grouped(
        [[jnp.asarray(x) for x in bt] for bt in g_bs],
        [[jnp.asarray(x) for x in at] for at in g_as], ranks, n_k,
        global_bs=[jnp.asarray(x) for x in gb],
        global_as=[jnp.asarray(x) for x in ga])
    tr = tagg.Aggregator(method, LEVELS, backend="kernel").aggregate_grouped(
        [[torch.from_numpy(x) for x in bt] for bt in g_bs],
        [[torch.from_numpy(x) for x in at] for at in g_as], ranks, n_k,
        global_bs=[torch.from_numpy(x) for x in gb],
        global_as=[torch.from_numpy(x) for x in ga])
    assert tuple(tr.b_g.shape) == (2, layers, d, r_max)
    assert tuple(tr.sigma.shape) == (2, layers, r_max)
    for p in range(2):
        for ll in range(layers):
            _assert_products(tr.b_g[p, ll].numpy(), tr.a_g[p, ll].numpy(),
                             tr.sigma[p, ll].numpy(), jr.b_g[p, ll],
                             jr.a_g[p, ll], jr.sigma[p, ll])


# -- every method through the three Aggregator entry points -------------------

D, N = 24, 40            # tests/test_aggregation.py's shapes
P = 2                    # adapters in a bucket
SVD_CASES = [("flexlora", None), ("raflora", None), ("raflora", 8)]
SVD_RANKS = [4, 8, 8]    # nobody at 16: raFLoRA's (8, 16] takes Eq. 8
AVG_RANKS = {"fedavg": [8, 8, 8], "hetlora": [4, 8, 8, 16],
             "flora": [4, 8, 8, 16], "ffa": [4, 8, 8, 16]}


def _method_inputs(seed, ranks):
    """Per-client factors at their own rank for P adapters, the globals,
    and the rank groups the batched engine would form."""
    rng = np.random.default_rng(seed)
    factors = [[(rng.normal(size=(D, r)).astype(np.float32),
                 rng.normal(size=(r, N)).astype(np.float32))
                for r in ranks] for _ in range(P)]
    gb = rng.normal(size=(P, D, max(LEVELS))).astype(np.float32)
    ga = rng.normal(size=(P, max(LEVELS), N)).astype(np.float32)
    n_k = [10.0 + 7 * i for i in range(len(ranks))]
    return factors, gb, ga, n_k


def _call(pkg, agg, api, factors, gb, ga, ranks, n_k):
    """One Aggregator entry point of ``pkg`` ("t" or "j") on the same
    numpy inputs; returns a list over adapters of (b_g, a_g, sigma, dw)
    as numpy (sigma, dw may be None)."""
    conv = torch.from_numpy if pkg == "t" else jnp.asarray
    r_max = max(LEVELS)
    if api == "layer":
        outs = [agg.aggregate_layer([(conv(b), conv(a)) for b, a in fs],
                                    ranks, n_k, conv(gb[p]), conv(ga[p]))
                for p, fs in enumerate(factors)]
        return [tuple(None if x is None else np.asarray(x) for x in
                      (o.b_g, o.a_g, o.sigma, o.merge_delta)) for o in outs]
    pad = lambda b, a: (np.pad(b, ((0, 0), (0, r_max - b.shape[1]))),
                        np.pad(a, ((0, r_max - a.shape[0]), (0, 0))))
    if api == "stack":
        stacked = [[pad(b, a) for b, a in fs] for fs in factors]
        bs = np.stack([np.stack([b for b, _ in fs]) for fs in stacked], 1)
        as_ = np.stack([np.stack([a for _, a in fs]) for fs in stacked], 1)
        res = agg.aggregate_stack(conv(bs), conv(as_), ranks, n_k,
                                  conv(gb), conv(ga))
    else:   # grouped: one group per rank level, clients in rank order
        groups = sorted(set(ranks))
        order = [i for r in groups for i, ri in enumerate(ranks) if ri == r]
        res = agg.aggregate_grouped(
            [[conv(np.stack([factors[p][i][0] for i in order
                             if ranks[i] == r])) for p in range(P)]
             for r in groups],
            [[conv(np.stack([factors[p][i][1] for i in order
                             if ranks[i] == r])) for p in range(P)]
             for r in groups],
            [ranks[i] for i in order], [n_k[i] for i in order],
            global_bs=[conv(x) for x in gb], global_as=[conv(x) for x in ga])
    return [tuple(None if x is None else np.asarray(x[p]) for x in
                  (res.b_g, res.a_g, res.sigma, res.merge_delta))
            for p in range(P)]


@pytest.mark.parametrize("api", ["layer", "stack", "grouped"])
@pytest.mark.parametrize("backend", ["dense", "factored", "kernel"])
@pytest.mark.parametrize("method,partial", SVD_CASES,
                         ids=["flexlora", "raflora", "raflora-partial8"])
def test_svd_family_matches_reference(method, partial, backend, api):
    """flexlora, raflora and partial raFLoRA on every backend through
    ``aggregate_layer`` / ``aggregate_stack`` / ``aggregate_grouped``
    against the same JAX call (its kernel backend's Pallas grids in
    interpret mode): spectra and products at 1e-4 (dense, factored) or at
    the Gram route's 1e-3 / 2e-3 of sigma_max (kernel)."""
    factors, gb, ga, n_k = _method_inputs(5, SVD_RANKS)
    kw = dict(backend=backend, partial_up_to=partial)
    t_out = _call("t", tagg.Aggregator(method, LEVELS, **kw), api, factors,
                  gb, ga, SVD_RANKS, n_k)
    j_out = _call("j", jagg.Aggregator(method, LEVELS, **kw), api, factors,
                  gb, ga, SVD_RANKS, n_k)
    for (tb, ta, ts, tdw), (jb, ja, js, jdw) in zip(t_out, j_out):
        assert tdw is None and jdw is None
        assert tb.shape == jb.shape and ts.shape == js.shape
        if backend == "kernel":
            _assert_products(tb, ta, ts, jb, ja, js)
        else:
            np.testing.assert_allclose(ts, js, atol=1e-4)
            np.testing.assert_allclose(tb @ ta, jb @ ja, atol=1e-4)


@pytest.mark.parametrize("api", ["layer", "stack", "grouped"])
@pytest.mark.parametrize("method", ["fedavg", "hetlora", "flora", "ffa"])
def test_averaging_family_matches_reference(method, api):
    """fedavg, hetlora, flora and ffa: the raw factors (no SVD, so no sign
    ambiguity) and FLoRA's merge_delta against the same JAX call; FFA
    returns ``global_b`` itself and FLoRA zero adapters."""
    ranks = AVG_RANKS[method]
    factors, gb, ga, n_k = _method_inputs(6, ranks)
    t_out = _call("t", tagg.Aggregator(method, LEVELS), api, factors, gb,
                  ga, ranks, n_k)
    j_out = _call("j", jagg.Aggregator(method, LEVELS), api, factors, gb,
                  ga, ranks, n_k)
    for p, ((tb, ta, ts, tdw), (jb, ja, js, jdw)) in enumerate(
            zip(t_out, j_out)):
        assert ts is None and js is None
        np.testing.assert_allclose(tb, jb, atol=1e-6)
        np.testing.assert_allclose(ta, ja, atol=1e-6)
        if method == "ffa":
            np.testing.assert_array_equal(tb, gb[p])
        if method == "flora":
            assert not tb.any() and not ta.any()
            np.testing.assert_allclose(tdw, jdw, atol=1e-5)
        else:
            assert tdw is None and jdw is None


def test_fedavg_requires_homogeneous():
    """``TestBaselines::test_fedavg_requires_homogeneous``: the same
    AssertionError from both entry points that check it."""
    factors, gb, ga, n_k = _method_inputs(7, [4, 8])
    bs, as_ = tagg.pad_stack([(torch.from_numpy(b), torch.from_numpy(a))
                              for b, a in factors[0]], max(LEVELS))
    with pytest.raises(AssertionError, match="homogeneous"):
        tagg.aggregate_fedavg(bs, as_, [4, 8], n_k)
    with pytest.raises(AssertionError, match="homogeneous"):
        tagg.Aggregator("fedavg", LEVELS).aggregate_grouped(
            [[bs[:1]], [bs[1:]]], [[as_[:1]], [as_[1:]]], [4, 8], n_k)


def test_flora_merge_delta_is_weighted_sum():
    """``TestBaselines::test_flora_merge_delta_unbiased`` on the port."""
    ranks = [4, 8, 8, 16]
    factors, _, _, n_k = _method_inputs(8, ranks)
    res = tagg.Aggregator("flora", LEVELS).aggregate_layer(
        [(torch.from_numpy(b), torch.from_numpy(a)) for b, a in factors[0]],
        ranks, n_k)
    w = np.asarray(n_k) / np.sum(n_k)
    want = sum(wk * (b @ a) for wk, (b, a) in zip(w, factors[0]))
    np.testing.assert_allclose(res.merge_delta.numpy(), want, atol=1e-4)
    assert res.merge_delta.dtype == torch.float32


@pytest.mark.parametrize("backend", ["dense", "factored", "kernel"])
def test_layer_stacked_matches_per_layer_loop(backend):
    """``TestStackedLayers``: (M, L, d, r) factors through one batched
    ``aggregate_layer`` equal the per-layer loop."""
    ranks, layers = [4, 8, 8, 16, 16], 3
    rng = np.random.default_rng(9)
    stacked = [(torch.from_numpy(rng.normal(size=(layers, D, r))
                                 .astype(np.float32)),
                torch.from_numpy(rng.normal(size=(layers, r, N))
                                 .astype(np.float32))) for r in ranks]
    n_k = [10.0, 20.0, 15.0, 25.0, 30.0]
    agg = tagg.Aggregator("raflora", LEVELS, backend=backend)
    g_b = torch.zeros(layers, D, max(LEVELS))
    g_a = torch.zeros(layers, max(LEVELS), N)
    res = agg.aggregate_layer(stacked, ranks, n_k, g_b, g_a)
    for ll in range(layers):
        one = agg.aggregate_layer([(b[ll], a[ll]) for b, a in stacked],
                                  ranks, n_k, g_b[ll], g_a[ll])
        np.testing.assert_allclose((res.b_g[ll] @ res.a_g[ll]).numpy(),
                                   (one.b_g @ one.a_g).numpy(), atol=1e-4)


def test_partial_weights_match_reference():
    """Partial raFLoRA's omega: raFLoRA's up to the cut, FlexLoRA's beyond,
    the fallback cut to zero beyond it -- equal to the reference's."""
    ranks, n_k = [4, 4, 8], [3.0, 5.0, 2.0]
    for cut in (4, 8):
        t_om, t_fb = tagg.Aggregator("raflora", LEVELS, partial_up_to=cut
                                     )._svd_weights(ranks, n_k)
        j_om, j_fb = jagg.Aggregator("raflora", LEVELS, partial_up_to=cut
                                     )._svd_weights(ranks, n_k)
        np.testing.assert_array_equal(t_om, j_om)
        assert (t_fb is None) == (j_fb is None)
        if t_fb is not None:
            np.testing.assert_array_equal(t_fb, j_fb)
        np.testing.assert_array_equal(
            t_om[:, :cut], tparts.omega_raflora(ranks, n_k, LEVELS)[0][:, :cut])
        np.testing.assert_array_equal(
            t_om[:, cut:], tparts.omega_flexlora(ranks, n_k, 16)[:, cut:])
