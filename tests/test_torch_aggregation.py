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
