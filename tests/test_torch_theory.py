"""The port's copy of the Theorem 1 / Appendix A-B theory
(``repro_torch.core.theory``) held to ``repro.core.theory`` exactly, on
the cases of tests/test_theory.py (numpy on both sides, so every number
must be bit-equal)."""
import numpy as np
import pytest
import torch

from repro.core import partitions as jparts
from repro.core import theory as jth
from repro_torch.core import theory as tth

LEVELS = [8, 16, 32, 48, 64]

# the port's modules are torch-importing; one thread keeps parallel test
# workers from oversubscribing cores
torch.set_num_threads(1)


def make_ranks(k=100):
    return np.repeat(LEVELS, k // len(LEVELS))


def _p():
    return jparts.coverage(LEVELS, make_ranks())


@pytest.mark.parametrize("p,k,m", [
    (np.array([1.0]), 100, 10), (np.array([0.0]), 100, 10),
    (np.linspace(0.01, 0.99, 17), 37, 5), (np.linspace(0.1, 1, 10), 50, 50),
    (np.linspace(0, 1, 9), 1, 1)])
def test_h_and_contraction_exact(p, k, m):
    np.testing.assert_array_equal(tth.h_sampling(p, k, m),
                                  jth.h_sampling(p, k, m))
    np.testing.assert_array_equal(tth.contraction_factors(p, k, m, 0.9),
                                  jth.contraction_factors(p, k, m, 0.9))


def test_expected_recursion_and_bound_exact():
    p, e0 = _p(), np.ones(64)
    e_t = tth.simulate_expected(e0, p, 100, 10, rounds=200)
    np.testing.assert_array_equal(
        e_t, jth.simulate_expected(e0, p, 100, 10, rounds=200))
    np.testing.assert_array_equal(tth.rho_series(e_t, 8),
                                  jth.rho_series(e_t, 8))
    assert (tth.collapse_bound(e0, p, 100, 10, r1=8)
            == jth.collapse_bound(e0, p, 100, 10, r1=8))


@pytest.mark.parametrize("rule", ["flexlora", "raflora"])
@pytest.mark.parametrize("seed", [3, 11])
def test_sampled_sim_exact(rule, seed):
    ranks = make_ranks()
    t_run = tth.SampledSim(client_ranks=ranks, M=10, seed=seed).run(
        np.ones(64), 30, rule=rule, rank_levels=LEVELS)
    j_run = jth.SampledSim(client_ranks=ranks, M=10, seed=seed).run(
        np.ones(64), 30, rule=rule, rank_levels=LEVELS)
    np.testing.assert_array_equal(t_run, j_run)
    with pytest.raises(ValueError):
        tth.SampledSim(client_ranks=ranks, M=10).run(np.ones(64), 1,
                                                     rule="other")


@pytest.mark.parametrize("kw", [{}, {"kappa": 0.8}, {"delta2": 0.01},
                                {"beta": 0.9, "lam": 0.1}])
def test_mean_field_exact(kw):
    p, e = _p(), np.ones(64)
    np.testing.assert_array_equal(tth.mean_field_step(e, p, 100, 10, **kw),
                                  jth.mean_field_step(e, p, 100, 10, **kw))
    np.testing.assert_array_equal(tth.mean_field_floor(p, 100, 10, **kw),
                                  jth.mean_field_floor(p, 100, 10, **kw))
