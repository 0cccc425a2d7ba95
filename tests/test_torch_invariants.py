"""The reference's property tests of the paper's core invariants
(``tests/test_invariants.py::TestDiagonalFormulationEquivalence`` and
``::TestEnergyPreservation``) on the port's ``pad_stack``,
``omega_raflora``, ``aggregate_flexlora`` and ``aggregate_raflora``,
with the same hypothesis settings, inputs and tolerances."""
import jax
import numpy as np
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # offline: deterministic fixed-grid shim
    from _hypothesis_compat import given, settings, strategies as st

from repro_torch.core.aggregation import (aggregate_flexlora,
                                          aggregate_raflora, pad_stack)
from repro_torch.core.energy import rho
from repro_torch.core.partitions import omega_raflora
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

LEVELS = [4, 8, 16]
R_MAX = 16
D, N = 24, 32


def t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def rand_factors(seed, ranks):
    """The reference's factors (jax.random), as torch tensors."""
    key = jax.random.PRNGKey(seed)
    out = []
    for i, r in enumerate(ranks):
        kb, ka = jax.random.split(jax.random.fold_in(key, i))
        out.append((t(jax.random.normal(kb, (D, r))),
                    t(jax.random.normal(ka, (r, N)))))
    return out


def orthogonal_factors(ranks, sigma, rng_b, rng_a):
    q, _ = np.linalg.qr(rng_b.normal(size=(D, R_MAX)))
    qn, _ = np.linalg.qr(rng_a.normal(size=(N, R_MAX)))
    return [(t(q[:, :r] * sigma[:r]), t(qn[:, :r].T)) for r in ranks]


ZEROS = dict(global_b=torch.zeros(D, R_MAX), global_a=torch.zeros(R_MAX, N))


class TestDiagonalFormulationEquivalence:
    """Eq. 8's partition loop == a single weighted-diagonal contraction
    sum_k B_k diag(omega_k) A_k, on the port's pad_stack and omega."""

    @given(ranks=st.lists(st.sampled_from(LEVELS), min_size=1, max_size=8),
           seed=st.integers(0, 50))
    @settings(max_examples=30, deadline=None)
    def test_raflora_diag_equals_partition_loop(self, ranks, seed):
        rng = np.random.default_rng(seed)
        n_k = rng.integers(1, 50, size=len(ranks)).astype(float)
        factors = rand_factors(seed, ranks)
        bs, as_ = pad_stack(factors, R_MAX)
        omega, fallback = omega_raflora(ranks, n_k, LEVELS)
        diag = np.einsum("mdr,mr,mrn->dn", bs.numpy(), omega, as_.numpy())
        loop = np.zeros((D, N))
        prev = 0
        for h in LEVELS:
            members = [k for k, r in enumerate(ranks) if r >= h]
            n_h = sum(n_k[k] for k in members)
            if members:
                for k in members:
                    b, a = (x.numpy() for x in factors[k])
                    loop += (n_k[k] / n_h) * (b[:, prev:h] @ a[prev:h, :])
            prev = h
        np.testing.assert_allclose(diag, loop, atol=1e-4)


class TestEnergyPreservation:
    """Direction-preserving (orthogonal) updates verify the mechanism
    exactly; "raFLoRA tail >= FlexLoRA tail" is not a per-step inequality
    for arbitrary factors."""

    @given(seed=st.integers(0, 200))
    @settings(max_examples=20, deadline=None)
    def test_raflora_tail_energy_geq_flexlora_orthogonal(self, seed):
        rng = np.random.default_rng(seed)
        ranks = list(rng.choice(LEVELS, size=6))
        if max(ranks) < R_MAX:
            return
        n_k = [1.0] * 6
        q, _ = np.linalg.qr(rng.normal(size=(D, R_MAX)))
        qn, _ = np.linalg.qr(rng.normal(size=(N, R_MAX)))
        sigma = np.sort(rng.uniform(0.5, 4.0, size=R_MAX))[::-1]
        factors = [(t(q[:, :r] * sigma[:r]), t(qn[:, :r].T)) for r in ranks]
        bs, as_ = pad_stack(factors, R_MAX)
        res_fl = aggregate_flexlora(bs, as_, ranks, n_k, backend="dense")
        res_ra = aggregate_raflora(bs, as_, ranks, n_k, rank_levels=LEVELS,
                                   backend="dense", **ZEROS)
        r1 = min(LEVELS)
        tail_fl = 1.0 - float(rho(res_fl.sigma.numpy(), r1))
        tail_ra = 1.0 - float(rho(res_ra.sigma.numpy(), r1))
        assert tail_ra >= tail_fl - 1e-6

    def test_orthogonal_directions_exact_contraction(self):
        """One FlexLoRA step scales sigma_i by exactly the sample coverage
        of direction i (Eq. 7)."""
        ranks = [4, 8, 16, 16]
        sigma = np.linspace(4.0, 1.0, R_MAX)
        factors = orthogonal_factors(ranks, sigma, np.random.default_rng(0),
                                     np.random.default_rng(1))
        bs, as_ = pad_stack(factors, R_MAX)
        res = aggregate_flexlora(bs, as_, ranks, [1.0] * 4, backend="dense")
        got = np.sort(res.sigma.numpy())[::-1]
        cover = np.array([(np.asarray(ranks) >= i + 1).mean()
                          for i in range(R_MAX)])
        np.testing.assert_allclose(got, np.sort(sigma * cover)[::-1],
                                   atol=1e-4)

    def test_raflora_orthogonal_no_dilution(self):
        """Same setup: raFLoRA restores sigma exactly (no p_i factor)."""
        ranks = [4, 8, 16, 16]
        sigma = np.linspace(4.0, 1.0, R_MAX)
        factors = orthogonal_factors(ranks, sigma, np.random.default_rng(0),
                                     np.random.default_rng(1))
        bs, as_ = pad_stack(factors, R_MAX)
        res = aggregate_raflora(bs, as_, ranks, [1.0] * 4,
                                rank_levels=[4, 8, 16], backend="dense",
                                **ZEROS)
        got = np.sort(res.sigma.numpy())[::-1]
        np.testing.assert_allclose(got, np.sort(sigma)[::-1], atol=1e-4)
