"""One synchronous round of the port's batched engine with the kernel
backend, held to the JAX package's round from identical state, and the
paper's headline contrast reproduced by the port alone.

Round parity follows ``TestRoundEngineEquivalence`` (test_federation.py):
one round only (multi-round trajectories diverge chaotically through the
truncated SVD's noise tail), same clients and ranks, loss at rtol 1e-4,
and adapter PRODUCTS B_g A_g (sign-stable, unlike raw SVD factors) and
spectra at the kernel path's tolerances (2e-3 and 1e-3 of sigma_max)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.lora import merge_lora as j_merge
from repro.federation.experiment import build_experiment as j_build
from repro_torch.convert import params_from_numpy
from repro_torch.federation.experiment import build_experiment as t_build

SMALL = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                           "participation": 0.5},
             lora_overrides={"rank_levels": (4, 8, 16),
                             "rank_probs": (0.34, 0.33, 0.33)},
             samples_per_class=30, num_classes=6, d_model=32,
             batches_per_round=1, backend="kernel")

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


@pytest.mark.parametrize("method", ["flexlora", "raflora"])
def test_batched_kernel_round_matches_jax(method):
    je = j_build(method, **SMALL)
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    te = t_build(method, device="cpu",
                 base_params=params_from_numpy(params, "cpu"), **SMALL)
    (sj,), (st,) = je.server.run(1), te.server.run(1)
    assert st.clients == sj.clients and st.ranks == sj.ranks
    np.testing.assert_allclose(st.mean_client_loss, sj.mean_client_loss,
                               rtol=1e-4)
    scale = max(1.0, float(np.abs(sj.sigma_probe).max()))
    np.testing.assert_allclose(st.sigma_probe, sj.sigma_probe,
                               atol=1e-3 * scale)
    np.testing.assert_allclose(te.server.energy.rho_r1,
                               je.server.energy.rho_r1, atol=1e-3)
    r_max = je.server.lora_cfg.r_max
    fj = je.server._extract_factors(je.server.global_lora, r_max)
    ft = te.server._extract_factors(te.server.global_lora, r_max)
    assert list(ft) == [tuple(p) for p in fj]    # same adapter order
    for parent, (b, a) in fj.items():
        tb, ta = ft[tuple(parent)]
        np.testing.assert_allclose((tb @ ta).numpy(),
                                   np.asarray(b) @ np.asarray(a),
                                   atol=2e-3 * scale)
    assert te.server.adapter_version == 1
    assert np.isfinite(te.eval_accuracy())


def test_flexlora_collapses_raflora_prevents():
    """``TestPaperClaims::test_flexlora_collapses_raflora_prevents`` on
    the port alone (its own weights, kernel backend, batched engine)."""
    results = {}
    for method in ("flexlora", "raflora"):
        exp = t_build(method, fl_overrides={"num_rounds": 12},
                      samples_per_class=60, num_classes=12, d_model=96,
                      batches_per_round=1, backend="kernel", device="cpu")
        exp.server.run(12)
        results[method] = exp.server.energy.higher_rank_ratio
    assert results["flexlora"][-1] < 0.5 * results["flexlora"][0]
    assert results["raflora"][-1] > 0.8 * results["raflora"][0]
