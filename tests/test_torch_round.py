"""One synchronous round of the port, held to the JAX package's round
from identical state for every method (batched engine, kernel backend,
plus the dense and factored backends, partial raFLoRA and the sequential
engine), the port's two engines held to each other, the reference's FLoRA
cold-start fault pinned in both packages, and the paper's headline
contrast reproduced by the port alone.

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
from repro_torch.core.lora import flatten
from repro_torch.federation.experiment import build_experiment as t_build
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

SMALL = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                           "participation": 0.5},
             lora_overrides={"rank_levels": (4, 8, 16),
                             "rank_probs": (0.34, 0.33, 0.33)},
             samples_per_class=30, num_classes=6, d_model=32,
             batches_per_round=1, backend="kernel")

# tiny CPU matmuls: one torch thread keeps parallel test workers (and
# JAX's own thread pool in the same process) from oversubscribing cores
torch.set_num_threads(1)


HOMOGENEOUS = {"rank_levels": (8,), "rank_probs": (1.0,)}   # fedavg
ROUND_CASES = [
    pytest.param("flexlora", {}, id="flexlora"),
    pytest.param("raflora", {}, id="raflora"),
    pytest.param("fedavg", {"lora_overrides": HOMOGENEOUS}, id="fedavg"),
    pytest.param("hetlora", {}, id="hetlora"),
    pytest.param("flora", {}, id="flora"),
    pytest.param("ffa", {}, id="ffa"),
    pytest.param("raflora", {"backend": "factored"}, id="raflora-factored"),
    pytest.param("raflora", {"backend": "dense", "partial_up_to": 8},
                 id="raflora-dense-partial8"),
    pytest.param("raflora", {"round_engine": "sequential"},
                 id="raflora-sequential"),
]


def _pair(method, **kw):
    """The JAX experiment and the port's, from the JAX weights."""
    args = {**SMALL, **kw}
    je = j_build(method, **args)
    params = jax.tree.map(np.asarray,
                          j_merge(je.server.base, je.server.global_lora))
    te = t_build(method, device="cpu",
                 base_params=params_from_numpy(params, "cpu"), **args)
    return je, te, params


def _factors(server):
    """{parent: (B, A)} numpy of the global adapters (DoRA magnitudes,
    the ``(parent, "m")`` entries, left out)."""
    r_max = server.lora_cfg.r_max
    return {tuple(p): tuple(np.asarray(x) for x in f) for p, f in
            server._extract_factors(server.global_lora, r_max).items()
            if not isinstance(p[0], tuple)}


def _magnitudes(server):
    """{parent: DoRA magnitude} numpy of the global adapters."""
    r_max = server.lora_cfg.r_max
    return {tuple(p[0]): np.asarray(m) for p, m in
            server._extract_factors(server.global_lora, r_max).items()
            if isinstance(p[0], tuple)}


def _base_leaves(server):
    """{path: numpy} of the base tree, JAX (None leaves) or port."""
    if isinstance(jax.tree.leaves(server.base)[0], torch.Tensor):
        return {p: x.numpy().copy() for p, x in flatten(server.base).items()}
    return {tuple(str(getattr(k, "key", k)) for k in p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(server.base)}


@pytest.mark.parametrize("method,kw", ROUND_CASES)
def test_batched_kernel_round_matches_jax(method, kw):
    """One round of each method (kernel backend and batched engine unless
    the case says otherwise) in both packages from the same weights: same
    clients and ranks, loss at rtol 1e-4, spectra and products at the
    kernel path's tolerances (1e-4 of the largest product on the dense and
    factored backends and the averaging family), base weights -- which
    FLoRA moves -- at rtol 1e-4, atol 1e-5."""
    je, te, params = _pair(method, **kw)
    (sj,), (st,) = je.server.run(1), te.server.run(1)
    assert st.clients == sj.clients and st.ranks == sj.ranks
    np.testing.assert_allclose(st.mean_client_loss, sj.mean_client_loss,
                               rtol=1e-4)
    kernel = kw.get("backend", "kernel") == "kernel"
    scale = 1.0
    if sj.sigma_probe is None:
        assert st.sigma_probe is None
    else:
        scale = max(1.0, float(np.abs(sj.sigma_probe).max()))
        np.testing.assert_allclose(st.sigma_probe, sj.sigma_probe,
                                   atol=(1e-3 if kernel else 1e-4) * scale)
        np.testing.assert_allclose(te.server.energy.rho_r1,
                                   je.server.energy.rho_r1, atol=1e-3)
    fj, ft = _factors(je.server), _factors(te.server)
    assert list(ft) == list(fj)                  # same adapter order
    for parent, (b, a) in fj.items():
        tb, ta = ft[parent]
        want = b @ a
        tol = (2e-3 * scale if kernel and sj.sigma_probe is not None
               else 1e-4 * max(1.0, np.abs(want).max()))
        np.testing.assert_allclose(tb @ ta, want, atol=tol)
    tbase, jbase = _base_leaves(te.server), _base_leaves(je.server)
    assert tbase.keys() == jbase.keys()
    for path, x in jbase.items():
        np.testing.assert_allclose(tbase[path], x, rtol=1e-4, atol=1e-5)
    if method == "ffa":         # the frozen factor is the global one
        for path, x in flatten(te.server.global_lora).items():
            if path[-1] == "lora_a":
                j_leaf = params
                for key in path:
                    j_leaf = j_leaf[key]
                np.testing.assert_array_equal(x.numpy(), j_leaf)
    assert te.server.adapter_version == 1
    assert np.isfinite(te.eval_accuracy())


def test_flora_cold_start_fault_pinned_in_both_packages():
    """Reference fault, copied for parity (ROADMAP.md queue 3): FLoRA's
    cold start zeroes BOTH global factors, so no client factor gets a
    gradient afterwards. In both packages round 0 moves the base weights
    and leaves every global adapter leaf at 0; round 1 moves the base by
    exactly nothing."""
    je, te, _ = _pair("flora")
    for exp in (je, te):
        base0 = _base_leaves(exp.server)
        exp.server.run(1)
        leaves = [np.asarray(x) for x in (
            flatten(exp.server.global_lora).values() if exp is te
            else jax.tree.leaves(exp.server.global_lora))]
        assert leaves and not any(x.any() for x in leaves)
        base1 = _base_leaves(exp.server)
        assert max(np.abs(base1[p] - base0[p]).max() for p in base0) > 0
        exp.server.run(1)
        base2 = _base_leaves(exp.server)
        for path, x in base1.items():
            np.testing.assert_array_equal(base2[path], x)


ENGINE_CASES = [
    pytest.param(m, {"lora_overrides": HOMOGENEOUS} if m == "fedavg" else {},
                 id=m)
    for m in ("fedavg", "hetlora", "flora", "flexlora", "raflora", "ffa")
] + [pytest.param("raflora", {"backend": "kernel"}, id="raflora-kernel"),
     pytest.param("raflora", {"backend": "dense", "partial_up_to": 8},
                  id="raflora-dense-partial8")]


@pytest.mark.parametrize("method,kw", ENGINE_CASES)
def test_sequential_matches_batched(method, kw):
    """The port's ``TestRoundEngineEquivalence``: one round of the
    sequential engine against the batched one from the same weights, with
    its tolerances (loss rtol 1e-4; spectra rtol/atol 1e-4; products atol
    1e-4 of the largest; base weights rtol 1e-4, atol 1e-5). Default
    backend (factored) unless the case says otherwise."""
    args = {**SMALL, "backend": "factored", **kw}
    runs = {}
    base = None
    for engine in ("sequential", "batched"):
        exp = t_build(method, device="cpu", round_engine=engine,
                      base_params=base, **args)
        base = base or exp.server.global_params()
        runs[engine] = (exp.server, exp.server.run(1)[0])
    (s_seq, h_seq), (s_bat, h_bat) = runs["sequential"], runs["batched"]
    assert h_seq.clients == h_bat.clients and h_seq.ranks == h_bat.ranks
    np.testing.assert_allclose(h_seq.mean_client_loss, h_bat.mean_client_loss,
                               rtol=1e-4)
    assert (h_seq.sigma_probe is None) == (h_bat.sigma_probe is None)
    if h_seq.sigma_probe is not None:
        np.testing.assert_allclose(h_seq.sigma_probe, h_bat.sigma_probe,
                                   rtol=1e-4, atol=1e-4)
    f_seq, f_bat = _factors(s_seq), _factors(s_bat)
    for parent, (b, a) in f_seq.items():
        d1, d2 = b @ a, f_bat[parent][0] @ f_bat[parent][1]
        np.testing.assert_allclose(d1, d2,
                                   atol=1e-4 * max(1.0, np.abs(d1).max()))
    b_seq, b_bat = _base_leaves(s_seq), _base_leaves(s_bat)
    for path, x in b_seq.items():
        np.testing.assert_allclose(x, b_bat[path], rtol=1e-4, atol=1e-5)


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
