"""The port's SSD path (``repro_torch.models.layers.ssd``, the SSD scan K6's
plain version behind ``kernels.ops.ssd_scan``, and the ``kind="ssm"``
model) held to the JAX package at shared numpy inputs and JAX-initialised
weights carried over by ``repro_torch.convert``.

Tolerances:
- the scan: atol 2e-4, rtol 1e-3, the reference's own
  (``tests/test_kernels.py::TestSSDScanKernel``);
- single layers (conv, one decode step, one mixer): rtol 1e-4, atol 1e-5;
- the reduced mamba2 model: rtol 1e-4, atol 1e-4 on logits and states of
  scale 1-8. The chunked dual form takes exp(cum_i - cum_j) of two cumsums
  of dt*A (|A| up to 16), so an f32 GEMM rounding of dt moves the decays
  by ~|cum| eps: the JAX model's own f32 logits sit 2.5e-5 from a run
  whose projections are float64, and the two packages' f32 runs 4.6e-5
  apart, so 1e-5 would test rounding order, not the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LoRAConfig as JLoRA
from repro.configs import SSMConfig as JSSM
from repro.configs import get_config as j_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model
from repro.models.layers import ssd as jssd
from repro_torch.configs import LoRAConfig, SSMConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.layers import ssd as tssd
from repro_torch.models.transformer import Model

torch.set_num_threads(1)

SCAN_TOL = dict(atol=2e-4, rtol=1e-3)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LEVELS = (4, 8, 16)


def _scan_inputs(seed, bsz, length, nheads, hp, groups, n, init=False):
    """x, dt (post-softplus), a_log, b, c, d_skip [, init_state] as numpy
    f32, the reference test's distributions."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(bsz, length, nheads, hp)),
           np.log1p(np.exp(rng.normal(size=(bsz, length, nheads)))),
           0.5 * rng.normal(size=(nheads,)),
           0.3 * rng.normal(size=(bsz, length, groups, n)),
           0.3 * rng.normal(size=(bsz, length, groups, n)),
           rng.normal(size=(nheads,))]
    if init:
        out.append(rng.normal(size=(bsz, nheads, hp, n)))
    return [a.astype(np.float32) for a in out]


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


SHAPES = [(2, 64, 8, 16, 2, 24, 16), (1, 32, 4, 8, 1, 16, 8),
          (2, 128, 8, 32, 4, 16, 32), (2, 96, 12, 24, 3, 20, 32)]


@pytest.mark.parametrize("bsz,length,nheads,hp,groups,n,chunk", SHAPES,
                         ids=["g2", "small", "g4", "odd-h12-g3-p24-n20"])
def test_scan_matches_sequential_and_chunked_references(
        bsz, length, nheads, hp, groups, n, chunk):
    """The reference's three ``TestSSDScanKernel`` shapes and an odd one
    (12 heads over 3 groups, P=24, N=20): ``ops.ssd_scan`` on CPU tensors
    (K6's plain version) against the token-by-token recurrence and the
    reference's chunked form."""
    arrs = _scan_inputs(bsz + length + nheads, bsz, length, nheads, hp,
                        groups, n)
    y, s = ops.ssd_scan(*_t(arrs), chunk)
    assert y.shape == (bsz, length, nheads, hp) and y.dtype == torch.float32
    assert s.shape == (bsz, nheads, hp, n) and s.dtype == torch.float32
    for ref_y, ref_s in (jref.ssd_scan_sequential_ref(*_j(arrs)),
                         jref.ssd_scan_ref(*_j(arrs), chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **SCAN_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), **SCAN_TOL)


def test_scan_matches_reference_pallas_kernel():
    """Against the reference's Pallas ``ops.ssd_scan`` (interpret mode on
    the CPU), with an initial state."""
    arrs = _scan_inputs(3, 1, 32, 4, 8, 2, 16, init=True)
    y, s = ops.ssd_scan(*_t(arrs[:6]), 8, init_state=_t(arrs[6:])[0])
    jy, js = jops.ssd_scan(*_j(arrs[:6]), chunk=8,
                           init_state=jnp.asarray(arrs[6]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SCAN_TOL)


def test_initial_state_carry():
    """Scanning the first half, then the second half from its final state,
    equals one scan of the whole (the prefill-continuation invariant)."""
    x, dt, alog, b, c, d = _t(_scan_inputs(5, 1, 64, 4, 8, 1, 16))
    d = torch.zeros_like(d)
    half = 32
    y1, s1 = ops.ssd_scan(x[:, :half], dt[:, :half], alog, b[:, :half],
                          c[:, :half], d, 16)
    y2, s2 = ops.ssd_scan(x[:, half:], dt[:, half:], alog, b[:, half:],
                          c[:, half:], d, 16, init_state=s1)
    y, s = ops.ssd_scan(x, dt, alog, b, c, d, 16)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **SCAN_TOL)


def test_scan_contract_errors():
    """``chunk = min(chunk, L)``; a length that is not a multiple of the
    chunk, heads that do not split into groups and a mismatched shape
    raise, as the reference asserts; the wrapper refuses inputs that need
    a gradient (K6 has no backward)."""
    arrs = _t(_scan_inputs(6, 1, 24, 4, 8, 2, 16))
    y_full, _ = ops.ssd_scan(*arrs, 64)                 # chunk -> 24
    y_one, _ = ops.ssd_scan(*arrs, 24)
    assert torch.equal(y_full, y_one)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*arrs, 16)
    x, dt, alog, b, c, d = arrs
    with pytest.raises(ValueError, match="groups"):
        ops.ssd_scan(x, dt, alog, torch.cat([b, b[:, :, :1]], 2),
                     torch.cat([c, c[:, :, :1]], 2), d, 8)
    with pytest.raises(ValueError, match="dt"):
        ops.ssd_scan(x, dt[:, :-1], alog, b, c, d, 8)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_scan(x.requires_grad_(), dt, alog, b, c, d, 8)
    assert ops.ssd_scan in ops.KERNELS


# ---------------------------------------------------------------------------
# single layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(7)
    xbc = rng.normal(size=(3, 10, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    state = (rng.normal(size=(3, 3, 12)).astype(np.float32)
             if with_state else None)
    jo, jf = jssd._causal_conv(*_j([xbc, w, bias]),
                               None if state is None else jnp.asarray(state))
    to, tf = tssd._causal_conv(*_t([xbc, w, bias]),
                               None if state is None
                               else torch.from_numpy(state))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LAYER_TOL)
    # the carried state is the last K-1 inputs, bit for bit
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_decode_step_matches_reference():
    rng = np.random.default_rng(8)
    r, h, p, g, n = 3, 6, 8, 3, 5
    arrs = [rng.normal(size=(r, h, p)),
            np.log1p(np.exp(rng.normal(size=(r, h)))),
            0.5 * rng.normal(size=(h,)), rng.normal(size=(r, g, n)),
            rng.normal(size=(r, g, n)), rng.normal(size=(h,)),
            rng.normal(size=(r, h, p, n))]
    arrs = [a.astype(np.float32) for a in arrs]
    jy, js = jssd.ssd_decode_step(*_j(arrs))
    ty, ts = tssd.ssd_decode_step(*_t(arrs))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)


def _mixer_case(seed=9, d_model=32):
    """A reduced SSD mixer (ngroups 2) from JAX init with per-client factors
    at ranks 16 and 4 (columns beyond each rank zero, as the adapter store
    packs them) for two clients."""
    jcfg = JSSM(state_dim=8, head_dim=8, expand=2, conv_dim=4, chunk_size=8,
                ngroups=2)
    tcfg = SSMConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, jssd.ssd_init(
        jax.random.PRNGKey(seed), d_model, jcfg,
        lora_ranks={"ssm_in_proj": 16, "ssm_out_proj": 16}))
    rng = np.random.default_rng(seed)
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params.items()}
    params["dt_bias"] = (0.5 * rng.normal(size=params["dt_bias"].shape)
                         ).astype(np.float32)
    for proj in ("in_proj", "out_proj"):
        a, b = params[proj]["lora_a"], params[proj]["lora_b"]
        keep = (np.arange(16)[None, :] < np.array([16, 4])[:, None])
        params[proj]["lora_a"] = (np.stack([a, a]) * 0.5
                                  * keep[:, :, None]).astype(np.float32)
        params[proj]["lora_b"] = (0.1 * rng.normal(size=(2,) + b.shape)
                                  * keep[:, None, :]).astype(np.float32)
    return jcfg, tcfg, params, params_from_numpy(params, "cpu"), rng


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixer_apply_matches_reference(use_kernel):
    """Two clients (C = 2, one sequence each) at ranks 16 and 4 with carried
    conv and SSM states: output and both final states. ``use_kernel``
    takes K6's wrapper, which runs its plain version on CPU tensors."""
    jcfg, tcfg, params, tparams, rng = _mixer_case()
    dims = jssd.ssd_dims(32, jcfg)
    u = rng.normal(size=(2, 16, 32)).astype(np.float32)
    conv = rng.normal(size=(2, 3, dims["conv_ch"])).astype(np.float32)
    ssm = rng.normal(size=(2, dims["nheads"], dims["head_dim"], 8)
                     ).astype(np.float32)
    jy, (jc, js) = jssd.ssd_mixer_apply(
        params, jnp.asarray(u), 32, jcfg, conv_state=jnp.asarray(conv),
        ssm_state=jnp.asarray(ssm))
    ty, (tc, ts) = tssd.ssd_mixer_apply(
        tparams, torch.from_numpy(u)[:, None], 32, tcfg,
        conv_state=torch.from_numpy(conv), ssm_state=torch.from_numpy(ssm),
        use_kernel=use_kernel)
    np.testing.assert_allclose(ty[:, 0].numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LAYER_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)


def test_mixer_decode_matches_reference():
    jcfg, tcfg, params, tparams, rng = _mixer_case(seed=10)
    dims = jssd.ssd_dims(32, jcfg)
    u = rng.normal(size=(2, 1, 32)).astype(np.float32)
    conv = rng.normal(size=(2, 3, dims["conv_ch"])).astype(np.float32)
    ssm = rng.normal(size=(2, dims["nheads"], dims["head_dim"], 8)
                     ).astype(np.float32)
    jy, (jc, js) = jssd.ssd_mixer_decode(
        params, jnp.asarray(u), 32, jcfg, jnp.asarray(conv),
        jnp.asarray(ssm))
    ty, (tc, ts) = tssd.ssd_mixer_decode(
        tparams, torch.from_numpy(u)[:, None], 32, tcfg,
        torch.from_numpy(conv), torch.from_numpy(ssm))
    np.testing.assert_allclose(ty[:, 0].numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **LAYER_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **LAYER_TOL)


# ---------------------------------------------------------------------------
# the reduced mamba2 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_pair():
    """Reduced mamba2-1.3b (2 layers, d 256, 16 SSD heads of 32, N 16,
    chunk 32, tied head) on both sides from one set of JAX weights, with
    nonzero LoRA B and dt_bias so every term is exercised."""
    jcfg = j_get_config("mamba2-1.3b").reduced()
    tcfg = get_config("mamba2-1.3b").reduced()
    jm = build_model(jcfg, JLoRA(rank_levels=LEVELS), dtype=jnp.float32,
                     remat=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def perturb(path, x):
        if path[-1].key in ("lora_b", "dt_bias"):
            return (0.05 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(perturb, params)
    tm = Model(tcfg, LoRAConfig(rank_levels=LEVELS), device="cpu")
    return jcfg, jm, tm, params, params_from_numpy(params, "cpu")


def test_init_keeps_the_reference_tree(mamba_pair):
    """``Model.init`` draws the reference's leaves and shapes: norm1 and
    the SSD mixer per layer, no ``lm_head`` (tied head)."""
    from repro_torch.core.lora import flatten
    cfg, jm, tm, params, tparams = mamba_pair
    got = tm.init(torch.Generator().manual_seed(0))
    assert "lm_head" not in got and set(got["layers"]) == {"norm1", "ssm"}
    assert {p: tuple(t.shape) for p, t in flatten(got).items()} == \
        {p: tuple(t.shape) for p, t in flatten(tparams).items()}


def test_prefill_and_ragged_decode_match_reference(mamba_pair):
    """Prefill of 64-token prompts (two chunks of 32): logits and every
    ``conv``/``ssm`` cache leaf; then three decode steps from a cache with
    a ragged (B,) ``len``: logits, both states and ``len`` at each step."""
    cfg, jm, tm, params, tparams = mamba_pair
    rng = np.random.default_rng(1)
    b, lp, max_len = 2, 64, 70
    toks = rng.integers(0, cfg.vocab_size, size=(b, lp)).astype(np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert set(tc) == set(jc) == {"conv", "ssm"}
    for key in jc:
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **MODEL_TOL)

    shapes = jax.tree.map(lambda s: (s.shape, s.dtype),
                          jm.cache_shapes(b, max_len))
    tshapes = tm.cache_shapes(b, max_len)
    for key in ("conv", "ssm"):
        assert tshapes["layers"][key].shape == shapes["layers"][key][0]
    assert set(tshapes["layers"]) == {"conv", "ssm"}
    lens = np.array([lp, 50], np.int32)
    jcache = {"layers": {k: jnp.asarray(v) for k, v in jc.items()},
              "len": jnp.asarray(lens)}
    tcache = {"layers": {k: torch.from_numpy(np.asarray(v).copy())
                         for k, v in jc.items()},
              "len": torch.from_numpy(lens.copy())}
    tok = rng.integers(0, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    for _ in range(3):
        jl, jcache = jm.decode_step(params, {"token": jnp.asarray(tok)},
                                    jcache)
        with torch.no_grad():
            tl, tcache = tm.decode_step(
                tparams, {"token": torch.from_numpy(tok)}, tcache)
        assert tl.shape == (b, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        for key in ("conv", "ssm"):
            np.testing.assert_allclose(tcache["layers"][key].numpy(),
                                       np.asarray(jcache["layers"][key]),
                                       **MODEL_TOL)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)


def test_kernel_route_equals_plain_route_on_cpu(mamba_pair):
    """``use_kernels=True`` sends the scan through K6's wrapper, which on
    CPU tensors computes the plain version: bit-equal logits and caches,
    and no launch counted."""
    cfg, jm, tm, params, tparams = mamba_pair
    km = Model(tm.cfg, tm.lora, device="cpu", use_kernels=True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
    before = ops.ssd_scan.launches
    with torch.no_grad():
        want = tm.prefill(tparams, {"tokens": toks})
        got = km.prefill(tparams, {"tokens": toks})
    assert torch.equal(got[0], want[0])
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key])
    assert ops.ssd_scan.launches == before
