"""The port's compressed update transport (``federation/transport.py``)
held to the JAX package's on the same numpy inputs, and its one
dequantization point in the aggregation and the kernel API.

Tolerances: the quantizer (payload, scales, error-feedback residuals,
top-k) is bit-equal to the reference, ties included; aggregating
identical QuantFactor stacks meets the kernel path's tolerances
(``tests/test_torch_aggregation.py``: spectra within 1e-3 * sigma_max,
products within 2e-3 * sigma_max); the kernel API's dequant entry is
bit-equal to feeding it the dequantized tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.federation import transport as jtx
from repro_torch.core import aggregation as tagg
from repro_torch.federation import transport as ttx
from repro_torch.kernels import ops
from _torch_one_core import one_core  # noqa: F401  (autouse fixture)

torch.set_num_threads(1)

LEVELS = (4, 8, 16)


def _inputs(seed, lead=(3, 2), d=16, r=8, n=12, zero_cols=2):
    """A (B, A) stack with zero columns beyond the rank and a small
    residual, the masked-training layout."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=lead + (d, r)).astype(np.float32)
    a = rng.normal(size=lead + (r, n)).astype(np.float32)
    b[..., r - zero_cols:] = 0.0
    a[..., r - zero_cols:, :] = 0.0
    eb = (0.01 * rng.normal(size=b.shape)).astype(np.float32)
    ea = (0.01 * rng.normal(size=a.shape)).astype(np.float32)
    return b, a, eb, ea


def _flat(out):
    """(qb, qa, rb, ra) of either package -> float64 numpy arrays (int8 and
    bf16 payloads are exact in f64) and the payload dtypes."""
    qb, qa, rb, ra = out
    arrs = [qb.q, qb.scale, qa.q, qa.scale, rb, ra]
    if isinstance(rb, torch.Tensor):
        return ([x.double().numpy() for x in arrs],
                [str(qb.q.dtype).split(".")[-1], str(qa.q.dtype)
                 .split(".")[-1]])
    return ([np.asarray(x).astype(np.float64) for x in arrs],
            [str(np.asarray(qb.q).dtype), str(np.asarray(qa.q).dtype)])


@pytest.mark.parametrize("top_k", [None, 3], ids=["all", "top3"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_encode_pair_bit_equal(mode, top_k):
    """``_encode_pair`` on the same numpy inputs: payload, scales and the
    residuals bit for bit, over several draws."""
    for seed in range(6):
        b, a, eb, ea = _inputs(seed)
        j = jtx._encode_pair(jnp.asarray(b), jnp.asarray(a), eb, ea,
                             mode=mode, top_k=top_k)
        t = ttx._encode_pair(*(torch.from_numpy(x) for x in (b, a, eb, ea)),
                             mode=mode, top_k=top_k)
        (ja, jd), (ta, td) = _flat(j), _flat(t)
        assert td == jd
        for x, y in zip(ta, ja):
            np.testing.assert_array_equal(x, y)


def _special_inputs(case: str):
    """A (2, 6, 4) B and a (2, 4, 5) A from a seed, lead 0 made special:
    "nan" a NaN in B's column 1; "inf" an inf in B's column 2; "zero"
    columns 1-3 of both factors zero (fewer than k nonzero); "tie"
    columns 0 and 2 equal, so they tie at the 2nd largest energy under
    the scaled column 3. Residuals zero."""
    rng = np.random.default_rng(11)
    b = rng.normal(size=(2, 6, 4)).astype(np.float32)
    a = rng.normal(size=(2, 4, 5)).astype(np.float32)
    if case == "nan":
        b[0, 2, 1] = np.nan
    elif case == "inf":
        b[0, 4, 2] = np.inf
    elif case == "zero":
        b[0, :, 1:] = 0.0
        a[0, 1:] = 0.0
    elif case == "tie":
        b[0, :, 2], a[0, 2] = b[0, :, 0], a[0, 0]
        b[0, :, 3] *= 4.0
    return b, a, np.zeros_like(b), np.zeros_like(a)


def _bits(x: np.ndarray) -> np.ndarray:
    """f64 values as their bit patterns (signed zeros apart), every NaN as
    one: torch's vectorized bf16 cast writes a NaN as 0xFFFF where XLA's
    writes 0x7FC0, a sign and payload that no arithmetic reads."""
    x = np.asarray(x, np.float64)
    return np.ascontiguousarray(np.where(np.isnan(x), np.nan, x)).view(
        np.int64)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("case", ["nan", "inf", "zero", "tie"])
def test_topk_special_columns_bit_equal(case, mode):
    """Top-2 of 4 rank columns with a NaN column, an inf column, fewer
    than k nonzero columns and a tie at the k-th energy: the keep-mask
    and ``_encode_pair``'s payload, scales and residuals bit for bit
    (NaNs by their bits too). The k-th largest is taken with a NaN
    sorted last, as the reference's ascending sort of -energy does."""
    b, a, eb, ea = _special_inputs(case)
    tb, ta = torch.from_numpy(b), torch.from_numpy(a)
    mask = ttx._topk_mask(tb, ta, 2).numpy()
    np.testing.assert_array_equal(
        mask, np.asarray(jtx._topk_mask(jnp.asarray(b), jnp.asarray(a), 2)))
    assert mask[1].sum() == 2
    j = jtx._encode_pair(jnp.asarray(b), jnp.asarray(a), eb, ea,
                         mode=mode, top_k=2)
    t = ttx._encode_pair(tb, ta, *(torch.from_numpy(x) for x in (eb, ea)),
                         mode=mode, top_k=2)
    (ja, jd), (tt, td) = _flat(j), _flat(t)
    assert td == jd
    for x, y in zip(tt, ja):
        np.testing.assert_array_equal(_bits(x), _bits(y))
    if case == "nan":                   # the NaN reached B's residual
        assert np.isnan(tt[4]).any()


@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_quantize_int8_non_finite_column(value):
    """An int8 ``_quantize`` of a (6, 4) factor whose column 1 holds one
    non-finite entry, along both axes (B's and A's): payload and scales
    bit-equal to the reference's compiled program (as ``_encode_pair``
    runs it) on the CPU."""
    x = np.random.default_rng(5).normal(size=(6, 4)).astype(np.float32)
    x[3, 1] = value
    quantize = jax.jit(jtx._quantize, static_argnums=(1, 2))
    for axis in (-2, -1):
        jq = quantize(jnp.asarray(x), axis, "int8")
        tq = ttx._quantize(torch.from_numpy(x), axis, "int8")
        np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
        np.testing.assert_array_equal(_bits(tq.scale.numpy()),
                                      _bits(np.asarray(jq.scale)))


def test_half_to_even_ties_match_jax():
    """Payloads that sit exactly on .5 of the grid round half to even in
    both packages (127 sets the scale to exactly 1)."""
    col = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5],
                   np.float32)
    b = col[:, None]
    a = np.ones((1, 4), np.float32)
    zb, za = np.zeros_like(b), np.zeros_like(a)
    j = jtx._encode_pair(jnp.asarray(b), jnp.asarray(a), zb, za,
                         mode="int8", top_k=None)
    t = ttx._encode_pair(*(torch.from_numpy(x) for x in (b, a, zb, za)),
                         mode="int8", top_k=None)
    want = [127, 0, 2, 2, 0, -2, 4, -126]
    assert np.asarray(j[0].q).ravel().tolist() == want
    assert t[0].q.numpy().ravel().tolist() == want
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))


def test_zero_columns_scale_exactly_zero():
    b, a, eb, ea = _inputs(3, zero_cols=3)
    eb[..., -3:] = 0.0
    ea[..., -3:, :] = 0.0
    qb, qa, _, _ = ttx._encode_pair(
        *(torch.from_numpy(x) for x in (b, a, eb, ea)), mode="int8",
        top_k=None)
    assert (qb.scale[..., -3:] == 0).all() and (qa.scale[..., -3:, :] == 0
                                                ).all()
    assert (ttx.dequantize(qb)[..., -3:] == 0).all()
    assert (ttx.dequantize(qa)[..., -3:, :] == 0).all()


def _state_equal(t_state, j_state):
    assert list(t_state) == list(j_state)
    for k, v in j_state.items():
        assert t_state[k].dtype == np.float32
        np.testing.assert_array_equal(t_state[k], v)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_update_transport_matches_jax(mode):
    """Two rounds of ``encode_group`` (a ghost at -1, a client coming
    back) and one ``encode_client``: every payload and the accumulator
    state (``state_arrays``, the checkpointed form) bit for bit; the
    state round-trips through ``load_state_arrays`` and ``reset``."""
    cfg_j, cfg_t = jtx.TransportConfig(mode=mode), ttx.TransportConfig(
        mode=mode)
    jt, tt = jtx.UpdateTransport(cfg_j), ttx.UpdateTransport(cfg_t)
    parents = [("layers", "attn", "q"), ("layers", "mlp", "up")]
    for rnd, ids in enumerate(([5, -1, 9], [9, 2, 5])):
        factors = {p: _inputs(10 * rnd + i)[:2] for i, p in
                   enumerate(parents)}
        jo = jt.encode_group(ids, {p: tuple(jnp.asarray(x) for x in ba)
                                   for p, ba in factors.items()})
        to = tt.encode_group(ids, {p: tuple(torch.from_numpy(x) for x in ba)
                                   for p, ba in factors.items()})
        for p in parents:
            for jq, tq in zip(jo[p], to[p]):
                np.testing.assert_array_equal(
                    tq.q.double().numpy(), np.asarray(jq.q).astype(float))
                np.testing.assert_array_equal(tq.scale.numpy(),
                                              np.asarray(jq.scale))
    b, a, _, _ = _inputs(99, lead=(2,))
    jo = jt.encode_client(2, {parents[0]: (jnp.asarray(b[..., :4]),
                                           jnp.asarray(a[..., :4, :]))})
    to = tt.encode_client(2, {parents[0]: (torch.from_numpy(b[..., :4]),
                                           torch.from_numpy(a[..., :4, :]))})
    np.testing.assert_array_equal(to[parents[0]][0].q.double().numpy(),
                                  np.asarray(jo[parents[0]][0].q))
    state = jt.state_arrays()
    assert "c2/layers/attn/q/b" in state and not any(
        k.startswith("c-1") for k in state)
    _state_equal(tt.state_arrays(), state)
    fresh = ttx.UpdateTransport(cfg_t)
    fresh.load_state_arrays(state)
    _state_equal(fresh.state_arrays(), state)
    fresh.reset()
    assert not fresh.has_state()
    for d, n, r in ((64, 64, 8), (768, 3072, 32)):
        assert tt.payload_bytes(d, n, r) == jt.payload_bytes(d, n, r)


def test_residuals_telescope():
    """sum_t deq(q_t) + e_K == sum_t x_t (error feedback, port alone)."""
    rng = np.random.default_rng(4)
    eb, ea = torch.zeros(16, 8), torch.zeros(8, 12)
    sum_x, sum_q = torch.zeros(16, 8), torch.zeros(16, 8)
    for _ in range(5):
        b = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
        a = torch.from_numpy(rng.normal(size=(8, 12)).astype(np.float32))
        qb, _, eb, ea = ttx._encode_pair(b, a, eb, ea, mode="int8",
                                         top_k=None)
        sum_x += b
        sum_q += ttx.dequantize(qb)
    np.testing.assert_allclose((sum_q + eb).numpy(), sum_x.numpy(),
                               rtol=1e-5, atol=1e-5)


def _quantized_groups(seed, mode):
    """Two rank groups of two adapters (two layers) encoded once by the
    JAX transport: the same QuantFactor stacks for both packages."""
    rng = np.random.default_rng(seed)
    groups = [[4, 16], [8]]
    jt = jtx.UpdateTransport(jtx.TransportConfig(mode=mode))
    g_bs, g_as = [], []
    for gi, ranks in enumerate(groups):
        bt, at = [], []
        for p in range(2):
            b = rng.normal(size=(len(ranks), 2, 20, 16)).astype(np.float32)
            a = rng.normal(size=(len(ranks), 2, 16, 28)).astype(np.float32)
            for j, r in enumerate(ranks):
                b[j, ..., r:] = 0.0
                a[j, ..., r:, :] = 0.0
            qb, qa = jt.encode_group(
                list(range(len(ranks))),
                {("p", str(p)): (jnp.asarray(b), jnp.asarray(a))})[
                ("p", str(p))]
            bt.append(qb)
            at.append(qa)
        g_bs.append(bt)
        g_as.append(at)
    gb = [rng.normal(size=(2, 20, 16)).astype(np.float32) for _ in range(2)]
    ga = [rng.normal(size=(2, 16, 28)).astype(np.float32) for _ in range(2)]
    return g_bs, g_as, gb, ga, [r for g in groups for r in g]


def _to_torch(qf):
    q = np.asarray(qf.q)
    qt = (torch.from_numpy(q.view(np.int16).copy()).view(torch.bfloat16)
          if q.dtype.name == "bfloat16" else torch.from_numpy(q.copy()))
    return ttx.QuantFactor(qt, torch.from_numpy(np.asarray(qf.scale).copy()))


@pytest.mark.parametrize("backend", ["kernel", "factored"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_aggregate_matches_jax(mode, backend):
    """Identical QuantFactor stacks through both packages'
    ``aggregate_grouped`` (raFLoRA, staleness-discounted, one client
    absent): the kernel path's tolerances."""
    g_bs, g_as, gb, ga, ranks = _quantized_groups(7, mode)
    n_k = [30, 50, 40]
    kw = dict(staleness=[1, 0, 2], gamma=0.8, present=[True, False, True])
    jr = jagg.Aggregator("raflora", LEVELS, backend=backend
                         ).aggregate_grouped(
        g_bs, g_as, ranks, n_k, global_bs=[jnp.asarray(x) for x in gb],
        global_as=[jnp.asarray(x) for x in ga], **kw)
    tr = tagg.Aggregator("raflora", LEVELS, backend=backend
                         ).aggregate_grouped(
        [[_to_torch(x) for x in bt] for bt in g_bs],
        [[_to_torch(x) for x in at] for at in g_as], ranks, n_k,
        global_bs=[torch.from_numpy(x) for x in gb],
        global_as=[torch.from_numpy(x) for x in ga], **kw)
    for p in range(2):
        for ll in range(2):
            j_s = np.asarray(jr.sigma[p, ll])
            scale = max(1.0, float(np.abs(j_s).max()))
            np.testing.assert_allclose(tr.sigma[p, ll].numpy(), j_s,
                                       atol=1e-3 * scale)
            np.testing.assert_allclose(
                (tr.b_g[p, ll] @ tr.a_g[p, ll]).numpy(),
                np.asarray(jr.b_g[p, ll]) @ np.asarray(jr.a_g[p, ll]),
                atol=2e-3 * scale)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_ops_dequant_entry_equals_dequantized(mode):
    """``ops.factored_stack_gram`` and ``..._layered`` on QuantFactor
    inputs give the outputs of the same call on ``dequantize``d tensors,
    bit for bit (one elementwise op before K1)."""
    b, a, _, _ = _inputs(5, lead=(3, 2), d=20, r=16, n=28, zero_cols=4)
    qb, qa, _, _ = ttx._encode_pair(torch.from_numpy(b), torch.from_numpy(a),
                                    torch.zeros(b.shape),
                                    torch.zeros(a.shape), mode=mode,
                                    top_k=None)
    omega = torch.rand(3, 16, generator=torch.Generator().manual_seed(0))
    lay = (ttx.QuantFactor(qb.q.movedim(0, 1), qb.scale.movedim(0, 1)),
           ttx.QuantFactor(qa.q.movedim(0, 1), qa.scale.movedim(0, 1)))
    one = (ttx.QuantFactor(qb.q[:, 0], qb.scale[:, 0]),
           ttx.QuantFactor(qa.q[:, 0], qa.scale[:, 0]))
    pairs = [(ops.factored_stack_gram_layered(*lay, omega),
              ops.factored_stack_gram_layered(
                  *(ttx.dequantize(x) for x in lay), omega)),
             (ops.factored_stack_gram(*one, omega),
              ops.factored_stack_gram(*(ttx.dequantize(x) for x in one),
                                      omega))]
    for got, want in pairs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
