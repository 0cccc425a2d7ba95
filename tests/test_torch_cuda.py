"""Card-only checks of the port's hand-written CUDA kernels (K1-K7), of
the round and of the serving engines (qwen2 with K4, mamba2 with K6) on
the card. They skip without CUDA (the kernels have no CPU mode)
and import nothing of JAX, so they run on a GPU machine without it:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_plan as gp
from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import ops
from repro_torch.kernels import rank_partition_agg as rpa
from repro_torch.kernels import ssd_scan as k6
from repro_torch.kernels import tf32x3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stacks(seed, layers, m, d, r, n, device):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(size=(m, r)).astype(np.float32)
    omega[0, r // 2:] = 0.0
    omega[-1, 0] = -0.5
    return tuple(torch.from_numpy(x).to(device) for x in (
        rng.normal(size=(layers, m, d, r)).astype(np.float32),
        rng.normal(size=(layers, m, r, n)).astype(np.float32), omega))


@pytest.mark.cuda
@pytest.mark.parametrize("layers,m,d,r,n", [
    (2, 3, 24, 8, 40), (1, 3, 300, 8, 520), (2, 2, 17, 12, 9),
    (3, 3, 130, 48, 70), (48, 6, 768, 32, 768), (2, 3, 24, 8, 42),
    (2, 3, 21, 6, 40)])
def test_cuda_kernels_match_plain(cuda_device, layers, m, d, r, n):
    """K1 bit-exact against its plain version (IEEE sqrtf and one
    multiply), on its 16-byte path (r or n a multiple of 4) and its 4-byte
    one (n 42, 9; r 6); K2 within depth * eps * max column norm^2 (the
    worst-case rounding of a length-depth f32 dot product), and exactly
    symmetric. R = m * r spans one to three 64-wide tiles, with ragged
    edges."""
    bs, as_, omega = _stacks(8, layers, m, d, r, n, cuda_device)
    before = [k.launches for k in rpa.KERNELS]
    u = rpa.weighted_stack_b(bs, omega)
    v = rpa.weighted_stack_a(as_, omega)
    torch.testing.assert_close(u, rpa.weighted_stack_b_plain(bs, omega),
                               rtol=0, atol=0)
    torch.testing.assert_close(v, rpa.weighted_stack_a_plain(as_, omega),
                               rtol=0, atol=0)
    eps = torch.finfo(torch.float32).eps
    for kern, plain, x, depth, axis in (
            (rpa.gram_left, rpa.gram_left_plain, u, d, 1),
            (rpa.gram_right, rpa.gram_right_plain, v, n, 2)):
        g = kern(x)
        tol = depth * eps * float((x * x).sum(dim=axis).max())
        assert float((g - plain(x)).abs().max()) <= tol
        assert torch.equal(g, g.mT)
    torch.cuda.synchronize()
    assert [k.launches for k in rpa.KERNELS] == [b + 1 for b in before]


@pytest.mark.cuda
def test_cuda_weighted_stacks_misaligned_match_plain(cuda_device):
    """K1 on inputs whose storage starts 4 bytes past a 16-byte boundary:
    the 4-byte path, bit-exact."""
    bs, as_, omega = _stacks(10, 3, 4, 40, 8, 48, cuda_device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda_device)[1:]
        return flat.view(t.shape).copy_(t)
    bs1, as1 = shifted(bs), shifted(as_)
    assert bs1.data_ptr() % 16 and as1.data_ptr() % 16
    torch.testing.assert_close(rpa.weighted_stack_b(bs1, omega),
                               rpa.weighted_stack_b_plain(bs, omega),
                               rtol=0, atol=0)
    torch.testing.assert_close(rpa.weighted_stack_a(as1, omega),
                               rpa.weighted_stack_a_plain(as_, omega),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_weighted_stacks_refuse_too_many_columns(cuda_device):
    """K1 keeps a block's M r weights in shared memory: beyond
    ``MAX_STACK_COLS`` columns the wrappers refuse, before any launch."""
    m, r = 1537, 8                       # M r = 12296
    assert m * r > rpa.MAX_STACK_COLS
    omega = torch.ones(m, r, device=cuda_device)
    before = [k.launches for k in rpa.KERNELS]
    with pytest.raises(ValueError, match="columns"):
        rpa.weighted_stack_b(torch.ones(1, m, 2, r, device=cuda_device), omega)
    with pytest.raises(ValueError, match="columns"):
        rpa.weighted_stack_a(torch.ones(1, m, r, 2, device=cuda_device), omega)
    assert [k.launches for k in rpa.KERNELS] == before


@pytest.mark.cuda
def test_cuda_wrapper_rejects_mixed_devices(cuda_device):
    bs, _, omega = _stacks(9, 1, 2, 8, 8, 8, cuda_device)
    with pytest.raises(ValueError, match="inputs on"):
        rpa.weighted_stack_b(bs, omega.cpu())


@pytest.mark.cuda
def test_cuda_round_matches_cpu_round(cuda_device):
    """One fedvit-tiny kernel-backend round on the card and on the CPU from
    the same weights: same clients, loss at rtol 1e-4, spectra and adapter
    products at the kernel path's 1e-3 / 2e-3 of sigma_max; every kernel
    launched once per shape bucket (3 buckets)."""
    from repro_torch.federation.experiment import build_experiment
    kw = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                            "participation": 0.5},
              lora_overrides={"rank_levels": (4, 8, 16),
                              "rank_probs": (0.34, 0.33, 0.33)},
              samples_per_class=30, num_classes=6, d_model=32,
              batches_per_round=1, backend="kernel")
    cpu = build_experiment("raflora", device="cpu", **kw)
    gpu = build_experiment("raflora", base_params=cpu.server.global_params(),
                           **kw)
    assert gpu.server.device.type == "cuda"      # device=None means cuda
    before = [k.launches for k in rpa.KERNELS]
    (sg,), (sc,) = gpu.server.run(1), cpu.server.run(1)
    assert [k.launches - b for k, b in zip(rpa.KERNELS, before)] == [3] * 4
    assert sg.clients == sc.clients
    np.testing.assert_allclose(sg.mean_client_loss, sc.mean_client_loss,
                               rtol=1e-4)
    scale = max(1.0, float(np.abs(sc.sigma_probe).max()))
    np.testing.assert_allclose(sg.sigma_probe, sc.sigma_probe,
                               atol=1e-3 * scale)
    fg = gpu.server._extract_factors(gpu.server.global_lora, 16)
    fc = cpu.server._extract_factors(cpu.server.global_lora, 16)
    for parent, (b, a) in fc.items():
        gb, ga = fg[parent]
        np.testing.assert_allclose((gb @ ga).cpu().numpy(), (b @ a).numpy(),
                                   atol=2e-3 * scale)


def _lora_case(seed, m, k, n, p, r, device, ranks=None):
    rng = np.random.default_rng(seed)
    ranks = ranks or [r] * p
    mask = (np.arange(r)[None, :] < np.asarray(ranks)[:, None])
    arrs = dict(
        x=rng.normal(size=(m, k)), w=rng.normal(size=(k, n)) * k ** -0.5,
        a_pages=rng.normal(size=(p, r, k)) * mask[:, :, None] * k ** -0.5,
        b_pages=rng.normal(size=(p, n, r)) * mask[:, None, :],
        scales=rng.uniform(0.5, 2.0, size=(p,)))
    case = {key: torch.from_numpy(v.astype(np.float32)).to(device)
            for key, v in arrs.items()}
    case["ids"] = torch.from_numpy(
        rng.integers(0, p, size=(m,)).astype(np.int32)).to(device)
    return case


def _lora_tol(case):
    """(K + r) * eps * max(|x| @ |W| + |s| (|x| @ |A|^T) @ |B|^T): the
    worst-case rounding of the f32 dot products, each side."""
    k, r = case["w"].shape[0], case["a_pages"].shape[1]
    mag = la.batched_lora_apply_plain(
        **{key: (v if key == "ids" else v.abs()) for key, v in case.items()})
    return (k + r) * torch.finfo(torch.float32).eps * float(mag.max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,p,r", [
    (4, 3584, 3584, 4, 16), (4, 3584, 512, 4, 16),      # decode q/o, k/v
    (128, 3584, 3584, 4, 16), (128, 3584, 512, 4, 16),  # prefill
    (35, 72, 56, 3, 16), (7, 37, 23, 2, 5), (70, 37, 23, 2, 5),  # odd
    (9, 300, 520, 9, 8),                                 # a page per row
    (4096, 3584, 3584, 4, 16), (4096, 3584, 512, 4, 16),  # unsplit SGEMM
    (33, 3584, 512, 4, 16), (64, 3584, 3584, 4, 16),     # route boundary
    (128, 3000, 512, 4, 16)])       # 16 splits of 192, the last 120 deep
def test_cuda_lora_apply_matches_plain(cuda_device, m, k, n, p, r):
    """K4 against its plain version at Qwen2-7B's decode (4 rows) and
    prefill (128 rows, split over K) shapes, at 4096 rows (unsplit), at the
    first SGEMM row counts (33, 64), at odd K / N / r on both launch paths,
    with a K that is no multiple of splits x slab, and with every row on a
    different page."""
    case = _lora_case(10, m, k, n, p, r, cuda_device,
                      ranks=[max(1, r - 2 * i) for i in range(p)])
    if m == p:
        case["ids"] = torch.arange(p, dtype=torch.int32,
                                   device=cuda_device)
    before = la.batched_lora_apply.launches
    got = la.batched_lora_apply(**case)
    want = la.batched_lora_apply_plain(**case)
    torch.cuda.synchronize()
    assert la.batched_lora_apply.launches == before + 1
    assert float((got - want).abs().max()) <= _lora_tol(case)
    # deterministic: no atomics, fixed reduction order
    assert torch.equal(got, la.batched_lora_apply(**case))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(6, 64), (40, 1024)])
def test_cuda_lora_apply_strided_pages_and_bad_ids(cuda_device, m, k):
    """Per-layer page slices t[:, li] are read in place; a row whose page
    id is out of range comes back NaN, the others unaffected. On the GEMV
    route (6 rows) and on the SGEMM's split route (40 rows: 8 splits)."""
    case = _lora_case(11, m, k, 40, 3, 8, cuda_device)
    stacked_a = torch.stack([case["a_pages"] * 0, case["a_pages"]], dim=1)
    stacked_b = torch.stack([case["b_pages"] * 0, case["b_pages"]], dim=1)
    got = la.batched_lora_apply(case["x"], case["w"], stacked_a[:, 1],
                                stacked_b[:, 1], case["scales"], case["ids"])
    torch.testing.assert_close(got, la.batched_lora_apply(**case),
                               rtol=0, atol=0)
    bad = case["ids"].clone()
    bad[2] = 7
    out = la.batched_lora_apply(**dict(case, ids=bad))
    assert torch.isnan(out[2]).all() and torch.isfinite(out[[0, 1, 3]]).all()


@pytest.mark.cuda
def test_cuda_serving_engine_matches_cpu(cuda_device):
    """A reduced qwen2-7b (GQA 4/2) engine on the card with
    ``use_kernels=True`` (K4 on every q/k/v/o projection) and the same
    engine on the CPU from the same weights: equal greedy tokens, 4 K4
    launches per layer per engine call."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              num_kv_heads=2)
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    cpu = Model(cfg, lora, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {}
    for name in ("hi", "lo"):
        flat = {path: 0.05 * torch.randn(t.shape, generator=gen)
                for path, t in flatten(params).items()
                if path[-1] in ("lora_a", "lora_b")}
        tenants[name] = unflatten(flat)
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    runs = []
    for dev, kern in (("cuda", True), ("cpu", False)):
        model = Model(cfg, lora, device=dev, use_kernels=kern)
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        store.put("hi", move(tenants["hi"]), 16)
        store.put("lo", move(tenants["lo"]), 4)
        store.publish()
        eng = ServingEngine(model, move(params), store, max_len=14, slots=2)
        before = la.batched_lora_apply.launches
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        for _ in range(4):
            toks.append(eng.decode([True, True]).cpu())
        grew = la.batched_lora_apply.launches - before
        assert grew == (4 * cfg.num_layers * 5 if kern else 0)
        runs.append(torch.stack(toks, dim=1))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


def _scan_case(seed, bsz, length, nheads, hp, groups, n, device, init):
    """K6 inputs: the reference test's distributions, with a slow decay
    (dt about 0.02, A about -0.4) so the carried state still matters a
    chunk later, and an optional nonzero initial state."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(bsz, length, nheads, hp)),
            np.log1p(np.exp(rng.normal(size=(bsz, length, nheads)) - 4)),
            0.5 * rng.normal(size=(nheads,)) - 1.0,
            0.3 * rng.normal(size=(bsz, length, groups, n)),
            0.3 * rng.normal(size=(bsz, length, groups, n)),
            rng.normal(size=(nheads,))]
    arrs = [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]
    init_state = (torch.from_numpy(rng.normal(size=(bsz, nheads, hp, n))
                                   .astype(np.float32)).to(device)
                  if init else None)
    return arrs, init_state


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,length,nheads,hp,groups,n,chunk,init", [
    (2, 96, 12, 24, 3, 20, 32, False),      # odd: P 24, N 20, 3 groups
    (2, 96, 12, 24, 3, 20, 32, True),
    (1, 512, 8, 64, 1, 128, 256, True),     # mamba2 widths, 2 chunks
    (2, 200, 4, 50, 2, 16, 40, True),       # hymba's P 50, ragged tiles
    (1, 64, 2, 128, 1, 16, 64, False),      # P 128: two P slices
    (4, 1024, 64, 64, 1, 128, 256, False),  # mamba2-1.3b's prefill layer
    (2, 512, 8, 64, 2, 64, 128, True),      # 2 groups of 4 heads share C B^T
    (1, 24, 4, 8, 2, 16, 24, True)])        # nc 1, Q 24: ragged token tiles
def test_cuda_ssd_scan_matches_plain(cuda_device, bsz, length, nheads, hp,
                                     groups, n, chunk, init):
    """K6 against its plain version within the reference's atol 2e-4,
    rtol 1e-3, for y and the final state; two launches bit-equal; one
    wrapper call counted, whatever its CUDA launches."""
    arrs, init_state = _scan_case(12, bsz, length, nheads, hp, groups, n,
                                  cuda_device, init)
    before = k6.ssd_scan.launches
    y, s = k6.ssd_scan(*arrs, chunk, init_state=init_state)
    want_y, want_s = k6.ssd_scan_plain(*arrs, chunk, init_state=init_state)
    torch.cuda.synchronize()
    assert k6.ssd_scan.launches == before + 1
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(s, want_s, atol=2e-4, rtol=1e-3)
    y2, s2 = k6.ssd_scan(*arrs, chunk, init_state=init_state)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,length,nheads,hp,groups,n,chunk", [
    (2, 1024, 16, 64, 1, 128, 256), (2, 96, 12, 24, 3, 20, 32)])
def test_cuda_ssd_scan_tensor_cores_beat_one_pass_tf32(
        cuda_device, bsz, length, nheads, hp, groups, n, chunk):
    """K6's 3xTF32 route has f32's precision, not TF32's: against a float64
    run its y stays, at every output, within ``ssd_scan.one_pass_bound`` (a
    one-pass TF32 run's error sigma there, plus f32's rounding bound), and
    the same decomposition with every product in one TF32 pass at its most
    accurate (TF32 operands summed in f64) leaves it."""
    arrs, _ = _scan_case(14, bsz, length, nheads, hp, groups, n,
                         cuda_device, False)
    want = k6.ssd_scan_f64(*arrs, chunk)[0]
    bound = k6.one_pass_bound(*arrs, chunk)
    y, _ = k6.ssd_scan(*arrs, chunk)
    one_pass = k6.ssd_scan_one_pass_tf32(*arrs, chunk)[0]
    assert float(((y.double() - want).abs() / bound).max()) <= 1
    assert float(((one_pass - want).abs() / bound).max()) > 1


@pytest.mark.cuda
def test_cuda_ssd_scan_rejects_ragged_length(cuda_device):
    arrs, _ = _scan_case(13, 1, 48, 4, 8, 1, 16, cuda_device, False)
    before = k6.ssd_scan.launches
    with pytest.raises(ValueError, match="multiple"):
        k6.ssd_scan(*arrs, 32)
    assert k6.ssd_scan.launches == before


@pytest.mark.cuda
def test_cuda_mamba2_engine_matches_cpu(cuda_device):
    """A reduced mamba2 engine on the card with ``use_kernels=True`` (K6
    on every prefill scan) and on the CPU from the same weights: equal
    greedy tokens, ``num_layers`` K6 launches per admit and none per
    decode step."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = get_config("mamba2-1.3b").reduced()
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {name: unflatten({
        path: 0.05 * torch.randn(t.shape, generator=gen)
        for path, t in flatten(params).items()
        if path[-1] in ("lora_a", "lora_b")}) for name in ("hi", "lo")}
    prompts = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    runs = []
    for dev, kern in (("cuda", True), ("cpu", False)):
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        store.put("hi", move(tenants["hi"]), 16)
        store.put("lo", move(tenants["lo"]), 4)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            move(params), store, max_len=70, slots=2)
        before = k6.ssd_scan.launches
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        assert k6.ssd_scan.launches - before == (cfg.num_layers if kern
                                                 else 0)
        for _ in range(4):
            before = k6.ssd_scan.launches
            toks.append(eng.decode([True, True]).cpu())
            assert k6.ssd_scan.launches == before
        runs.append(torch.stack(toks, dim=1))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("layers,m,d,r,n", [
    (1, 3, 24, 8, 40), (2, 3, 300, 8, 520), (3, 2, 17, 16, 9),
    (2, 6, 130, 32, 70), (48, 6, 768, 32, 768)])
def test_cuda_rank_partition_agg_matches_plain(cuda_device, layers, m, d, r,
                                               n):
    """K3, both entries, against its plain einsum within M r eps
    max(|B| |omega| |A|) (the worst-case rounding of the M r-deep f32
    sum), with a negative weight (applied as given); ragged d / n tiles;
    two launches bit-equal."""
    bs, as_, omega = _stacks(14, layers, m, d, r, n, cuda_device)
    mag = rpa.rank_partition_agg_layered_plain(bs.abs(), as_.abs(),
                                               omega.abs())
    tol = m * r * torch.finfo(torch.float32).eps * float(mag.max())
    before = [k.launches for k in rpa.DENSE_KERNELS]
    got = rpa.rank_partition_agg_layered(bs, as_, omega)
    one = rpa.rank_partition_agg(bs[-1].contiguous(), as_[-1].contiguous(),
                                 omega)
    want = rpa.rank_partition_agg_layered_plain(bs, as_, omega)
    torch.cuda.synchronize()
    assert [k.launches for k in rpa.DENSE_KERNELS] == [b + 1 for b in before]
    assert float((got - want).abs().max()) <= tol
    # the single-layer entry is the same kernel at one layer
    assert torch.equal(one, got[-1])
    assert torch.equal(got, rpa.rank_partition_agg_layered(bs, as_, omega))


@pytest.mark.cuda
@pytest.mark.parametrize("layers,depth,rr,offset", [
    (12, 3072, 192, 0),     # the round's up/down buckets: 11 splits of 288
    (12, 768, 192, 0),      # and their other side: 5 splits of 160
    (2, 1001, 200, 0),      # ragged R and depth (right side: 4-byte path)
    (3, 700, 72, 1)])       # a base one float off 16 bytes: 4-byte path
def test_cuda_gram_split_matches_plain(cuda_device, layers, depth, rr,
                                       offset):
    """K2 where the planner splits the depth (the last block of each tile
    sums the partials in split order) and at ragged and unaligned inputs:
    within depth eps max column norm^2 of the plain version, exactly
    symmetric, and two launches bit-equal."""
    rng = np.random.default_rng(depth + rr)
    eps = torch.finfo(torch.float32).eps
    if offset == 0 and rr == 192:
        assert gp.plan_gram(layers, rr, depth).splits > 1
    for kern, plain, shape, axis in (
            (rpa.gram_left, rpa.gram_left_plain, (layers, depth, rr), 1),
            (rpa.gram_right, rpa.gram_right_plain, (layers, rr, depth), 2)):
        x = rng.normal(size=shape).astype(np.float32)
        buf = torch.empty(x.size + offset, device=cuda_device)
        xt = buf[offset:].view(shape)
        xt.copy_(torch.from_numpy(x))
        g = kern(xt)
        tol = depth * eps * float((xt * xt).sum(dim=axis).max())
        assert float((g - plain(xt)).abs().max()) <= tol
        assert torch.equal(g, g.mT)
        assert torch.equal(g, kern(xt))


def _agg_zero_slabs(seed, layers, m, d, r, n, device):
    """K3 inputs whose weights leave whole 16-deep slabs at zero: client 1
    negative, clients 2 and 3 zero, the last client zero above r / 2."""
    bs, as_, omega = _stacks(seed, layers, m, d, r, n, device)
    omega[1] = -omega[1]
    omega[2:4] = 0.0
    omega[-1, r // 2:] = 0.0
    return bs, as_, omega


@pytest.mark.cuda
@pytest.mark.parametrize("layers,m,d,r,n", [
    (1, 10, 768, 64, 768),    # bench_kernels' shape: 5 splits of 128
    (2, 40, 64, 8, 96),       # r 8, two clients a slab, 2 splits
    (1, 12, 300, 24, 520),    # d 300 / n 520, slabs across clients
    (2, 8, 130, 12, 70)])     # r 12: the 4-byte path
def test_cuda_rank_partition_agg_split_and_skip(cuda_device, layers, m, d,
                                                r, n):
    """K3 with its all-zero-weight slabs skipped and, where the planner
    splits the depth, the partials summed in split order: within (M r + 2)
    eps max(|B| |omega| |A|) of the plain einsum on finite inputs, two
    launches bit-equal, the single-layer entry equal to the layered kernel
    at one layer."""
    bs, as_, omega = _agg_zero_slabs(20, layers, m, d, r, n, cuda_device)
    assert not bool(rpa.live_slabs(omega).all())
    mag = rpa.rank_partition_agg_layered_plain(bs.abs(), as_.abs(),
                                               omega.abs())
    tol = (m * r + 2) * torch.finfo(torch.float32).eps * float(mag.max())
    got = rpa.rank_partition_agg_layered(bs, as_, omega)
    want = rpa.rank_partition_agg_layered_plain(bs, as_, omega)
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, rpa.rank_partition_agg_layered(bs, as_, omega))
    one = rpa.rank_partition_agg(bs[0].contiguous(), as_[0].contiguous(),
                                 omega)
    assert torch.equal(one, rpa.rank_partition_agg_layered(
        bs[:1].contiguous(), as_[:1].contiguous(), omega)[0])


@pytest.mark.cuda
def test_cuda_rank_partition_agg_skipped_slab_hides_non_finite(cuda_device):
    """The deliberate divergence of ROADMAP.md queue 3: inf or NaN in B or
    A at a zero-weight column of a slab whose 16 weights are all zero. The
    plain einsum (like the reference) gives NaN; the kernel never reads
    that slab and equals the plain version of the inputs with those
    entries zeroed."""
    bs, as_, omega = _agg_zero_slabs(21, 1, 4, 40, 8, 24, cuda_device)
    assert rpa.live_slabs(omega).tolist() == [True, False]
    clean_b, clean_a = bs.clone(), as_.clone()
    bs[0, 2, 5, 3] = float("inf")
    as_[0, 3, 1, 7] = float("nan")
    got = rpa.rank_partition_agg_layered(bs, as_, omega)
    assert bool(torch.isnan(rpa.rank_partition_agg_layered_plain(
        bs, as_, omega)).any())
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(
        got, rpa.rank_partition_agg_layered_plain(clean_b, clean_a, omega),
        atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_ops_rank_partition_agg_fallback_and_k1(cuda_device):
    """``ops`` with the Eq. 8 fallback (one more client, r 12 padded to
    16) on the card equals the CPU path; with omega >= 0 it equals K1's
    U_c V_c up to the rounding of sqrt(omega)^2."""
    rng = np.random.default_rng(15)
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in dict(
        bs=rng.normal(size=(2, 3, 100, 12)), as_=rng.normal(size=(2, 3, 12, 90)),
        omega=rng.uniform(size=(3, 12)), global_b=rng.normal(size=(2, 100, 12)),
        global_a=rng.normal(size=(2, 12, 90)),
        fallback=(np.arange(12) >= 8).astype(float)).items()}
    got = ops.rank_partition_agg_layered(
        **{k: v.to(cuda_device) for k, v in t.items()})
    want = ops.rank_partition_agg_layered(**t)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    u, v = ops.factored_stack_layered(*(
        ops._append_fallback_client(
            *(t[k].to(cuda_device) for k in ("bs", "as_", "omega",
                                             "global_b", "global_a",
                                             "fallback")), layer_axes=1)))
    torch.testing.assert_close(u @ v, got, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,r,n", [(3, 300, 12, 520), (5, 768, 32, 3072)],
                         ids=["odd", "vit-base-slice"])
def test_cuda_ops_factored_stack_gram_single_adapter(cuda_device, m, d, r, n):
    """``ops.factored_stack_gram``, one adapter (K1/K2 at L = 1), with the
    Eq. 8 fallback client, against its plain version (the same entry on
    CPU tensors): U_c and V_c bit-exact, the Gram cores within depth * eps
    * the largest column norm^2 and exactly symmetric; one launch of each
    kernel; bit-equal to the layered entry at L = 1 on the same slice."""
    rng = np.random.default_rng(m + d)
    omega = rng.uniform(size=(m, r))
    omega[0, r // 2:] = 0.0
    args = [x.astype(np.float32) for x in (
        rng.normal(size=(m, d, r)), rng.normal(size=(m, r, n)), omega,
        rng.normal(size=(d, r)), rng.normal(size=(r, n)),
        (np.arange(r) >= r // 2).astype(float))]
    card = [torch.from_numpy(x).to(cuda_device) for x in args]
    before = [k.launches for k in rpa.KERNELS]
    got = ops.factored_stack_gram(*card)
    torch.cuda.synchronize()
    assert [k.launches for k in rpa.KERNELS] == [b + 1 for b in before]
    want = ops.factored_stack_gram(*(torch.from_numpy(x) for x in args))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=0)
    eps = torch.finfo(torch.float32).eps
    for g, w, x, depth, axis in ((got[2], want[2], want[0], d, 0),
                                 (got[3], want[3], want[1], n, 1)):
        tol = depth * eps * float((x * x).sum(dim=axis).max())
        assert float((g.cpu() - w).abs().max()) <= tol
        assert torch.equal(g, g.mT)
    lay = ops.factored_stack_gram_layered(
        card[0][None], card[1][None], card[2], card[3][None], card[4][None],
        card[5])
    for one, layered in zip(got, lay):
        assert torch.equal(one, layered[0])


@pytest.mark.cuda
@pytest.mark.parametrize("method,kw", [
    ("fedavg", {"lora_overrides": {"rank_levels": (8,),
                                   "rank_probs": (1.0,)}}),
    ("hetlora", {}), ("flora", {}), ("ffa", {}), ("flexlora", {}),
    ("raflora", {"backend": "dense"}), ("raflora", {"backend": "factored"}),
    ("raflora", {"partial_up_to": 8}),
    ("raflora", {"round_engine": "sequential"}),
    ("flora", {"round_engine": "sequential"})],
    ids=["fedavg", "hetlora", "flora", "ffa", "flexlora", "raflora-dense",
         "raflora-factored", "raflora-partial8", "raflora-sequential",
         "flora-sequential"])
def test_cuda_round_methods_match_cpu(cuda_device, method, kw):
    """One fedvit-tiny round of every method, backend and engine on the
    card and on the CPU from the same weights, with the kernel path's
    round tolerances: loss rtol 1e-4, spectra 1e-3 and products 2e-3 of
    sigma_max (1e-4 of the largest product without a spectrum), base
    weights rtol 1e-4, atol 1e-5."""
    from repro_torch.core.lora import flatten
    from repro_torch.federation.experiment import build_experiment
    args = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                              "participation": 0.5},
                lora_overrides={"rank_levels": (4, 8, 16),
                                "rank_probs": (0.34, 0.33, 0.33)},
                samples_per_class=30, num_classes=6, d_model=32,
                batches_per_round=1, backend="kernel")
    args.update(kw)
    cpu = build_experiment(method, device="cpu", **args)
    gpu = build_experiment(method, base_params=cpu.server.global_params(),
                           **args)
    (sg,), (sc,) = gpu.server.run(1), cpu.server.run(1)
    assert sg.clients == sc.clients and sg.ranks == sc.ranks
    np.testing.assert_allclose(sg.mean_client_loss, sc.mean_client_loss,
                               rtol=1e-4)
    scale = None
    if sc.sigma_probe is not None:
        scale = max(1.0, float(np.abs(sc.sigma_probe).max()))
        np.testing.assert_allclose(sg.sigma_probe, sc.sigma_probe,
                                   atol=1e-3 * scale)
    r_max = cpu.server.lora_cfg.r_max
    fg = gpu.server._extract_factors(gpu.server.global_lora, r_max)
    fc = cpu.server._extract_factors(cpu.server.global_lora, r_max)
    for parent, (b, a) in fc.items():
        want = (b @ a).numpy()
        tol = (2e-3 * scale if scale is not None
               else 1e-4 * max(1.0, float(np.abs(want).max())))
        gb, ga = fg[parent]
        np.testing.assert_allclose((gb @ ga).cpu().numpy(), want, atol=tol)
    base_c = flatten(cpu.server.base)
    for path, x in flatten(gpu.server.base).items():
        np.testing.assert_allclose(x.cpu().numpy(), base_c[path].numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,r", [
    (4, 3584, 512, 16), (128, 3584, 512, 16),        # Qwen2-7B's k proj
    (300, 130, 520, 12), (7, 37, 23, 5), (64, 64, 64, 64), (5, 40, 24, 0),
    (4096, 3584, 512, 16)])                          # k at 4096 rows
def test_cuda_lora_apply_single_matches_plain(cuda_device, m, k, n, r):
    """K5 against its plain version on both launch paths (GEMV for at most
    32 rows, 3xTF32 on the tensor cores above), at odd shapes and at r = 0,
    within (K + r) eps max(|x| |W| + |s| |x| |A|^T |B|^T); two launches
    bit-equal."""
    rng = np.random.default_rng(16)
    x, w, a, b = (torch.from_numpy(v.astype(np.float32)).to(cuda_device)
                  for v in (rng.normal(size=(m, k)),
                            rng.normal(size=(k, n)) * k ** -0.5,
                            rng.normal(size=(r, k)) * k ** -0.5,
                            rng.normal(size=(n, r))))
    mag = la.lora_apply_plain(x.abs(), w.abs(), a.abs(), b.abs(), 0.75)
    tol = (k + r) * torch.finfo(torch.float32).eps * float(mag.max())
    before = la.lora_apply.launches
    got = la.lora_apply(x, w, a, b, -0.75)
    want = la.lora_apply_plain(x, w, a, b, -0.75)
    torch.cuda.synchronize()
    assert la.lora_apply.launches == before + 1
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got, la.lora_apply(x, w, a, b, -0.75))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4096, 512), (128, 3584), (64, 512)])
def test_cuda_lora_apply_tensor_cores_beat_one_pass_tf32(cuda_device, m, n):
    """K5's tensor-core route at Qwen2-7B's depth (K 3584) has f32's
    precision, not TF32's: against the product in f64 its error stays
    within one standard deviation of a one-pass TF32 product's error
    (``tf32x3.one_pass_sigma``), and the most accurate one-pass TF32
    product on the same card (TF32 operands summed in f64) exceeds it."""
    k, r = 3584, 16
    rng = np.random.default_rng(22)
    x, w, a, b = (torch.from_numpy(v.astype(np.float32)).to(cuda_device)
                  for v in (rng.normal(size=(m, k)),
                            rng.normal(size=(k, n)) * k ** -0.5,
                            rng.normal(size=(r, k)) * k ** -0.5,
                            rng.normal(size=(n, r)) * 0.1))
    lora = 2.0 * ((x.double() @ a.double().T) @ b.double().T)
    exact = x.double() @ w.double() + lora
    tol = tf32x3.one_pass_sigma(x, w)
    got = la.lora_apply(x, w, a, b, 2.0)
    one_pass = tf32x3.one_pass_matmul(x, w) + lora
    assert float((got.double() - exact).abs().max()) <= tol
    assert float((one_pass - exact).abs().max()) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("m", [20, 64])
def test_cuda_lora_apply_infinite_x_gives_nan_on_the_tensor_cores(
        cuda_device, m):
    """The deliberate divergence of the 3xTF32 route: one infinite x turns
    its row into NaN above 32 rows (its TF32 lo part is inf - inf), where
    the plain version, like the GEMV at most 32 rows, gives +-inf; the
    other rows stay within the tolerance."""
    rng = np.random.default_rng(23)
    x, w = (torch.from_numpy(v.astype(np.float32)).to(cuda_device)
            for v in (rng.normal(size=(m, 300)),
                      rng.normal(size=(300, 40)) * 300 ** -0.5))
    a, b = x.new_zeros(0, 300), x.new_zeros(40, 0)
    x[5, 7] = float("inf")
    got = la.lora_apply(x, w, a, b, 1.0)
    want = la.lora_apply_plain(x, w, a, b, 1.0)
    assert bool(torch.isinf(want[5]).all())
    if m > la.GEMV_MAX_ROWS:
        assert bool(torch.isnan(got[5]).all())
    else:
        assert torch.equal(got[5], want[5])
    keep = torch.arange(m, device=cuda_device) != 5
    mag = la.lora_apply_plain(x[keep].abs(), w.abs(), a, b, 1.0)
    tol = 300 * torch.finfo(torch.float32).eps * float(mag.max())
    assert float((got[keep] - want[keep]).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_ops_lora_apply_split(cuda_device):
    """K5 through ``ops`` at Qwen2-7B's k projection for 2 x 64 rows (the
    tensor-core product split 28 ways over K), r 12 padded to 16 by
    ``ops``: within (K + r) eps max of the plain version, one launch,
    repeat bit-equal."""
    rng = np.random.default_rng(19)
    x, w, a, b = (torch.from_numpy(v.astype(np.float32)).to(cuda_device)
                  for v in (rng.normal(size=(2, 64, 3584)),
                            rng.normal(size=(3584, 512)) * 3584 ** -0.5,
                            rng.normal(size=(12, 3584)) * 3584 ** -0.5,
                            rng.normal(size=(512, 12))))
    assert la.plan_gemm_tc(128, 512, 3584).splits == 28
    assert la.describe_plan(128, 512, 3584, tensor_cores=True)["route"] == \
        "mma_tf32x3"
    mag = la.lora_apply_plain(x.abs().reshape(128, -1), w.abs(), a.abs(),
                              b.abs(), 1.5)
    tol = (3584 + 16) * torch.finfo(torch.float32).eps * float(mag.max())
    before = la.lora_apply.launches
    got = ops.lora_apply(x, w, a, b, 1.5)
    want = la.lora_apply_plain(x.reshape(128, -1), w, a, b, 1.5)
    torch.cuda.synchronize()
    assert la.lora_apply.launches == before + 1
    assert got.shape == (2, 64, 512)
    assert float((got.reshape(128, -1) - want).abs().max()) <= tol
    assert torch.equal(got, ops.lora_apply(x, w, a, b, 1.5))


@pytest.mark.cuda
def test_cuda_ops_lora_apply_bf16(cuda_device):
    """bf16 in, read as f32, bf16 out: the CPU path's rounding within one
    bf16 step (3e-2, the reference test's bf16 tolerance)."""
    rng = np.random.default_rng(17)
    args = [torch.from_numpy(v.astype(np.float32)).bfloat16() for v in (
        rng.normal(size=(3, 17, 100)), rng.normal(size=(100, 72)) * 0.1,
        rng.normal(size=(12, 100)) * 0.1, rng.normal(size=(72, 12)) * 0.1)]
    got = ops.lora_apply(*(t.to(cuda_device) for t in args), 0.7)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 17, 72)
    torch.testing.assert_close(got.cpu().float(),
                               ops.lora_apply(*args, 0.7).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lq,lkv,h,kvh,d,causal,window", [
    (2, 48, 48, 4, 2, 16, True, 0), (2, 64, 64, 6, 6, 16, False, 0),
    (1, 200, 200, 4, 2, 16, False, 0),     # the reference ops' fault case
    (2, 33, 33, 4, 4, 16, True, 0), (1, 40, 40, 4, 2, 16, True, 4),
    (1, 130, 130, 4, 2, 32, True, 40), (1, 300, 300, 5, 5, 64, False, 64),
    (2, 197, 197, 3, 3, 64, False, 0), (1, 100, 100, 2, 2, 80, True, 0),
    (1, 129, 129, 2, 1, 128, True, 0), (1, 70, 70, 3, 1, 192, True, 0),
    (1, 150, 150, 2, 1, 256, True, 0), (1, 65, 65, 2, 2, 256, False, 16),
    (2, 40, 100, 4, 2, 16, True, 0), (2, 100, 40, 4, 2, 16, True, 0),
    (2, 50, 20, 4, 2, 16, False, 4),        # rows that see no key
    (2, 1, 1, 4, 2, 64, True, 0), (1, 17, 17, 3, 1, 128, True, 0),  # q tiles
    (1, 90, 90, 4, 2, 12, True, 0), (1, 90, 70, 2, 2, 36, False, 8),  # D % 8
    (2, 33, 33, 2, 1, 18, True, 0)])        # D % 4: 4-byte copies
def test_cuda_flash_attention_matches_plain(cuda_device, b, lq, lkv, h, kvh,
                                            d, causal, window):
    """K7 against its plain version at the reference test's tolerance (atol
    2e-5, rtol 1e-4) for every head dim the configs use (64, 80, 128,
    192, 256) and the tests' (16, 32), ragged lengths, Lq != Lkv, windows
    and rows with no visible key, L 1 and 17 (one q tile, mostly past Lq)
    and D 12, 36 and 18 (zero-padded to 16, 40 and 24; 18 by 4-byte
    copies); two launches bit-equal."""
    rng = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
               for x in (rng.normal(size=(b, lq, h, d)),
                         rng.normal(size=(b, lkv, kvh, d)),
                         rng.normal(size=(b, lkv, kvh, d))))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    assert torch.equal(got, fa.flash_attention(q, k, v, causal, window))


@pytest.mark.cuda
def test_cuda_flash_attention_infinite_key_gives_nan(cuda_device):
    """The deliberate divergence of the 3xTF32 route: with one infinite
    entry in key 10, every row that sees that key gives NaN (its TF32 lo
    part is inf - inf), where the plain version gives NaN only for the rows
    whose score is +inf and finite rows for those at -inf; rows that do
    not see the key stay within the tolerance."""
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
               for x in (rng.normal(size=(1, 40, 2, 16)),
                         rng.normal(size=(1, 40, 1, 16)),
                         rng.normal(size=(1, 40, 1, 16))))
    k[0, 10, 0, 3] = float("inf")
    got = fa.flash_attention(q, k, v, True, 0)
    want = fa.flash_attention_plain(q, k, v, True, 0)
    assert bool(torch.isnan(got[:, 10:]).all())
    assert bool(torch.isfinite(want[:, 10:]).all(dim=-1).any())
    torch.testing.assert_close(got[:, :10], want[:, :10], atol=2e-5,
                               rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_wide_heads(cuda_device):
    q = torch.zeros(1, 8, 1, 272, device=cuda_device)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("d,kv_tile", [(64, 64), (256, 16)])
@pytest.mark.parametrize("warps", [1, 2, 3, 4])
def test_cuda_flash_attention_plans_give_the_same_bits(cuda_device, d,
                                                       kv_tile, warps):
    """A warp's 16 rows, its band and its kv tiles do not depend on how
    many warps share a block: every plan gives the wrapper's bits, within
    the tolerance of the plain version (causal with a window, ragged L,
    GQA)."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
               for x in (rng.normal(size=(2, 150, 4, d)),
                         rng.normal(size=(2, 150, 2, d)),
                         rng.normal(size=(2, 150, 2, d))))
    want = fa.flash_attention(q, k, v, True, 40)
    smem = fa.attention_smem(d, kv_tile, warps)
    plan = fa.AttnPlan(warps, kv_tile, 0, 0, smem, 0)
    got = fa._launch(q, k, v, True, 40, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, True,
                                                             40),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_a_foreign_kv_tile(cuda_device):
    """The kv tile is the one built for D's size class; another raises."""
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    plan = fa.AttnPlan(2, 32, 0, 0, 0, 0)
    with pytest.raises(RuntimeError, match="flash_attention_f32"):
        fa._launch(q, q, q, True, 0, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(128, 512), (4096, 3584)])
def test_cuda_batched_lora_apply_keeps_the_simt_route(cuda_device, m, n):
    """K4 stays on the IEEE f32 SGEMM of sgemm_f32.cuh: its calls report
    plan_gemm's plan on the "sgemm" route (K5's report "mma_tf32x3"), and
    a call launches K4 alone, within K4's tolerance of its plain version."""
    k = 3584
    plan = la.describe_plan(m, n, k)
    assert plan["route"] == "sgemm"
    assert plan["splits"] == la.plan_gemm(m, n, k).splits
    assert la.describe_plan(m, n, k, tensor_cores=True)["route"] == \
        "mma_tf32x3"
    case = _lora_case(21, m, k, n, 4, 16, cuda_device)
    before = (la.batched_lora_apply.launches, la.lora_apply.launches)
    got = la.batched_lora_apply(**case)
    torch.cuda.synchronize()
    assert (la.batched_lora_apply.launches, la.lora_apply.launches) == (
        before[0] + 1, before[1])
    want = la.batched_lora_apply_plain(**case)
    assert float((got - want).abs().max()) <= _lora_tol(case)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_cuda_ops_factored_stack_gram_quantized(cuda_device, mode):
    """K1/K2 through ``ops.factored_stack_gram`` and ``..._layered`` on
    transport-quantized factors (a vit-base q/k/v/o bucket of 5 clients
    and one slice of it): one launch of each kernel a call, bit-equal to
    the same entry on the dequantized tensors, and U_c, V_c bit-exact
    against the CPU's plain version."""
    from repro_torch.federation import transport as tx
    rng = np.random.default_rng(3)
    ranks = [4, 8, 16, 24, 32]
    b = rng.normal(size=(5, 48, 768, 32)).astype(np.float32)
    a = rng.normal(size=(5, 48, 32, 768)).astype(np.float32)
    for j, r in enumerate(ranks):
        b[j, ..., r:] = 0.0
        a[j, ..., r:, :] = 0.0
    qb, qa, _, _ = tx._encode_pair(
        *(torch.from_numpy(x).to(cuda_device) for x in (b, a)),
        torch.zeros(b.shape, device=cuda_device),
        torch.zeros(a.shape, device=cuda_device), mode=mode, top_k=None)
    omega = torch.from_numpy(rng.uniform(size=(5, 32)).astype(np.float32)
                             ).to(cuda_device)
    layered = tuple(tx.QuantFactor(f.q.movedim(0, 1), f.scale.movedim(0, 1))
                    for f in (qb, qa))
    one = tuple(tx.QuantFactor(f.q[:, 0], f.scale[:, 0]) for f in (qb, qa))
    for entry, q_args in ((ops.factored_stack_gram_layered, layered),
                          (ops.factored_stack_gram, one)):
        before = [k.launches for k in rpa.KERNELS]
        got = entry(*q_args, omega)
        torch.cuda.synchronize()
        assert [k.launches for k in rpa.KERNELS] == [n + 1 for n in before]
        want = entry(*(tx.dequantize(f) for f in q_args), omega)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        cpu = entry(*(tx.QuantFactor(f.q.cpu(), f.scale.cpu())
                      for f in q_args), omega.cpu())
        for x, y in zip(got[:2], cpu[:2]):
            torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"pipeline_depth": 2},
    {"pipeline_depth": 2, "server_momentum_beta": 0.9, "transport": "int8"},
    {"event": True, "transport": "bf16"}],
    ids=["async", "async-momentum-int8", "event-bf16"])
def test_cuda_buffered_round_matches_cpu(cuda_device, kw):
    """The async engine at depth 2 and the event engine (straggler
    latency, timeout 2.0) on the card and on the CPU from the same
    weights: at the first buffered aggregation (identical state) the same
    clients, losses at rtol 1e-4, spectra within 1e-3 and products within
    2e-3 of max(1, sigma_max); K1/K2 launch 3 times at it."""
    from repro_torch.federation import events as ev
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.federation.transport import TransportConfig
    kw = dict(kw)
    event, mode = kw.pop("event", False), kw.pop("transport", None)
    args = dict(fl_overrides={"num_rounds": 4, "num_clients": 8,
                              "participation": 0.5},
                lora_overrides={"rank_levels": (4, 8, 16),
                                "rank_probs": (0.34, 0.33, 0.33)},
                samples_per_class=20, num_classes=4, d_model=32,
                batches_per_round=1, backend="kernel", round_engine="async",
                staleness_gamma=0.8, **kw)
    servers = []
    for dev, base in (("cpu", None), ("cuda", "cpu")):
        exp = build_experiment(
            "raflora", device=dev,
            base_params=None if base is None else
            servers[0].global_params(),
            transport=mode and TransportConfig(mode=mode), **args)
        if event:
            exp.server.set_event_scheduler(ev.EventScheduler(
                ev.StragglerTailLatency(
                    median=0.8, sigma=0.15, tail_scale=2.5, seed=5,
                    straggler_clients=np.flatnonzero(
                        exp.registry.ranks > 4)),
                ev.TimeoutTrigger(2.0), round_interval=1.0))
        servers.append(exp.server)
    before = [k.launches for k in rpa.KERNELS]
    hc, hg = servers[0].run(2), servers[1].run(2)
    torch.cuda.synchronize()
    assert [k.launches for k in rpa.KERNELS] == [n + 3 for n in before]
    assert [h.clients for h in hg] == [h.clients for h in hc]
    np.testing.assert_allclose([h.mean_client_loss for h in hg],
                               [h.mean_client_loss for h in hc], rtol=1e-4)
    scale = max(1.0, float(np.abs(hc[-1].sigma_probe).max()))
    np.testing.assert_allclose(hg[-1].sigma_probe, hc[-1].sigma_probe,
                               atol=1e-3 * scale)
    r_max = servers[0].lora_cfg.r_max
    fc = servers[0]._extract_factors(servers[0].global_lora, r_max)
    fg = servers[1]._extract_factors(servers[1].global_lora, r_max)
    for parent, (b, a) in fc.items():
        gb, ga = fg[parent]
        np.testing.assert_allclose((gb @ ga).cpu().numpy(), (b @ a).numpy(),
                                   atol=2e-3 * scale)
