"""Card-only checks of the port's hand-written CUDA kernels (K1-K7), of
the round and of the serving engines (qwen2 with K4, mamba2 with K6,
hymba with both) on the card, of the MLA / MoE models there
(``-k moe``, ``-k mla``), of K4's bf16 instances (``-k bf16``; at
Nemotron-4-340B's MLP ``-k nemotron``) and of Llama-4 Maverick's and
Nemotron-4-340B's init at full width (``-k llama4``, ``-k nemotron``).
They skip without CUDA (the kernels have no CPU mode) and import nothing
of JAX, so they run on a GPU machine without it:

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
    (128, 3000, 512, 4, 16),        # 16 splits of 192, the last 120 deep
    (4, 4096, 1024, 4, 16), (128, 4096, 1024, 4, 16)])   # granite k/v
def test_cuda_lora_apply_matches_plain(cuda_device, m, k, n, p, r):
    """K4 against its plain version at Qwen2-7B's decode (4 rows) and
    prefill (128 rows, split over K) shapes, at 4096 rows (unsplit), at the
    first SGEMM row counts (33, 64), at odd K / N / r on both launch paths,
    with a K that is no multiple of splits x slab, with every row on a
    different page, and at Granite-3-8B's k/v (N 1024) at 4 and 128
    rows."""
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


def _bf16_row_ulp(v):
    """The bf16 spacing at the largest |value| of each row of v."""
    a = v.float().abs().amax(dim=-1, keepdim=True).clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,p,r", [
    (4, 3584, 3584, 4, 16), (4, 3584, 512, 4, 16),      # qwen2 decode
    (128, 3584, 3584, 4, 16), (128, 3584, 512, 4, 16),  # qwen2 prefill
    (4, 5120, 5120, 3, 16), (128, 5120, 5120, 3, 16),   # llama4 q
    (9, 300, 520, 9, 8), (37, 300, 520, 3, 6),          # odd
    (128, 5120, 1024, 3, 16),                            # llama4 k/v
    (33, 5120, 1024, 4, 16), (64, 5120, 5120, 4, 16),    # route boundary
    (130, 300, 520, 4, 8), (33, 37, 23, 2, 5)])          # odd, bf16 mma
def test_cuda_lora_apply_bf16_matches_plain(cuda_device, m, k, n, p, r):
    """K4's bf16 instances (x, W and the pages bf16, y bf16) against the
    plain version on the same bf16 inputs at Qwen2-7B's decode and
    prefill shapes, Llama-4 Maverick's q and k/v projections, the first
    rows of the tensor-core route (33, 64) and odd d 300, n 520 and K 37,
    N 23 on the GEMV and the tensor-core routes: every element within one bf16
    ulp of the largest |value| of its row (both sum in f32 and round
    once; an element near 0 can differ by more than its own ulp, the two
    f32 sums running in different orders), a bf16 launch counted, and a
    second launch bit-equal to the first."""
    case = _lora_case(21, m, k, n, p, r, cuda_device,
                      ranks=[max(1, r - 2 * i) for i in range(p)])
    case = {key: (v.bfloat16() if key in ("x", "w", "a_pages", "b_pages")
                  else v) for key, v in case.items()}
    before = (la.batched_lora_apply.launches,
              la.batched_lora_apply.launches_bf16)
    got = la.batched_lora_apply(**case)
    want = la.batched_lora_apply_plain(**case)
    torch.cuda.synchronize()
    assert (la.batched_lora_apply.launches,
            la.batched_lora_apply.launches_bf16) == (before[0] + 1,
                                                     before[1] + 1)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _bf16_row_ulp(want)).all()), float(
        (diff / _bf16_row_ulp(want)).max())
    assert torch.equal(got, la.batched_lora_apply(**case))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n", [(18432, 73728), (73728, 18432)],
                         ids=["up", "down"])
def test_cuda_lora_apply_bf16_at_nemotron_mlp(cuda_device, k, n, m):
    """K4's bf16 instances at Nemotron-4-340B's up and down projections:
    W of 1.36e9 elements (2.72 GB, offsets past 2^31 bytes), at 4 rows on
    the GEMV's plans of several waves (up 1152 strips x 8 splits, 9216
    blocks; down 288 x 29 of 2560, 8352 blocks) and at 128 rows on the
    bf16 tensor cores. Inputs drawn on the card; every element within one
    bf16 ulp of its row's largest |value| of the plain version, one bf16
    launch, and a repeat bit-equal to the first launch (the last block of
    each tile sums the splits in range order, whatever order they end
    in)."""
    p, r = 4, 16
    gen = torch.Generator(device=cuda_device).manual_seed(k + m)

    def draw(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16).mul_(scale)
    case = dict(x=draw(m, k), w=draw(k, n, scale=k ** -0.5),
                a_pages=draw(p, r, k, scale=k ** -0.5),
                b_pages=draw(p, n, r),
                scales=torch.rand(p, generator=gen, device=cuda_device) + 0.5,
                ids=torch.randint(0, p, (m,), generator=gen,
                                  device=cuda_device, dtype=torch.int32))
    plan = la.describe_plan(m, n, k, dtype=torch.bfloat16)
    assert plan["route"] == ("gemv" if m <= la.GEMV_MAX_ROWS else "mma_bf16")
    before = (la.batched_lora_apply.launches,
              la.batched_lora_apply.launches_bf16)
    got = la.batched_lora_apply(**case)
    torch.cuda.synchronize()
    assert (la.batched_lora_apply.launches,
            la.batched_lora_apply.launches_bf16) == (before[0] + 1,
                                                     before[1] + 1)
    want = la.batched_lora_apply_plain(**case)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _bf16_row_ulp(want)).all()), (
        plan, float((diff / _bf16_row_ulp(want)).max()))
    assert torch.equal(got, la.batched_lora_apply(**case))
    del case, got, want, diff
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_lora_apply_refuses_mixed_dtypes(cuda_device):
    """The raw wrapper takes x, W and the pages all f32 or all bf16; a
    mix raises (``ops.batched_lora_apply`` reads a mix as f32)."""
    case = _lora_case(22, 8, 64, 40, 2, 8, cuda_device)
    with pytest.raises(TypeError):
        la.batched_lora_apply(**dict(case, w=case["w"].bfloat16()))


@pytest.mark.cuda
def test_cuda_llama4_init_peak_within_a_gib_of_the_model(cuda_device):
    """``Model.init`` of Llama-4 Maverick at full width in bf16, 2 of its
    48 layers (37.42 GB): each random draw goes straight into its stacked
    leaf, so the allocator's peak during init is the model's bytes plus
    at most 1 GiB."""
    import dataclasses

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              num_layers=2)
    model = Model(cfg, LoRAConfig(rank_levels=(4, 8, 16)), device="cuda",
                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nbytes = sum(t.nbytes for t in _tree_leaves(params))
    assert nbytes > 37e9
    assert torch.cuda.max_memory_allocated() - base <= nbytes + 2 ** 30
    del params
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_nemotron_init_peak_within_a_gib_of_the_model(cuda_device):
    """``Model.init`` of Nemotron-4-340B at full width in bf16, 2 of its
    96 layers (32.71 GB, 18.87 of it the embedding and the untied head):
    the table and the head are drawn in place as the layers are, so the
    allocator's peak is the model's bytes plus at most 1 GiB (drawn in
    f32, scaled, then cast, the head stood 13.59 GiB over)."""
    import dataclasses

    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("nemotron-4-340b"), num_layers=2)
    model = Model(cfg, LoRAConfig(rank_levels=(4, 8, 16)), device="cuda",
                  dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nbytes = sum(t.nbytes for t in _tree_leaves(params))
    assert nbytes > 32.7e9
    assert torch.cuda.max_memory_allocated() - base <= nbytes + 2 ** 30
    del params
    torch.cuda.empty_cache()


def _tree_leaves(tree):
    for v in tree.values():
        yield from (_tree_leaves(v) if isinstance(v, dict) else (v,))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(6, 64), (40, 1024)])
def test_cuda_lora_apply_strided_pages_and_bad_ids(cuda_device, m, k):
    """Per-layer page slices t[:, li] are read in place; page ids out of
    range (P, 7, -1, -P - 1) are taken as the reference's oracle takes
    them (``page_index``: from the end, then clamped), bit-equal to the
    same call at the clamped ids and within the tolerance of the plain
    version. On the GEMV route (6 rows) and on the SGEMM's split route
    (40 rows: 8 splits)."""
    case = _lora_case(11, m, k, 40, 3, 8, cuda_device)
    stacked_a = torch.stack([case["a_pages"] * 0, case["a_pages"]], dim=1)
    stacked_b = torch.stack([case["b_pages"] * 0, case["b_pages"]], dim=1)
    got = la.batched_lora_apply(case["x"], case["w"], stacked_a[:, 1],
                                stacked_b[:, 1], case["scales"], case["ids"])
    torch.testing.assert_close(got, la.batched_lora_apply(**case),
                               rtol=0, atol=0)
    bad = case["ids"].clone()
    bad[2:6] = torch.tensor([3, 7, -1, -4], dtype=torch.int32)
    out = la.batched_lora_apply(**dict(case, ids=bad))
    clamped = la.page_index(bad, 3).int()
    assert clamped[2:6].tolist() == [2, 2, 2, 0]
    assert torch.equal(out, la.batched_lora_apply(**dict(case, ids=clamped)))
    want = la.batched_lora_apply_plain(**dict(case, ids=bad))
    assert float((out - want).abs().max()) <= _lora_tol(case)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(6, 64), (40, 1024), (130, 1024)])
def test_cuda_lora_apply_bf16_strided_pages_and_bad_ids(cuda_device, m, k):
    """The bf16 instances read per-layer page slices t[:, li] in place,
    and take page ids out of range as the oracle does (bit-equal to the
    call at ``page_index``'s ids, all finite): on the GEMV (6 rows), the
    tensor cores split over K (40 rows:
    64 x 64 tiles) and two row tiles (130 rows)."""
    case = _lora_case(12, m, k, 40, 3, 8, cuda_device)
    case = {key: (v.bfloat16() if key in ("x", "w", "a_pages", "b_pages")
                  else v) for key, v in case.items()}
    stacked_a = torch.stack([case["a_pages"] * 0, case["a_pages"]], dim=1)
    stacked_b = torch.stack([case["b_pages"] * 0, case["b_pages"]], dim=1)
    got = la.batched_lora_apply(case["x"], case["w"], stacked_a[:, 1],
                                stacked_b[:, 1], case["scales"], case["ids"])
    torch.testing.assert_close(got, la.batched_lora_apply(**case),
                               rtol=0, atol=0)
    bad = case["ids"].clone()
    bad[2] = 7
    bad[m - 1] = -1
    bad[3] = -4
    out = la.batched_lora_apply(**dict(case, ids=bad))
    clamped = la.page_index(bad, 3).int()
    assert torch.equal(out, la.batched_lora_apply(**dict(case, ids=clamped)))
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 4, 8, 32])
def test_cuda_lora_apply_gemv_rows(cuda_device, m, dtype):
    """The GEMV at 1, 4, 8 and 32 rows in both dtypes at Qwen2-7B's k
    projection (K 3584, N 512: ``plan_gemv``'s split over K) and at an
    odd N 520 with K 130 (element-wise W loads): the route reported is
    "gemv", one launch, within K4's tolerance of the plain version (f32:
    (K + r) eps max; bf16: one bf16 ulp of each row's largest |value|),
    and a second launch bit-equal to the first."""
    for k, n in ((3584, 512), (130, 520)):
        case = _lora_case(31 + m, m, k, n, 4, 16, cuda_device)
        tol = _lora_tol(case)
        if dtype == torch.bfloat16:
            case = {key: (v.bfloat16() if key in ("x", "w", "a_pages",
                                                  "b_pages") else v)
                    for key, v in case.items()}
        plan = la.describe_plan(m, n, k, dtype=dtype)
        assert plan["route"] == "gemv"
        assert plan["splits"] == la.plan_gemv(
            m, n, k, 2 if dtype == torch.bfloat16 else 4).splits
        before = la.batched_lora_apply.launches
        got = la.batched_lora_apply(**case)
        want = la.batched_lora_apply_plain(**case)
        torch.cuda.synchronize()
        assert la.batched_lora_apply.launches == before + 1
        diff = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            assert bool((diff <= _bf16_row_ulp(want)).all())
        else:
            assert float(diff.max()) <= tol
        assert torch.equal(got, la.batched_lora_apply(**case))


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
    (4, 2048, 64, 50, 1, 16, 128, False),   # hymba-1.5b's prefill layer
    (4, 2048, 64, 50, 1, 16, 128, True),
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


def _same_special_places(got, want):
    """NaN at the same places, +-inf at the same places and signs."""
    got, want = got.float().cpu(), want.float().cpu()
    inf = torch.isinf(want)
    return (torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.isinf(got), inf)
            and torch.equal(got[inf], want[inf]))


# one non-finite entry: operand, token (a chunk's first or last 32), value;
# x and dt at head 1, b and c at the last group. Then finite entries whose
# intermediates the reference makes non-finite: C[tok] . B[tok + 20] above
# the diagonal overflows; x dt overflows at head 1, a strong decay after it
# ("dtx_decay") or inside the band beside a small C . B ("dtx_band"); and
# B inf beside decays exp(cum_i - cum_j) that are f32 denormals, flushed
# to 0 as the reference computes ("b_denormal": A = -1 and dt = 3 at head 3
# after the token, so rows tok + 30 .. + 34 see exp(-90 .. -102))
SCAN_SPECIAL = [("x", 255, float("inf")), ("x", 197, float("nan")),
                ("x", 40, float("-inf")), ("dt", 104, float("inf")),
                ("dt", 70, float("nan")), ("b", 138, float("-inf")),
                ("b", 120, float("nan")), ("c", 84, float("inf")),
                ("c", 127, float("nan")), ("cb_overflow", 70, 3e19),
                ("dtx_decay", 74, 1e10), ("dtx_band", 104, 1e10),
                ("b_denormal", 20, float("inf"))]


def _scan_special(arrs, op, tok, value, groups):
    """``arrs`` (x, dt, a_log, b, c, d) with SCAN_SPECIAL's entry applied,
    in place; the heads it reaches (a bool mask over the 4 heads)."""
    x, dt, a_log, b, c, _ = arrs
    g = groups - 1
    if op == "x":
        x[0, tok, 1, 5] = value
    elif op == "dt":
        dt[0, tok, 1] = value
    elif op in ("b", "c"):
        (b if op == "b" else c)[0, tok, g, 3] = value
    elif op == "cb_overflow":
        c[0, tok, g, 3] = b[0, tok + 20, g, 3] = value
    elif op in ("dtx_decay", "dtx_band"):
        x[0, tok, 1, 3], dt[0, tok, 1] = 1e30, value
        if op == "dtx_decay":
            dt[0, tok + 1, 1] = 1e3
        else:                                   # head 1 reads group 0
            b[0, tok, 0], c[0, tok, 0] = 0.0, 0.0
            b[0, tok, 0, 0], c[0, tok, 0, 0] = 1.0, 1e-20
    else:                       # b_denormal: head 3 reads the last group
        a_log[3] = 0.0
        dt[0, tok + 1:tok - tok % 64 + 64, 3] = 3.0
        b[0, tok, g, 3] = value
    reach = torch.ones(4, dtype=torch.bool)
    if op in ("x", "dt", "dtx_decay"):
        reach[[0, 2, 3]] = False
    elif groups == 2:                           # the group of heads 0-1
        reach[:2] = op == "dtx_band"            # or of heads 2-3
        reach[2:] = op != "dtx_band"
    return reach


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("op,tok,value", SCAN_SPECIAL,
                         ids=[f"{o}-{t}-{v}" for o, t, v in SCAN_SPECIAL])
def test_cuda_ssd_scan_special_values_follow_the_plain_version(
        cuda_device, op, tok, value, groups):
    """K6 with one inf or NaN in x, dt, B or C, before and inside the
    diagonal of its chunk, or with finite entries whose products overflow
    or whose decays are denormals: the NaN and +-inf places of y and the
    final state equal the plain version's (the reference's 0 * inf above
    the diagonal included), the finite rest within the scan's tolerance;
    the chunks before the token's and the heads that read neither the
    entries nor their group bit-equal to the clean call's."""
    shape = (1, 256, 4, 16, groups, 8, 64)
    arrs, _ = _scan_case(15, *shape[:-1], cuda_device, False)
    clean_y, _ = k6.ssd_scan(*arrs, 64)
    arrs = [t.clone() for t in arrs]
    reach = _scan_special(arrs, op, tok, value, groups)
    y, s = k6.ssd_scan(*arrs, 64)
    want_y, want_s = k6.ssd_scan_plain(*arrs, 64)
    for got, want in ((y, want_y), (s, want_s)):
        assert _same_special_places(got, want)
        keep = torch.isfinite(want)
        torch.testing.assert_close(got[keep], want[keep], atol=2e-4,
                                   rtol=1e-3)
    assert bool(want_y.isnan().any())
    c0 = tok - tok % 64 if op != "b_denormal" else 0
    assert torch.equal(y[:, :c0], clean_y[:, :c0])
    assert torch.equal(y[:, :, ~reach.to(cuda_device)],
                       clean_y[:, :, ~reach.to(cuda_device)])


@pytest.mark.cuda
def test_cuda_ssd_scan_overflow_above_the_diagonal_nans_the_row_as_plain(
        cuda_device):
    """Finite C[i] and B[j], j > i in one chunk, whose product overflows
    f32: the reference's C B^T * L is inf * 0 = NaN there, so row i is NaN
    at every column of the group's heads. Launch 1's max |C| max |B| N
    flags the (batch, chunk, head)s and the repair sums C[i] . B[j] again;
    the card's NaN places equal the plain version's, the rest within the
    scan's tolerance."""
    arrs, _ = _scan_case(16, 1, 128, 2, 8, 1, 8, cuda_device, False)
    arrs[4][0, 70, 0, 3] = 3e19        # C, row 70
    arrs[3][0, 90, 0, 3] = 3e19        # B, token 90: C[70] . B[90] = inf
    y, s = k6.ssd_scan(*arrs, 64)
    want, want_s = k6.ssd_scan_plain(*arrs, 64)
    row = torch.zeros_like(want, dtype=torch.bool)
    row[0, 70] = True
    assert torch.equal(want.isnan(), row)
    for got, ref in ((y, want), (s, want_s)):
        assert _same_special_places(got, ref)
        keep = torch.isfinite(ref)
        torch.testing.assert_close(got[keep], ref[keep], atol=2e-4,
                                   rtol=1e-3)


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
def test_cuda_hymba_engine_matches_cpu(cuda_device):
    """A reduced hymba engine on the card with ``use_kernels=True`` (K4 on
    q/k/v/o, K6 on the SSD heads' prefill scan) and on the CPU from the
    same weights, 96-token prompts (the window of 64 bites in layer 1, the
    scan runs 3 chunks of 32) and 4 decode steps past the window: equal
    greedy tokens; per admit 4 K4 launches a layer and one K6 call a
    layer, per decode step the K4 launches and no K6 call."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = get_config("hymba-1.5b").reduced()
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {name: unflatten({
        path: 0.05 * torch.randn(t.shape, generator=gen)
        for path, t in flatten(params).items()
        if path[-1] in ("lora_a", "lora_b")}) for name in ("hi", "lo")}
    prompts = torch.randint(0, cfg.vocab_size, (2, 96), generator=gen)
    runs = []
    for dev, kern in (("cuda", True), ("cpu", False)):
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        store.put("hi", move(tenants["hi"]), 16)
        store.put("lo", move(tenants["lo"]), 4)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            move(params), store, max_len=101, slots=2)
        before = (la.batched_lora_apply.launches, k6.ssd_scan.launches)
        toks = [eng.admit([0, 1], prompts, ["hi", "lo"]).cpu()]
        layers = cfg.num_layers if kern else 0
        assert (la.batched_lora_apply.launches - before[0],
                k6.ssd_scan.launches - before[1]) == (4 * layers, layers)
        for _ in range(4):
            before = (la.batched_lora_apply.launches, k6.ssd_scan.launches)
            toks.append(eng.decode([True, True]).cpu())
            assert (la.batched_lora_apply.launches - before[0],
                    k6.ssd_scan.launches - before[1]) == (4 * layers, 0)
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
    """Once a pinned divergence, now the reference's rule: inf in B at a
    zero-weight column of a slab whose 16 weights are all zero, NaN in A
    at such a depth, inf in A and -inf in B at zero weights of a live
    slab. The kernel skips the dead slab's products but flags it: its
    output has NaN exactly where the plain einsum (like the reference)
    has NaN, and where the CPU emulation has; the rest is within the
    finite test's tolerance; only the layer that holds an entry is hit;
    the flags are left clear (a clean call after it is finite and
    bit-equal to a second one)."""
    bs, as_, omega = _agg_zero_slabs(21, 2, 4, 40, 8, 24, cuda_device)
    assert rpa.live_slabs(omega).tolist() == [True, False]
    clean_b, clean_a = bs.clone(), as_.clone()
    bs[0, 2, 5, 3] = float("inf")
    as_[1, 3, 1, 7] = float("nan")
    bs[1, 1, 9, 6] = float("-inf")
    as_[0, 0, 2, 11] = float("inf")
    omega[0, 2] = 0.0
    omega[1, 6] = 0.0
    got = rpa.rank_partition_agg_layered(bs, as_, omega)
    want = rpa.rank_partition_agg_layered_plain(bs, as_, omega)
    assert torch.equal(got.isnan(), want.isnan())
    emulated = rpa.rank_partition_agg_layered_split_plain(
        bs.cpu(), as_.cpu(), omega.cpu())
    assert torch.equal(got.isnan().cpu(), emulated.isnan())
    assert bool(got[0, 5].isnan().all()) and bool(got[1, :, 7].isnan().all())
    keep = ~want.isnan()
    mag = rpa.rank_partition_agg_layered_plain(
        clean_b.abs(), clean_a.abs(), omega.abs())
    tol = (4 * 8 + 2) * torch.finfo(torch.float32).eps * float(mag.max())
    assert float((got[keep] - want[keep]).abs().max()) <= tol
    again = rpa.rank_partition_agg_layered(clean_b, clean_a, omega)
    assert bool(again.isfinite().all())
    assert torch.equal(again, rpa.rank_partition_agg_layered(
        clean_b, clean_a, omega))


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
    """Once a pinned divergence of the 3xTF32 route, now the IEEE result:
    an infinite x gives +-inf along its row above 32 rows (its split is
    +-1 and +-inf, so no pass multiplies inf by an exact W's lo of 0), NaN
    where it meets a zero of W, as the plain version does and as the GEMV
    at most 32 rows does; the other rows stay within the tolerance."""
    rng = np.random.default_rng(23)
    x, w = (torch.from_numpy(v.astype(np.float32)).to(cuda_device)
            for v in (rng.normal(size=(m, 300)),
                      rng.normal(size=(300, 40)) * 300 ** -0.5))
    a, b = x.new_zeros(0, 300), x.new_zeros(40, 0)
    x[5, 7] = float("inf")
    w[7, 3] = 0.0
    got = la.lora_apply(x, w, a, b, 1.0)
    want = la.lora_apply_plain(x, w, a, b, 1.0)
    assert bool(torch.isinf(want[5]).sum() == 39) and bool(want[5, 3].isnan())
    assert torch.equal(got[5].isnan(), want[5].isnan())
    fin = ~want[5].isnan()
    assert torch.equal(got[5][fin], want[5][fin])
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
def test_cuda_ops_batched_lora_apply_bf16_int64_ids(cuda_device):
    """K4 through ``ops.batched_lora_apply`` on the card: bf16 x, W and
    pages (the pages' last two axes transposed in memory), int64 ids and
    a 3-D x launch the kernel once and come back as bf16 (3, 17, N),
    within one bf16 step (3e-2) of the same call on the CPU."""
    rng = np.random.default_rng(18)
    p, r, k, n = 3, 8, 100, 72
    x, w, a, b = (torch.from_numpy(v.astype(np.float32)).bfloat16() for v in (
        rng.normal(size=(3, 17, k)), rng.normal(size=(k, n)) * 0.1,
        rng.normal(size=(p, k, r)) * 0.1, rng.normal(size=(p, r, n)) * 0.1))
    a, b = a.transpose(1, 2), b.transpose(1, 2)       # (P, r, K), (P, N, r)
    scales = torch.tensor([0.5, 1.0, 2.0])
    ids = torch.from_numpy(rng.integers(0, p, size=(3, 17)))
    assert ids.dtype == torch.int64
    args = (x, w, a, b, scales, ids)
    before = la.batched_lora_apply.launches
    got = ops.batched_lora_apply(*(t.to(cuda_device) for t in args))
    torch.cuda.synchronize()
    assert la.batched_lora_apply.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (3, 17, n)
    torch.testing.assert_close(got.cpu().float(),
                               ops.batched_lora_apply(*args).float(),
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
    """Once a pinned divergence of the 3xTF32 route, now the IEEE result:
    with one infinite entry in key 10, the rows whose score with it is
    -inf drop that key and stay within the tolerance of the plain
    version; those at +inf are NaN in both; rows that do not see the key
    are unchanged."""
    rng = np.random.default_rng(24)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
               for x in (rng.normal(size=(1, 40, 2, 16)),
                         rng.normal(size=(1, 40, 1, 16)),
                         rng.normal(size=(1, 40, 1, 16))))
    k[0, 10, 0, 3] = float("inf")
    got = fa.flash_attention(q, k, v, True, 0)
    want = fa.flash_attention_plain(q, k, v, True, 0)
    minus = q[0, 10:, :, 3] < 0                     # score -inf: dropped
    assert bool(minus.any()) and bool((~minus).any())
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(want[0, 10:][~minus].isnan().all())
    assert bool(want[0, 10:][minus].isfinite().all())
    keep = ~want.isnan()
    torch.testing.assert_close(got[keep], want[keep], atol=2e-5, rtol=1e-4)


# one non-finite value entry that some rows' band leaves out: (Lkv,
# causal, window, key) at Lq 40
PAST_BAND = {"causal": (40, True, 0, 30), "causal-window": (40, True, 8, 3),
             "window": (40, False, 8, 3), "causal-lkv-gt-lq": (48, True, 0,
                                                               44)}


@pytest.mark.cuda
@pytest.mark.parametrize("value", [float("inf"), float("nan")],
                         ids=["inf", "nan"])
@pytest.mark.parametrize("case", list(PAST_BAND))
def test_cuda_flash_attention_value_past_the_band_gives_nan(cuda_device,
                                                            case, value):
    """The oracle takes p v over all Lkv keys with p = 0 outside a row's
    band: one inf or NaN value entry there makes its column NaN at every
    row that does not see the key. K7 (the pass over V, then those rows
    again in IEEE f32) has the plain version's NaN and +-inf places and
    its finite values within the tolerance; the query heads of the other
    kv head are bit-equal to the clean call's; one wrapper call counted."""
    lkv, causal, window, key = PAST_BAND[case]
    rng = np.random.default_rng(25)
    q, k, v = (torch.from_numpy(x.astype(np.float32)).to(cuda_device)
               for x in (rng.normal(size=(1, 40, 4, 16)),
                         rng.normal(size=(1, lkv, 2, 16)),
                         rng.normal(size=(1, lkv, 2, 16))))
    clean = fa.flash_attention(q, k, v, causal, window)
    v[0, key, 1, 5] = value
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert _same_special_places(got, want)
    assert bool(want[0, :, 2:, 5].isnan().any())
    keep = torch.isfinite(want)
    torch.testing.assert_close(got[keep], want[keep], atol=2e-5, rtol=1e-4)
    assert torch.equal(got[:, :, :2], clean[:, :, :2])


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
@pytest.mark.parametrize("m,n", [(128, 5120), (128, 1024), (64, 512)])
def test_cuda_batched_lora_apply_bf16_takes_the_tensor_cores(cuda_device, m,
                                                             n):
    """Above 32 rows K4's bf16 instances run on the bf16 tensor cores: the
    route reported is "mma_bf16" with ``plan_gemm_bf16``'s plan (the f32
    instances keep "sgemm"), a call counts one K4 launch and one bf16
    launch and no K5 launch, and it lands within one bf16 ulp of each
    row's largest |value| of the plain version (Llama-4's q and k/v at
    128 rows, K 5120)."""
    k = 5120
    plan = la.describe_plan(m, n, k, dtype=torch.bfloat16)
    assert plan == {"route": "mma_bf16",
                    **la.plan_gemm_bf16(m, n, k).report()}
    assert la.describe_plan(m, n, k)["route"] == "sgemm"
    case = _lora_case(23, m, k, n, 4, 16, cuda_device)
    case = {key: (v.bfloat16() if key in ("x", "w", "a_pages", "b_pages")
                  else v) for key, v in case.items()}
    before = (la.batched_lora_apply.launches,
              la.batched_lora_apply.launches_bf16, la.lora_apply.launches)
    got = la.batched_lora_apply(**case)
    torch.cuda.synchronize()
    assert (la.batched_lora_apply.launches,
            la.batched_lora_apply.launches_bf16, la.lora_apply.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    want = la.batched_lora_apply_plain(**case)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _bf16_row_ulp(want)).all())


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


@pytest.mark.cuda
def test_cuda_launcher_two_kernel_rounds(cuda_device, tmp_path):
    """``repro_torch.launch.train`` on the card at its defaults with the
    kernel backend, two rounds: K1 and K2 launch once per shape bucket a
    round (3 buckets: q/k/v/o, up, down), the log has a row a round with
    the test accuracy at the last, and a server restored from the
    checkpoint holds the saved global adapters bit for bit."""
    import json
    from repro_torch.core.lora import flatten
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.launch import train
    args = train.parse_args(["--rounds", "2", "--backend", "kernel"])
    exp = build_experiment(args.method, **train.experiment_args(args))
    ops.reset_launches()
    out, ckpt = tmp_path / "log.json", str(tmp_path / "ckpt")
    log = train.train(exp, args.rounds, args.eval_every, ckpt, str(out))
    torch.cuda.synchronize()
    assert [k.launches for k in rpa.KERNELS] == [6, 6, 6, 6]
    assert json.loads(out.read_text()) == log
    assert [r["round"] for r in log] == [0, 1]
    assert "test_accuracy" in log[-1]
    assert all(np.isfinite(r["loss"]) for r in log)
    fresh = build_experiment(args.method, **train.experiment_args(args))
    fresh.server.restore(ckpt)
    want = flatten(exp.server.global_lora)
    got = flatten(fresh.server.global_lora)
    assert got.keys() == want.keys()
    for path, x in want.items():
        assert torch.equal(got[path], x), path


@pytest.mark.cuda
def test_cuda_sharded_round_world1_nccl_matches_batched(cuda_device):
    """One fedvit-tiny round of the sharded engine on a one-rank NCCL group
    (made in this process) against the batched engine on the card from
    the same weights, at the round tolerances (loss rtol 1e-4, spectra
    1e-3 and products 2e-3 of sigma_max); K1 and K2 launch once per
    shape bucket (3), and each bucket makes 2 all-reduces."""
    import torch.distributed as dist
    from repro_torch.core import collective
    from repro_torch.federation.experiment import build_experiment
    args = dict(fl_overrides={"num_rounds": 1, "num_clients": 10,
                              "participation": 0.5},
                lora_overrides={"rank_levels": (4, 8, 16),
                                "rank_probs": (0.34, 0.33, 0.33)},
                samples_per_class=30, num_classes=6, d_model=32,
                batches_per_round=1, backend="kernel")
    batched = build_experiment("raflora", **args)
    base = batched.server.global_params()
    assert not dist.is_initialized()
    sharded = build_experiment("raflora", round_engine="sharded",
                               base_params=base, **args)
    try:
        assert dist.get_backend() == "nccl"
        (sb,) = batched.server.run(1)
        ops.reset_launches()
        calls = collective.all_reduce.calls
        (ss,) = sharded.server.run(1)
        torch.cuda.synchronize()
        assert [k.launches for k in rpa.KERNELS] == [3, 3, 3, 3]
        # 3 buckets of u and v, and the round's losses
        assert collective.all_reduce.calls - calls == 3 * 2 + 1
    finally:
        sharded.server.close()      # the one-rank NCCL group it made
    assert not dist.is_initialized()
    assert ss.clients == sb.clients and ss.ranks == sb.ranks
    np.testing.assert_allclose(ss.mean_client_loss, sb.mean_client_loss,
                               rtol=1e-4)
    scale = max(1.0, float(np.abs(sb.sigma_probe).max()))
    np.testing.assert_allclose(ss.sigma_probe, sb.sigma_probe,
                               atol=1e-3 * scale)
    r_max = batched.server.lora_cfg.r_max
    fb = batched.server._extract_factors(batched.server.global_lora, r_max)
    fs = sharded.server._extract_factors(sharded.server.global_lora, r_max)
    for parent, (b, a) in fb.items():
        sb_, sa_ = fs[parent]
        np.testing.assert_allclose((sb_ @ sa_).cpu().numpy(),
                                   (b @ a).cpu().numpy(), atol=2e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,engine", [
    ("dora", "batched"), ("dora", "sequential"), ("qlora", "batched")],
    ids=["variants-dora-batched", "variants-dora-sequential",
         "variants-qlora-batched"])
def test_cuda_variants_round_matches_cpu(cuda_device, variant, engine):
    """One fedvit-tiny raFLoRA round of the PEFT variants on the card and
    on the CPU from the same weights (the CPU's, magnitudes or quantized
    base included): the round tolerances of
    ``test_cuda_round_methods_match_cpu`` and the DoRA magnitudes at rtol
    1e-4; K1/K2 once per shape bucket in the batched engine (the
    magnitudes enter no bucket)."""
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.federation.transport import is_magnitude
    args = dict(fl_overrides={"num_rounds": 1, "num_clients": 8,
                              "participation": 0.5},
                lora_overrides={"rank_levels": (4, 8, 16),
                                "rank_probs": (0.34, 0.33, 0.33),
                                "variant": variant},
                samples_per_class=30, num_classes=6, d_model=32,
                batches_per_round=1, backend="kernel", round_engine=engine)
    cpu = build_experiment("raflora", device="cpu", **args)
    gpu = build_experiment("raflora", base_params=cpu.server.global_params(),
                           **args)
    before = [k.launches for k in rpa.KERNELS]
    (sg,), (sc,) = gpu.server.run(1), cpu.server.run(1)
    if engine == "batched":
        assert [k.launches - b for k, b in zip(rpa.KERNELS, before)] == \
            [3] * 4
    assert sg.clients == sc.clients
    np.testing.assert_allclose(sg.mean_client_loss, sc.mean_client_loss,
                               rtol=1e-4)
    scale = max(1.0, float(np.abs(sc.sigma_probe).max()))
    np.testing.assert_allclose(sg.sigma_probe, sc.sigma_probe,
                               atol=1e-3 * scale)
    fg = gpu.server._extract_factors(gpu.server.global_lora, 16)
    fc = cpu.server._extract_factors(cpu.server.global_lora, 16)
    assert list(fg) == list(fc)
    mags = 0
    for parent, val in fc.items():
        if is_magnitude(parent):
            mags += 1
            np.testing.assert_allclose(fg[parent].cpu().numpy(),
                                       val.numpy(), rtol=1e-4)
            continue
        gb, ga = fg[parent]
        np.testing.assert_allclose((gb @ ga).cpu().numpy(),
                                   (val[0] @ val[1]).numpy(),
                                   atol=2e-3 * scale)
    assert mags == (6 if variant == "dora" else 0)


def _router_margin(fn):
    """Run ``fn`` and return the smallest gap between a token's k-th and
    (k+1)-th router probability of the port's MoE layers in it."""
    from repro_torch.models.layers import moe
    gaps, inner = [], moe.router_topk

    def recording(logits, top_k):
        probs = torch.sort(torch.softmax(logits.float(), -1), -1,
                           descending=True).values
        gaps.append(float((probs[..., top_k - 1] - probs[..., top_k]).min()))
        return inner(logits, top_k)
    moe.router_topk = recording
    try:
        out = fn()
    finally:
        moe.router_topk = inner
    return out, min(gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-236b",
                                  "llama4-maverick-400b-a17b"],
                         ids=["moe-mla-deepseek", "moe-llama4"])
def test_cuda_moe_mla_forward_matches_cpu(cuda_device, name):
    """The reduced model (8 experts; DeepSeek's MLA, Llama-4's dense /
    MoE layer groups) on the card and on the CPU from the same weights:
    logits within atol 1e-4, rtol 1e-4 and the aux loss at rtol 1e-5,
    with the CPU router's smallest top-k margin above 1e-4 (a near-tie may
    route differently on the two devices)."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    cfg = get_config(name).reduced(d_model=64, max_experts=8)
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    params = unflatten({p: (0.05 * torch.randn(t.shape, generator=gen)
                            if p[-1] == "lora_b" else t)
                        for p, t in flatten(params).items()})
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=gen)}
    (want, want_aux, _), margin = _router_margin(
        lambda: Model(cfg, lora, device="cpu").forward_seq(params, batch))
    assert margin > 1e-4, margin
    got, aux, _ = Model(cfg, lora, device="cuda").forward_seq(
        unflatten({p: t.cuda() for p, t in flatten(params).items()}), batch)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=0, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 6])
def test_cuda_moe_sorted_dispatch_matches_dense_oracle(cuda_device, top_k):
    """``moe_apply`` (the sorted dispatch, one product a non-empty expert)
    on the card against ``moe_apply_dense`` (every token through every
    expert) on the same card inputs, 3 clients x 40 tokens, 16 experts of
    width 96 plus a shared expert: within atol 1e-5, rtol 1e-4; the aux
    equal; one host sync a call."""
    from repro_torch.configs import ACT_SWIGLU, MoEConfig
    from repro_torch.models.layers import moe
    cfg = MoEConfig(num_experts=16, top_k=top_k, num_shared_experts=1,
                    expert_d_ff=96, shared_d_ff=96)
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = moe.moe_init(gen, 128, cfg, ACT_SWIGLU, device="cuda")
    x = torch.randn(3, 40, 128, generator=gen, device="cuda")
    syncs = moe.moe_apply.host_syncs
    out, aux = moe.moe_apply(params, x, cfg, ACT_SWIGLU)
    assert moe.moe_apply.host_syncs == syncs + 1
    want, want_aux = moe.moe_apply_dense(params, x, cfg, ACT_SWIGLU)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(aux, want_aux, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_mla_moe_engine_matches_cpu(cuda_device):
    """A reduced DeepSeek-V2 engine on the card with ``use_kernels=True``
    and on the CPU from the same weights, with ragged slots (slot 1
    admitted later with a shorter prompt): equal greedy tokens, the
    compressed cache {"ckv", "krope"}, and no K4 launch (MLA's
    projections and the experts take the plain route, as the
    reference's)."""
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.transformer import Model
    from repro_torch.serving import AdapterStore, ServingEngine
    cfg = get_config("deepseek-v2-236b").reduced(d_model=64, max_experts=8)
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {name: unflatten({
        path: 0.05 * torch.randn(t.shape, generator=gen)
        for path, t in flatten(params).items()
        if path[-1] in ("lora_a", "lora_b")}) for name in ("hi", "lo")}
    p0 = torch.randint(0, cfg.vocab_size, (1, 12), generator=gen)
    p1 = torch.randint(0, cfg.vocab_size, (1, 7), generator=gen)
    runs = []
    for dev, kern in (("cuda", True), ("cpu", False)):
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        store.put("hi", move(tenants["hi"]), 16)
        store.put("lo", move(tenants["lo"]), 4)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            move(params), store, max_len=20, slots=2)
        before = la.batched_lora_apply.launches
        toks = [eng.admit([0], p0, ["hi"]).cpu(),
                eng.decode([True, False]).cpu(),
                eng.admit([1], p1, ["lo"]).cpu()]
        for _ in range(4):
            toks.append(eng.decode([True, True]).cpu())
        assert la.batched_lora_apply.launches == before
        assert set(eng.cache["layers"]) == {"ckv", "krope"}
        runs.append(torch.cat([t.reshape(-1) for t in toks]))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_batcher_matches_cpu(cuda_device):
    """The continuous batcher over a reduced qwen2-7b (GQA 4/2) engine on
    the card with ``use_kernels=True`` and over the same engine on the CPU
    from the same weights: 5 requests over 2 slots (tenants at ranks 16
    and 4, arrivals 0.01 i, lognormal latency draws): every request's
    tokens equal, ``stats()`` bit-equal, and K4 4 launches a layer per
    engine call on the card."""
    import dataclasses
    from repro_torch.configs import LoRAConfig, get_config
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.federation.events import LognormalLatency
    from repro_torch.models.transformer import Model
    from repro_torch.serving import (AdapterStore, ContinuousBatcher,
                                     ServeRequest, ServingEngine)
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(),
                              num_kv_heads=2)
    lora = LoRAConfig(rank_levels=(4, 8, 16))
    params = Model(cfg, lora, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tenants = {name: unflatten({
        path: 0.05 * torch.randn(t.shape, generator=gen)
        for path, t in flatten(params).items()
        if path[-1] in ("lora_a", "lora_b")}) for name in ("hi", "lo")}
    prompts = torch.randint(0, cfg.vocab_size, (5, 8), generator=gen)
    runs = []
    for dev, kern in (("cuda", True), ("cpu", False)):
        move = lambda tree: unflatten(  # noqa: E731
            {p: t.to(dev) for p, t in flatten(tree).items()})
        store = AdapterStore(lora.rank_levels)
        store.put("hi", move(tenants["hi"]), 16)
        store.put("lo", move(tenants["lo"]), 4)
        store.publish()
        eng = ServingEngine(Model(cfg, lora, device=dev, use_kernels=kern),
                            move(params), store, max_len=13, slots=2)
        batcher = ContinuousBatcher(
            eng, latency=LognormalLatency(0.02, 0.25, seed=0))
        for i in range(5):
            batcher.submit(ServeRequest(
                rid=i, prompt=prompts[i].to(dev),
                adapter_id=("hi", "lo")[i % 2], max_new_tokens=4,
                arrival=0.01 * i))
        before = la.batched_lora_apply.launches
        batcher.run()
        grew = la.batched_lora_apply.launches - before
        assert grew == (4 * cfg.num_layers * len(eng.version_log)
                        if kern else 0)
        runs.append(({r.rid: r.tokens for r in batcher.done},
                     batcher.stats()))
    assert len(runs[0][0]) == 5
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_moe_ep_capacity_makes_no_host_sync(cuda_device):
    """``moe_apply_ep`` at capacity on a one-rank NCCL group (made here
    and destroyed): no host sync at all (CUDA's sync debug mode set to
    raise around the call), none counted; at a factor with no overflow
    it equals ``moe_apply`` on the card (atol 1e-5, rtol 1e-4), and at
    0.5 it equals the CPU's capacity path."""
    import torch.distributed as dist
    from repro_torch.configs import ACT_SWIGLU, MoEConfig
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import moe
    cfg = MoEConfig(num_experts=16, top_k=6, num_shared_experts=1,
                    expert_d_ff=96, shared_d_ff=96)
    gen = torch.Generator().manual_seed(3)
    params = moe.moe_init(gen, 128, cfg, ACT_SWIGLU)
    x = torch.randn(3, 40, 128, generator=gen)
    gpu = unflatten({p: t.cuda() for p, t in flatten(params).items()})
    assert not dist.is_initialized()
    mesh = make_host_mesh(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        xg = x.cuda()
        moe.moe_apply_ep(gpu, xg, cfg, ACT_SWIGLU, mesh,
                         capacity_factor=0.5)          # warm-up
        torch.cuda.synchronize()
        syncs = moe.moe_apply.host_syncs
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = {f: moe.moe_apply_ep(gpu, xg, cfg, ACT_SWIGLU, mesh,
                                       capacity_factor=f)[0]
                   for f in (0.5, float(cfg.num_experts))}
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert moe.moe_apply.host_syncs == syncs
        want, _ = moe.moe_apply(gpu, xg, cfg, ACT_SWIGLU)
        torch.testing.assert_close(got[float(cfg.num_experts)], want,
                                   atol=1e-5, rtol=1e-4)
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cpu, _ = moe.moe_apply_ep(params, x, cfg, ACT_SWIGLU,
                                  make_host_mesh(device="cpu"),
                                  capacity_factor=0.5)
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(got[0.5].cpu(), cpu, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_lint_over_the_real_build(cuda_device):
    """The CUDA lint over ptxas's report of all six libraries (compiled
    again for their report if already built): every entry parsed, the
    spills within the waiver table, static shared memory within 48 KiB,
    and the pad-to-tile probes through ``kernels.ops`` on the card
    returning their contract shapes, f32 and finite."""
    from repro_torch.analysis import cuda_lint
    from repro_torch.kernels import build
    build.build_all()
    logs = cuda_lint.ptxas_reports()
    assert sorted(logs) == sorted(build.SIGNATURES)
    before = {k.__name__: k.launches for k in ops.KERNELS}
    progs = cuda_lint.CudaPrograms(cuda_lint.collect_build(logs),
                                   cuda_lint.probe_registry(cuda_device))
    assert cuda_lint.lint_cuda(progs, "cuda/registry", {
        "libraries": sorted(build.SIGNATURES)}) == []
    assert len(progs.entries) >= 40
    assert {p.name for p in progs.probes if p.ok} == set(cuda_lint.REGISTRY)
    launched = {k.__name__ for k in ops.KERNELS
                if k.launches > before[k.__name__]}
    assert len(launched) == len(ops.KERNELS), launched
