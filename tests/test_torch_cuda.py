"""Card-only checks of the port's hand-written CUDA kernels, of the round
and of the serving engine on the card. They skip without CUDA (the kernels have no CPU mode)
and import nothing of JAX, so they run on a GPU machine without it:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import lora_apply as la
from repro_torch.kernels import rank_partition_agg as rpa


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
    (3, 3, 130, 48, 70), (48, 6, 768, 32, 768)])
def test_cuda_kernels_match_plain(cuda_device, layers, m, d, r, n):
    """K1 bit-exact against its plain version (IEEE sqrtf and one
    multiply); K2 within depth * eps * max column norm^2 (the worst-case
    rounding of a length-depth f32 dot product), and exactly symmetric.
    R = m * r spans one to three 64-wide tiles, with ragged edges."""
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
    (9, 300, 520, 9, 8)])                                # a page per row
def test_cuda_lora_apply_matches_plain(cuda_device, m, k, n, p, r):
    """K4 against its plain version at Qwen2-7B's decode (4 rows) and
    prefill (128 rows) shapes, at odd K / N / r on both launch paths, and
    with every row on a different page."""
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
def test_cuda_lora_apply_strided_pages_and_bad_ids(cuda_device):
    """Per-layer page slices t[:, li] are read in place; a row whose page
    id is out of range comes back NaN, the others unaffected."""
    case = _lora_case(11, 6, 64, 40, 3, 8, cuda_device)
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
