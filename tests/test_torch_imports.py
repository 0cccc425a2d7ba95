"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package ``repro``, and its entry points refuse to drop quietly to the
CPU when CUDA is absent."""
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

MODULES = [
    "repro_torch",
    "repro_torch.checkpointing", "repro_torch.checkpointing.checkpoint",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.deepseek_v2_236b",
    "repro_torch.configs.gemma_2b", "repro_torch.configs.granite_3_8b",
    "repro_torch.configs.hubert_xlarge", "repro_torch.configs.hymba_1p5b",
    "repro_torch.configs.llama4_maverick_400b_a17b",
    "repro_torch.configs.mamba2_1p3b", "repro_torch.configs.nemotron_4_340b",
    "repro_torch.configs.paper_models", "repro_torch.configs.qwen2_7b",
    "repro_torch.configs.qwen2_vl_7b",
    "repro_torch.convert", "repro_torch.device",
    "repro_torch.core", "repro_torch.core.aggregation",
    "repro_torch.core.collective",
    "repro_torch.core.energy", "repro_torch.core.lora",
    "repro_torch.core.partitions", "repro_torch.core.server_opt",
    "repro_torch.core.svd", "repro_torch.core.theory",
    "repro_torch.data", "repro_torch.data.partition",
    "repro_torch.data.synthetic", "repro_torch.data.traces",
    "repro_torch.federation", "repro_torch.federation.client",
    "repro_torch.federation.events", "repro_torch.federation.experiment",
    "repro_torch.federation.server", "repro_torch.federation.topology",
    "repro_torch.federation.transport",
    "repro_torch.kernels", "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.gemm_plan",
    "repro_torch.kernels.lora_apply",
    "repro_torch.kernels.ops", "repro_torch.kernels.rank_partition_agg",
    "repro_torch.kernels.ssd_scan", "repro_torch.kernels.tf32x3",
    "repro_torch.models", "repro_torch.models.transformer",
    "repro_torch.models.layers.attention", "repro_torch.models.layers.dense",
    "repro_torch.models.layers.draw",
    "repro_torch.models.layers.mla", "repro_torch.models.layers.mlp",
    "repro_torch.models.layers.moe", "repro_torch.models.layers.norms",
    "repro_torch.models.layers.rope", "repro_torch.models.layers.ssd",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedules",
    "repro_torch.serving", "repro_torch.serving.adapter_store",
    "repro_torch.serving.engine", "repro_torch.serving.scheduler",
    "repro_torch.launch", "repro_torch.launch.mesh",
    "repro_torch.launch.serve", "repro_torch.launch.steps",
    "repro_torch.launch.train",
    "repro_torch.benchmarks", "repro_torch.benchmarks.common",
    "repro_torch.benchmarks.run", "repro_torch.benchmarks.bench_accuracy",
    "repro_torch.benchmarks.bench_cost",
    "repro_torch.benchmarks.bench_energy_dynamics",
    "repro_torch.benchmarks.bench_kernels",
    "repro_torch.benchmarks.bench_lora_variants",
    "repro_torch.benchmarks.bench_round_latency",
    "repro_torch.benchmarks.bench_sensitivity",
    "repro_torch.benchmarks.bench_serve_latency",
    "repro_torch.examples", "repro_torch.examples.federated_finetune",
    "repro_torch.examples.quickstart",
    "repro_torch.examples.rank_collapse_demo",
    "repro_torch.examples.serve_finetuned",
    "repro_torch.analysis", "repro_torch.analysis.complexity",
    "repro_torch.analysis.cuda_lint", "repro_torch.analysis.dispatch_audit",
    "repro_torch.analysis.host_cost", "repro_torch.analysis.liveness",
    "repro_torch.analysis.op_lint", "repro_torch.analysis.protocol",
    "repro_torch.analysis.report", "repro_torch.analysis.rng_lint",
    "repro_torch.analysis.rules",
    "repro_torch.tools", "repro_torch.tools.bench_trend",
    "repro_torch.tools.certify_scaling", "repro_torch.tools.chip_phases",
    "repro_torch.tools.ci", "repro_torch.tools.kernel_ab",
    "repro_torch.tools.lint_programs", "repro_torch.tools.verify_protocol",
]


def test_every_module_imports_without_jax_or_repro():
    """Block jax outright and check no ``repro``/``repro.*`` module got
    loaded along the way (a fresh interpreter, so nothing is cached)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {SRC!r})\n"
        "import importlib\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'repro' or m.startswith('repro.')\n"
        "             or m == 'jax' or m.startswith('jax.'))\n"
        "assert bad == ['jax'], bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_module_list_is_complete():
    """Every module file of the package is in the import check above."""
    pkg = os.path.join(SRC, "repro_torch")
    found = set()
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), SRC)[:-3]
            name = rel.replace(os.sep, ".")
            found.add(name[:-len(".__init__")] if name.endswith("__init__")
                      else name)
    missing = found - set(MODULES) - {"repro_torch.models.layers"}
    assert not missing, sorted(missing)


def test_default_device_raises_without_cuda(monkeypatch):
    from repro_torch.configs.base import LoRAConfig, get_config
    from repro_torch.device import resolve_device
    from repro_torch.federation.experiment import build_experiment, fedvit_config
    from repro_torch.models.transformer import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(fedvit_config(d_model=32), LoRAConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_config("qwen2-7b").reduced(), LoRAConfig(),
              use_kernels=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_experiment("raflora", d_model=32, backend="kernel",
                         samples_per_class=10, num_classes=4)
    assert resolve_device("cpu") == torch.device("cpu")


SMALL_EXP = dict(d_model=32, backend="kernel", samples_per_class=10,
                 num_classes=4, device="cpu")


def test_unported_options_name_their_roadmap_item():
    """The option still refused -- the bench that reads the TPU dry runs
    -- says it has no counterpart by design and names ROADMAP.md; the
    ported ones are held to the reference
    in test_torch_aggregation.py, test_torch_round.py,
    test_torch_transport.py, test_torch_events.py, test_torch_buffered.py,
    test_torch_sharded.py, test_torch_launch.py, test_torch_benches.py,
    test_torch_bench_latency.py and test_torch_variants.py."""
    from repro_torch.benchmarks import run
    with pytest.raises(NotImplementedError,
                       match="reads TPU dry-run artifacts; no counterpart on "
                             "one card, ROADMAP.md"):
        run.run_bench("roofline", "cpu")


def test_variants_bench_runs(monkeypatch):
    """Table 5's bench (the DoRA and QLoRA variants, item 10) runs through
    ``run.py`` on the CPU: six rows, one round each here."""
    from repro_torch.benchmarks import bench_lora_variants, common, run
    monkeypatch.setattr(bench_lora_variants, "ROUNDS", 1)
    common.ROWS.clear()
    assert run.run_bench("variants", "cpu")
    names = [r["name"] for r in common.ROWS]
    common.ROWS.clear()
    assert names == [f"table5_variants/{v}/{m}"
                     for v in ("lora", "qlora", "dora")
                     for m in ("flexlora", "raflora")]


@pytest.mark.parametrize("kw", [
    dict(noisy_low_rank_std=0.5), dict(server_momentum_beta=0.9),
    dict(round_engine="async", pipeline_depth=2, staleness_gamma=0.8),
    dict(round_engine="async", event_scheduler="constant"),
    dict(transport="int8")],
    ids=["noisy", "momentum", "async", "event", "transport"])
def test_ported_options_build(kw):
    """Items 6-8 (noisy clients, momentum and checkpoints, the async and
    event engines and the transport) build and run a round."""
    from repro_torch.federation import events
    from repro_torch.federation.experiment import build_experiment
    from repro_torch.federation.transport import TransportConfig
    kw = dict(kw)
    if kw.get("event_scheduler") == "constant":
        kw["event_scheduler"] = events.EventScheduler(
            events.ConstantLatency(1.0), events.CountTrigger(1))
    if kw.get("transport") == "int8":
        kw["transport"] = TransportConfig(mode="int8")
    exp = build_experiment("raflora", **kw, **SMALL_EXP)
    exp.server.run(1)
    assert len(exp.server.history) == 1


@pytest.mark.parametrize("change,variant", [
    (dict(attn_type="bidirectional"), "lora"), ({}, "dora"), ({}, "qlora"),
    (dict(attn_type="sliding", sliding_window=64), "lora"),
    (dict(rope_type="mrope", mrope_sections=(8, 12, 12)), "lora"),
    (dict(kind="hybrid", ssm="ssm"), "lora"),
    (dict(logit_softcap=30.0), "lora"), (dict(name="gemma-2b-reduced"), "lora"),
    (dict(model="deepseek-v2-236b"), "dora"),
    (dict(model="llama4-maverick-400b-a17b"), "lora"),
    (dict(model="deepseek-v2-236b", moe_impl="ep"), "lora"),
    (dict(model="deepseek-v2-236b", moe_impl="ep", moe_capacity_factor=1.25),
     "lora")],
    ids=["frontend-free-encoder", "dora", "qlora", "sliding", "mrope",
         "hybrid", "softcap", "gemma", "deepseek", "llama4", "moe_impl_ep",
         "moe_capacity_factor"])
def test_ported_model_options_build(change, variant):
    """Options item 10 lifted build and run a forward: a frontend-free
    encoder (RoBERTa-base's path), the DoRA and QLoRA variants (DoRA
    adds a magnitude next to each of the reduced qwen2's q/k/v/o
    adapters), a sliding window, M-RoPE, a hybrid SSD mixer beside
    attention, the attention softcap, Gemma's embedding scale, and the
    MLA and MoE models: DeepSeek-V2 under DoRA (a magnitude next to each
    of its q, kv_a and o adapters) and Llama-4 in layer groups, and
    DeepSeek-V2 through the expert-parallel dispatch, dropless and at a
    capacity factor, on the ``make_host_mesh()`` its model makes (a
    one-rank group, destroyed here) (held to the reference in
    test_torch_model_families.py, test_torch_moe_mla.py and
    test_torch_moe_ep.py)."""
    import dataclasses
    from repro_torch.configs.base import LoRAConfig, SSMConfig, get_config
    from repro_torch.core.lora import flatten
    from repro_torch.models.transformer import Model
    if change.get("ssm") == "ssm":
        change = dict(change, ssm=SSMConfig(state_dim=16, head_dim=32,
                                            chunk_size=32))
    change = dict(change)
    cfg = get_config(change.pop("model", "qwen2-7b")).reduced()
    model_kw = {k: change.pop(k) for k in ("moe_impl", "moe_capacity_factor")
                if k in change}
    cfg = dataclasses.replace(cfg, **change)
    model = Model(cfg, dataclasses.replace(LoRAConfig(), variant=variant),
                  device="cpu", **model_kw)
    params = model.init(torch.Generator().manual_seed(0))
    mags = [p for p in flatten(params) if p[-1] == "lora_m"]
    assert len(mags) == (len(cfg.lora_targets) if variant == "dora" else 0)
    assert ("ssm" in params["layers"]) == (cfg.kind == "hybrid")
    if cfg.moe is not None and cfg.moe.moe_layer_period > 1:
        assert set(params["layers"]) == {"sub0", "sub1"}
        assert "moe" in params["layers"]["sub1"]
    tokens = torch.zeros(1, 4, dtype=torch.int32)
    try:
        logits = model.forward_seq(params, {"tokens": tokens})[0]
    finally:
        if model_kw:
            assert model.mesh.mesh_dim_names == ("data", "model")
            torch.distributed.destroy_process_group()
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_encoder_decode_raises():
    from repro_torch.configs.base import LoRAConfig
    from repro_torch.federation.experiment import fedvit_config
    from repro_torch.models.transformer import Model
    enc = Model(fedvit_config(d_model=32), LoRAConfig(), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        enc.decode_step_clients({}, {}, {"token": torch.zeros(1, 1, 1)},
                                {}, torch.ones(1))
