"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package ``repro``, and its entry points refuse to drop quietly to the
CPU when CUDA is absent."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

MODULES = [
    "repro_torch",
    "repro_torch.checkpointing", "repro_torch.checkpointing.checkpoint",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.mamba2_1p3b", "repro_torch.configs.paper_models",
    "repro_torch.configs.qwen2_7b",
    "repro_torch.convert", "repro_torch.device",
    "repro_torch.core", "repro_torch.core.aggregation",
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
    "repro_torch.models.layers.mlp", "repro_torch.models.layers.norms",
    "repro_torch.models.layers.rope", "repro_torch.models.layers.ssd",
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedules",
    "repro_torch.serving", "repro_torch.serving.adapter_store",
    "repro_torch.serving.engine",
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
    """The options still refused -- the sharded engine, by name or by a
    mesh -- name their ROADMAP item; the ported ones are held to the
    reference in test_torch_aggregation.py, test_torch_round.py,
    test_torch_transport.py, test_torch_events.py and
    test_torch_buffered.py."""
    from repro_torch.federation.experiment import build_experiment
    for kw in (dict(round_engine="sharded"), dict(mesh=object()),
               dict(round_engine="async", mesh=object())):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue 1 item 9"):
            build_experiment("raflora", **kw, **SMALL_EXP)


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


@pytest.mark.parametrize("change", [
    dict(moe=object()), dict(attn_type="sliding", sliding_window=64),
    dict(rope_type="mrope"), dict(kind="hybrid", ssm="ssm"),
    dict(logit_softcap=30.0), dict(name="gemma-2b-reduced"),
    dict(attn_type="bidirectional")],
    ids=["moe", "sliding", "mrope", "hybrid", "softcap", "gemma",
         "frontend-free-encoder"])
def test_unported_model_options_name_their_roadmap_item(change):
    import dataclasses
    from repro_torch.configs.base import LoRAConfig, SSMConfig, get_config
    if change.get("ssm") == "ssm":
        change = dict(change, ssm=SSMConfig(state_dim=16, head_dim=32,
                                            chunk_size=32))
    from repro_torch.models.transformer import Model
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        Model(cfg, LoRAConfig(), device="cpu")


def test_unported_peft_variant_and_encoder_decode_raise():
    import dataclasses
    from repro_torch.configs.base import LoRAConfig, get_config
    from repro_torch.federation.experiment import fedvit_config
    from repro_torch.models.transformer import Model
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        Model(get_config("qwen2-7b").reduced(),
              dataclasses.replace(LoRAConfig(), variant="dora"),
              device="cpu")
    enc = Model(fedvit_config(d_model=32), LoRAConfig(), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        enc.decode_step_clients({}, {}, {"token": torch.zeros(1, 1, 1)},
                                {}, torch.ones(1))
