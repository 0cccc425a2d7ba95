"""The port's sharded round engine at world 2: what each gloo rank of
``tests/test_torch_sharded.py``'s one two-rank spawn runs, and the
port's batched engine it is held to. In a module of its own so the
spawned ranks import neither JAX nor the reference package.

Each rank also runs the expert-parallel MoE (``moe_ep_outputs``, with
its gradients) on a ("data", "model") mesh of one row of two ranks, the
layer's 4 experts split 2 + 2, for ``test_torch_sharded.py`` to hold to
one rank, and the LoRA gradients of a reduced Llama-4 whose MoE runs
expert-parallel over that mesh (``llama4_lora_grads``), to hold to the
``"tp"`` model's.

The DoRA case carries each adapter's magnitude next to its factors,
FedAvg'd with one all-reduce a magnitude. The sampled cohort is 5 clients, so at world 2 every round pads one ghost.
Each case's round starts from the weights the reference's experiment of
that case drew (a numpy tree, ``weights[label]``).
"""
import numpy as np
import torch

from repro_torch.configs import LoRAConfig, get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import collective
from repro_torch.core.lora import flatten, merge_lora, split_lora, unflatten
from repro_torch.federation.experiment import build_experiment
from repro_torch.federation.transport import TransportConfig
from repro_torch.launch import mesh as fl_mesh
from repro_torch.models.layers import moe
from repro_torch.models.transformer import Model

SMALL = dict(fl_overrides={"num_rounds": 3, "num_clients": 10,
                           "participation": 0.5},
             lora_overrides={"rank_levels": (4, 8, 16),
                             "rank_probs": (0.34, 0.33, 0.33)},
             samples_per_class=30, num_classes=6, d_model=32,
             batches_per_round=1, device="cpu")
HOMOGENEOUS = {"rank_levels": (8,), "rank_probs": (1.0,)}   # fedavg
# label -> (method, options): each one round against the batched engine
CASES = {
    "raflora-kernel": ("raflora", dict(backend="kernel")),
    "flora": ("flora", dict(backend="kernel")),
    "fedavg": ("fedavg", dict(backend="kernel",
                              lora_overrides=HOMOGENEOUS)),
    "raflora-factored-int8": ("raflora", dict(backend="factored",
                                              transport="int8")),
    "raflora-dora": ("raflora", dict(backend="kernel", lora_overrides=dict(
        SMALL["lora_overrides"], variant="dora"))),
}
# all-reduces of one bucket: the average family two factor averages,
# flora its dW, the factored / kernel backends u and v, and the quantized
# collective the two payloads and their two column-weight vectors
BUCKET_ALL_REDUCES = {"raflora-kernel": 2, "flora": 1, "fedavg": 2,
                      "raflora-factored-int8": 4, "raflora-dora": 2}
# DoRA magnitudes of a round: one all-reduce each (vit's six adapters)
MAGNITUDE_ALL_REDUCES = {"raflora-dora": 6}
ASYNC = dict(backend="kernel", round_engine="async", pipeline_depth=2,
             staleness_gamma=0.8, server_momentum_beta=0.9,
             transport="int8")


def build(method: str, engine: str, **kw):
    kw = dict(SMALL, **kw)
    if kw.get("transport") == "int8":
        kw["transport"] = TransportConfig(mode="int8")
    kw.setdefault("round_engine", engine)
    return build_experiment(method, **kw)


def residuals(server) -> dict:
    """{client: {parent: (eb, ea)}} of the transport, numpy."""
    tr = server.transport
    if tr is None:
        return {}
    return {cid: {p: (b.numpy().copy(), a.numpy().copy())
                  for p, (b, a) in acc.items()}
            for cid, acc in tr._acc.items()}


def round_result(server, stats) -> dict:
    factors = server._extract_factors(server.global_lora,
                                      server.lora_cfg.r_max)
    return {"clients": stats.clients, "ranks": stats.ranks,
            "loss": stats.mean_client_loss, "sigma": stats.sigma_probe,
            "products": {p: (f[0] @ f[1]).numpy() for p, f in
                         factors.items() if not isinstance(p[0], tuple)},
            "mags": {p[0]: m.numpy().copy() for p, m in factors.items()
                     if isinstance(p[0], tuple)},
            "base": {p: x.numpy().copy()
                     for p, x in flatten(server.base).items()},
            "residuals": residuals(server)}


def one_round(label: str, engine: str, weights) -> dict:
    """One round of a case on ``engine`` from ``weights`` (a numpy
    tree); the sharded engine also records the all-reduces of each
    bucket."""
    method, kw = CASES[label]
    exp = build(method, engine, base_params=params_from_numpy(weights, "cpu"),
                **kw)
    per_bucket = []
    agg = exp.server.aggregator
    if engine == "sharded":
        inner = agg.aggregate_grouped_sharded

        def counted(*a, **k):
            before = collective.all_reduce.calls
            res = inner(*a, **k)
            per_bucket.append(collective.all_reduce.calls - before)
            return res
        agg.aggregate_grouped_sharded = counted
    before = collective.all_reduce.calls
    stats = exp.server.run(1)[0]
    out = round_result(exp.server, stats)
    out["bucket_all_reduces"] = per_bucket
    out["round_all_reduces"] = collective.all_reduce.calls - before
    return out


def _async_state(server) -> dict:
    return {"history": [(s.clients, s.ranks, s.mean_client_loss)
                        for s in server.history],
            "energy": list(server.energy.higher_rank_ratio),
            "lora": {p: x.numpy().copy()
                     for p, x in flatten(server.global_lora).items()}}


def async_save_restore(ckpt: str) -> dict:
    """The async engine at depth 2 on the mesh: three rounds and the
    drain uninterrupted, and one round, a save (mid-buffer: a pending
    plan, residuals, momentum), a restore into a fresh server and two
    more rounds and the drain."""
    full = build("raflora", "async", mesh=fl_mesh.make_fl_mesh(device="cpu"),
                 **ASYNC)
    full.server.run(3)
    full.server.drain_pending()
    part = build("raflora", "async", mesh=fl_mesh.make_fl_mesh(device="cpu"),
                 **ASYNC)
    part.server.run(1)
    mid_buffer = bool(part.server._pending) and \
        part.server.transport.has_state()
    part.server.save(ckpt)
    resumed = build("raflora", "async",
                    mesh=fl_mesh.make_fl_mesh(device="cpu"), **ASYNC)
    resumed.server.restore(ckpt)
    resumed.server.run(2)
    resumed.server.drain_pending()
    return {"full": _async_state(full.server),
            "resumed": _async_state(resumed.server),
            "mid_buffer": mid_buffer}


# the expert-parallel layer: 4 experts top-2 and a shared expert, d 16
EP_CFG = MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                   expert_d_ff=32, shared_d_ff=32)
EP_FACTORS = (0.0, 0.5)      # dropless, and a capacity that drops


def moe_ep_outputs(mesh) -> dict:
    """``moe_apply_ep`` on ``mesh`` at each of ``EP_FACTORS`` (2 clients of
    3 x 8 tokens, the layer drawn from seed 7 on every rank): {factor:
    (out, aux)} in numpy and the all-reduces the forwards made; then, at
    each factor, the gradient of sum(out * r) + aux.sum() (r drawn from
    seed 8) into x and into the expert weights ({"grad": {factor: (gx,
    {name: g})}}) and the all-reduces of those calls, backward included."""
    gen = torch.Generator().manual_seed(7)
    params = moe.moe_init(gen, 16, EP_CFG, "swiglu")
    x = torch.randn(2, 3, 8, 16, generator=gen)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(8))
    out = {"mesh": tuple(mesh.shape)}
    calls = collective.all_reduce.calls
    for factor in EP_FACTORS:
        y, aux = moe.moe_apply_ep(params, x, EP_CFG, "swiglu", mesh,
                                  capacity_factor=factor)
        out[factor] = (y.numpy(), aux.numpy())
    out["all_reduces"] = collective.all_reduce.calls - calls
    calls = collective.all_reduce.calls
    experts = ("w_up", "w_gate", "w_down")
    out["grad"] = {}
    for factor in EP_FACTORS:
        xg = x.clone().requires_grad_()
        p = dict(params, **{k: params[k].clone().requires_grad_()
                            for k in experts})
        y, aux = moe.moe_apply_ep(p, xg, EP_CFG, "swiglu", mesh,
                                  capacity_factor=factor)
        grads = torch.autograd.grad((y * r).sum() + aux.sum(),
                                    [xg] + [p[k] for k in experts])
        out["grad"][factor] = (grads[0].numpy(), {
            k: g.numpy() for k, g in zip(experts, grads[1:])})
    out["grad_all_reduces"] = collective.all_reduce.calls - calls
    return out


# the reduced Llama-4 Maverick (a dense and an MoE layer, 8 experts top-1)
L4 = "llama4-maverick-400b-a17b"
L4_REDUCED = dict(d_model=64, max_experts=8)


def llama4_lora_grads(moe_impl: str, mesh=None) -> dict:
    """The gradient of ``train_loss`` into every LoRA factor of the
    reduced Llama-4 under ``moe_impl`` (weights from seed 11, lora_b drawn
    away from 0, tokens from seed 2): {path: numpy}."""
    cfg = get_config(L4).reduced(**L4_REDUCED)
    lora = LoRAConfig(rank_levels=(4, 8, 16), rank_probs=(1 / 3,) * 3)
    model = Model(cfg, lora, device="cpu", moe_impl=moe_impl, mesh=mesh)
    gen = torch.Generator().manual_seed(11)
    base, adapters = split_lora(model.init(gen))
    adapters = {path: (t + 0.05 * torch.randn(t.shape, generator=gen)
                       if path[-1] == "lora_b" else t).requires_grad_()
                for path, t in flatten(adapters).items()}
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    loss, _ = model.train_loss(merge_lora(base, unflatten(adapters)), batch,
                               lora_rank=8)
    grads = torch.autograd.grad(loss, list(adapters.values()))
    return {path: g.numpy() for path, g in zip(adapters, grads)}


def rank_main(rank: int, world: int, ckpt: str, weights: dict) -> dict:
    torch.set_num_threads(1)
    out = {label: one_round(label, "sharded", weights[label])
           for label in CASES}
    out["async"] = async_save_restore(ckpt)
    ep_mesh = fl_mesh.make_host_mesh(model_axis=world, device="cpu")
    out["moe_ep"] = moe_ep_outputs(ep_mesh)
    out["llama4_ep"] = llama4_lora_grads("ep", ep_mesh)
    return out
