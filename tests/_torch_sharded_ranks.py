"""The port's sharded round engine at world 2: what each gloo rank of
``tests/test_torch_sharded.py``'s one two-rank spawn runs, and the
port's batched engine it is held to. In a module of its own so the
spawned ranks import neither JAX nor the reference package.

Each rank also runs the expert-parallel MoE (``moe_ep_outputs``) on a
("data", "model") mesh of one row of two ranks, the layer's 4 experts
split 2 + 2, for ``test_torch_sharded.py`` to hold to one rank.

The DoRA case carries each adapter's magnitude next to its factors,
FedAvg'd with one all-reduce a magnitude. The sampled cohort is 5 clients, so at world 2 every round pads one ghost.
Each case's round starts from the weights the reference's experiment of
that case drew (a numpy tree, ``weights[label]``).
"""
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import collective
from repro_torch.core.lora import flatten
from repro_torch.federation.experiment import build_experiment
from repro_torch.federation.transport import TransportConfig
from repro_torch.launch import mesh as fl_mesh
from repro_torch.models.layers import moe

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
    (out, aux)} in numpy, the all-reduces made, and the message of the
    refusal of a gradient (None where none was raised)."""
    gen = torch.Generator().manual_seed(7)
    params = moe.moe_init(gen, 16, EP_CFG, "swiglu")
    x = torch.randn(2, 3, 8, 16, generator=gen)
    out = {"mesh": tuple(mesh.shape)}
    calls = collective.all_reduce.calls
    for factor in EP_FACTORS:
        y, aux = moe.moe_apply_ep(params, x, EP_CFG, "swiglu", mesh,
                                  capacity_factor=factor)
        out[factor] = (y.numpy(), aux.numpy())
    out["all_reduces"] = collective.all_reduce.calls - calls
    try:
        moe.moe_apply_ep(params, x.clone().requires_grad_(), EP_CFG,
                         "swiglu", mesh)
        out["grad"] = None
    except NotImplementedError as e:
        out["grad"] = str(e)
    return out


def rank_main(rank: int, world: int, ckpt: str, weights: dict) -> dict:
    torch.set_num_threads(1)
    out = {label: one_round(label, "sharded", weights[label])
           for label in CASES}
    out["async"] = async_save_restore(ckpt)
    out["moe_ep"] = moe_ep_outputs(fl_mesh.make_host_mesh(model_axis=world,
                                                          device="cpu"))
    return out
