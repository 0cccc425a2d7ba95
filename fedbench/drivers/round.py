"""Driver of the federated round cells: raFLoRA rounds of the port's
``FederatedLoRA`` (batched engine, kernel backend) back to back.

Set-up builds the server on the benchmark's parameters, data and client
ranks, and drives it through the traffic's ``checked_rounds`` rounds
(the warm-up, which builds the kernels and the solver's state), keeping
what each round produced: each local step's per-client losses, the first
local step's per-client gradient norms, each client's trained factors
and the round's global factors. The window runs rounds until
``seconds`` have passed, each keeping on the device what the check
compares of the window's last round: its starting global factors, each
client's trained factors and last-step loss, and the round's global
factors. The check runs the reference over the checked rounds and the
window's last round, each from the global factors that the program's
round started from (``starts``), and compares (``compare``).
"""
from __future__ import annotations

import contextlib
import gc
import statistics
import time

import numpy as np
import torch

from fedbench import counts, port, workload
from fedbench.drivers import patched
from fedbench.reference import vit as ref

TRACE_ROUNDS = 2      # rounds of a traced run's window under the profiler


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _model_layout(parent: tuple) -> tuple:
    """("layers", block, proj) -> (block, proj)."""
    return tuple(parent[1:])


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.cfg, self.tr, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.fault = fault            # a test's planted fault, or None
        self.failures = []
        self.trace = None
        self.last = None              # the window's last round, on the host

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.configs import FLConfig, LoRAConfig
        from repro_torch.federation.server import FederatedLoRA
        from repro_torch.federation.topology import ClientRegistry
        from repro_torch.models.transformer import Model

        cfg, tr, dev = self.cfg, self.tr, self.device
        fed = cfg["federation"]
        self.levels = tuple(tr["rank_levels"])
        self.batch, self.steps = fed["local_batch_size"], tr["local_steps"]
        self.clients = fed["num_clients"]
        lora = LoRAConfig(rank_levels=self.levels,
                          rank_probs=tuple(tr["rank_probs"]))
        fl = FLConfig(num_clients=self.clients,
                      participation=tr["participation"],
                      local_batch_size=self.batch,
                      learning_rate=fed["learning_rate"],
                      lr_schedule=fed["lr_schedule"],
                      num_rounds=fed["num_rounds"], aggregator="raflora",
                      seed=tr["cohort_seed"], partition="dirichlet",
                      dirichlet_alpha=fed["dirichlet_alpha"])
        self.per_round = fl.clients_per_round
        model = Model(port.model_config(cfg), lora, device=dev, remat=False)
        shapes = {p: tuple(t.shape) for p, t in
                  workload.leaves(model.param_shapes()).items()}
        flat = workload.draw_tree(shapes, workload.generator(self.seed, 0,
                                                            dev),
                                  torch.float32, dev)
        self.base = workload.build({p: t for p, t in flat.items()
                                    if p[-1] not in ("lora_a", "lora_b")})
        self.global0 = self._lora_of(flat, clone=True)
        self.fingerprint = self._fingerprint()
        self.pool = workload.ImagePool(
            self.seed, cfg["num_labels"], fed["samples_per_class"],
            fed["pool_images_per_class"], cfg["tokens_per_image"],
            cfg["embed_dim"], dev)
        self.shards = workload.dirichlet_shards(
            self.seed, cfg["num_labels"], fed["samples_per_class"],
            self.clients, fed["dirichlet_alpha"])
        self.ranks = workload.client_ranks(tr["cohort_seed"], self.clients,
                                           self.levels, tr["rank_probs"])
        registry = ClientRegistry(ranks=self.ranks, shards=self.shards,
                                  rank_levels=self.levels)
        need = self.steps * self.batch
        pool, shards, b, steps = self.pool, self.shards, self.batch, \
            self.steps

        def batch_fn(cid, rng):
            ids = workload.draw_ids(shards[cid], need, rng)
            return [pool.batch(ids[i * b:(i + 1) * b]) for i in range(steps)]

        self.server = FederatedLoRA(
            model, fl, lora, registry, batch_fn,
            base_params=workload.build(flat), seed=tr["cohort_seed"],
            backend=fed["backend"], round_engine=fed["round_engine"])
        self.model = model
        if self.fault is not None:
            self.fault(self)
        self.captured = self._capture(tr["checked_rounds"])

    @staticmethod
    def _lora_of(flat: dict, clone: bool = False) -> dict:
        out = {}
        for path, t in flat.items():
            if path[-1] in ("lora_a", "lora_b"):
                key = _model_layout(path[:-1])
                out.setdefault(key, {})[path[-1][-1]] = (
                    t.detach().clone() if clone else t)
        return out

    def _fingerprint(self) -> float:
        return workload.fingerprint(self.base)

    def _capture(self, rounds: int) -> list:
        """Run ``rounds`` rounds keeping what each produced (on the host)."""
        s, model, trainer = self.server, self.model, self.server.trainer
        holder = {}

        def loss_wrap(orig):
            def fn(*a, **k):
                loss, metrics = orig(*a, **k)
                holder["losses"].append(
                    metrics["loss"].detach().double().cpu())
                return loss, metrics
            return fn

        def grads_wrap(orig):
            def fn(loss, leaves):
                g = orig(loss, leaves)
                if holder["grad_norms"] is None:
                    holder["grad_norms"] = {
                        p: t.detach().flatten(1).double().norm(dim=1).cpu()
                        for p, t in g.items()}
                return g
            return fn

        def train_wrap(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                holder["factors"] = [
                    (list(members), {p: (f[0].detach().cpu(),
                                         f[1].detach().cpu())
                                     for p, f in fs.items()})
                    for members, _, fs in out[0]]
                return out
            return fn

        def agg_wrap(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                holder["global"] = {p: (f[0].detach().cpu(),
                                        f[1].detach().cpu())
                                    for p, f in out[0].items()}
                return out
            return fn

        out = []
        with patched([(model, "train_loss_clients", loss_wrap),
                      (trainer, "_grads", grads_wrap),
                      (s, "_train_grouped", train_wrap),
                      (s, "_aggregate_grouped", agg_wrap)]):
            for _ in range(rounds):
                holder.clear()
                holder.update(losses=[], grad_norms=None)
                stats = s.run_round()
                holder.update(clients=list(stats.clients),
                              ranks=list(stats.ranks), lr=stats.lr)
                out.append(dict(holder))
        _sync()
        return out

    # -- the window -------------------------------------------------------------

    def window(self, seconds: float, trace: bool) -> dict:
        s = self.server
        rec = {"round_s": [], "train_flops": [], "plan_ms": [],
               "train_ms": [], "aggregate_ms": [], "k12_bound_s": 0.0,
               "traced_rounds": 0}
        stack = contextlib.ExitStack()
        if trace:
            stack.enter_context(self._instrument(rec))
        last = {}
        stack.enter_context(self._keep_last(last))
        tracer = None
        with stack:
            t0 = time.perf_counter()
            n = 0
            while True:
                if trace and n == 0:
                    from fedbench.trace import Tracer
                    tracer = Tracer(torch)
                    rec["tracing"] = True
                    with tracer:
                        t = time.perf_counter()
                        for _ in range(TRACE_ROUNDS):
                            self._round(rec, last)
                            n += 1
                        rec["traced_window_s"] = time.perf_counter() - t
                    rec["tracing"] = False
                    rec["traced_rounds"] = TRACE_ROUNDS
                else:
                    self._round(rec, last)
                    n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            rec["elapsed_s"] = time.perf_counter() - t0
        rec["rounds"] = n
        self.last = {k: _to_host(v) for k, v in last.items()}
        if tracer is not None:
            self.trace = tracer.read()
        return rec

    def _round(self, rec: dict, last: dict) -> None:
        t = time.perf_counter()
        last.clear()
        last["start"] = self._lora_of(
            workload.leaves(self.server.global_lora), clone=True)
        stats = self.server.run_round()
        _sync()
        rec["round_s"].append(time.perf_counter() - t)
        last.update(round=stats.round, clients=list(stats.clients))
        rec["train_flops"].append(counts.round_train_flops(
            self.cfg, self.batch, self.steps, stats.ranks))
        if not np.isfinite(stats.mean_client_loss):
            self.failures.append(f"round {stats.round}: loss "
                                 f"{stats.mean_client_loss}")

    @contextlib.contextmanager
    def _keep_last(self, last: dict):
        """Device copies of what each window round's training and
        aggregation produced, the previous round's dropped: each client's
        trained factors and last-step loss, and the global factors."""
        s = self.server

        def copies(fs):
            return {p: (f[0].detach().clone(), f[1].detach().clone())
                    for p, f in fs.items()}

        def train_wrap(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                last["factors"] = [(list(m), copies(fs))
                                   for m, _, fs in out[0]]
                last["loss"] = [(list(m), None if l is None
                                 else l.detach().clone())
                                for m, l in out[1]]
                return out
            return fn

        def agg_wrap(orig):
            def fn(*a, **k):
                out = orig(*a, **k)
                last["global"] = copies(out[0])
                return out
            return fn

        with patched([(s, "_train_grouped", train_wrap),
                      (s, "_aggregate_grouped", agg_wrap)]):
            yield

    @contextlib.contextmanager
    def _instrument(self, rec: dict):
        """The traced run's spans: CUDA events around the plan, train and
        aggregate stages, and host ranges around the K1/K2 entry and the
        Gram-core SVD, whose device time the trace then sums."""
        from torch.profiler import record_function
        from repro_torch.core import aggregation
        from repro_torch.kernels import ops
        s = self.server

        methods = {"plan_ms": "_plan_round", "train_ms": "_train_grouped",
                   "aggregate_ms": "_aggregate_grouped"}

        def stage(name):
            def make(fn):
                def wrapper(*a, **k):
                    _sync()
                    if not torch.cuda.is_available():
                        t = time.perf_counter()
                        out = fn(*a, **k)
                        rec[name].append((time.perf_counter() - t) * 1e3)
                        return out
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    with record_function("fedbench::" + name[:-3]):
                        out = fn(*a, **k)
                    ev[1].record()
                    ev[1].synchronize()
                    rec[name].append(ev[0].elapsed_time(ev[1]))
                    return out
                return wrapper
            return make

        def k12(orig):
            def fn(bs, as_, omega, global_b=None, global_a=None,
                   fallback=None):
                if rec.get("tracing"):
                    layers, m, d, r = bs.shape
                    rec["k12_bound_s"] += counts.k12_bound_s(
                        layers, m, d, as_.shape[-1], r, fallback is not None)
                with record_function("fedbench::k12"):
                    return orig(bs, as_, omega, global_b, global_a, fallback)
            return fn

        def svd(orig):
            def fn(*a, **k):
                with record_function("fedbench::svd"):
                    return orig(*a, **k)
            return fn

        with patched([(s, m, stage(n)) for n, m in methods.items()]
                     + [(ops, "factored_stack_gram_layered", k12),
                        (aggregation, "svd_realloc_gram", svd)]):
            yield

    # -- the check --------------------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.server = None
        self.model = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _indices(self) -> list:
        """The rounds the check compares: the checked ones, then the
        window's last."""
        out = list(range(self.tr["checked_rounds"]))
        if self.last:
            out.append(self.last["round"])
        return out

    def _plan(self):
        idx = self._indices()
        fed = self.cfg["federation"]
        plan = workload.plan_rounds(self.tr["cohort_seed"], idx[-1] + 1,
                                    self.clients, self.per_round,
                                    self.shards, self.steps * self.batch)
        lrs = [fed["learning_rate"] * max(1.0 - r / fed["num_rounds"], 0.0)
               for r in idx]
        return [plan[r] for r in idx], lrs

    def _batches(self, ids):
        out = []
        for i in range(self.steps):
            b = self.pool.batch(ids[i * self.batch:(i + 1) * self.batch])
            out.append({"embeds": torch.as_tensor(b["embeds"],
                                                  device=self.device),
                        "labels": torch.as_tensor(b["targets"][:, 0],
                                                  dtype=torch.long,
                                                  device=self.device)})
        return out

    def starts(self) -> list:
        """Each compared round's starting global factors: the benchmark's
        for the first, then the program's own after each checked round,
        then those the window's last round started from. The reference
        follows the program round by round: a rank-r_max cut of an update
        whose singular values lie close together at the cut turns under
        rounding, so two runs of the same rounds part ways in their
        factors while each round stays right."""
        out = [self.global0]
        for cap in self.captured[:-1]:
            out.append({_model_layout(p): {"a": b.mT.to(self.device),
                                           "b": a.mT.to(self.device)}
                        for p, (b, a) in cap["global"].items()})
        if self.last:
            out.append({k: {n: t.to(self.device) for n, t in f.items()}
                        for k, f in self.last["start"].items()})
        return out

    def reference(self, tf32: bool = False, half_batch: bool = False):
        plan, lrs = self._plan()
        n_of = {c: max(len(s), 1) for c, s in enumerate(self.shards)}
        return ref.run_rounds(self.cfg, self.base, self.starts(), plan,
                              self.ranks, n_of, lrs, self.levels,
                              self._batches, tf32=tf32,
                              half_batch=half_batch)

    def program_rounds(self) -> list:
        """The captured rounds, then the window's last, in the reference's
        form; of the window's round only each client's last-step loss is
        kept, and no gradient norm."""
        out = []
        for cap in self.captured:
            members, factors = cap["factors"][0]
            c = len(cap["clients"])
            order = list(members)
            losses = [[float(step[j]) for step in cap["losses"]]
                      for j in range(c)]
            norms = []
            for j in range(c):
                norms.append({_model_layout(p[:-1]) + (p[-1][-1],):
                              float(v[j])
                              for p, v in cap["grad_norms"].items()})
            loras = []
            for j in range(c):
                lo = {}
                for p, (bk, ak) in factors.items():
                    lo[_model_layout(p)] = {"a": bk[j].mT, "b": ak[j].mT}
                loras.append(lo)
            glob = {_model_layout(p): {"a": b.mT, "b": a.mT}
                    for p, (b, a) in cap["global"].items()}
            # stacked position j is sampled client order[j]
            inv = np.argsort(order)
            out.append({"clients": cap["clients"],
                        "losses": [losses[i] for i in inv],
                        "grad_norms": [norms[i] for i in inv],
                        "client_loras": [loras[i] for i in inv],
                        "global": glob})
        if self.last:
            out.append(self._window_round())
        return out

    def _window_round(self) -> dict:
        last = self.last
        c = len(last["clients"])
        losses, loras = [None] * c, [None] * c
        for members, loss in last["loss"]:
            for j, i in enumerate(members):
                if loss is not None:
                    losses[i] = [float(loss[j])]
        for members, factors in last["factors"]:
            for j, i in enumerate(members):
                loras[i] = {_model_layout(p): {"a": bk[j].mT, "b": ak[j].mT}
                            for p, (bk, ak) in factors.items()}
        return {"clients": last["clients"], "losses": losses,
                "grad_norms": [], "client_loras": loras,
                "global": {_model_layout(p): {"a": b.mT, "b": a.mT}
                           for p, (b, a) in last["global"].items()}}

    def numbers(self, prog: list, refr: list) -> dict:
        return compare(prog, refr, self.global0, self.device,
                       self.tr["checked_rounds"])

    def check(self) -> dict:
        """{number: value}: the program's captured rounds against the
        reference's; the base weights must be the inputs as made."""
        if abs(self._fingerprint() - self.fingerprint) > 0:
            self.failures.append("the base weights changed under the "
                                 "program")
        return self.numbers(self.program_rounds(), self.reference())


def _product(f: dict, dev) -> torch.Tensor:
    """B A in the paper's layout (L, in, out) from model-layout factors."""
    return f["a"].to(dev).float().mT @ f["b"].to(dev).float().mT


def _spectrum(f: dict, dev) -> torch.Tensor:
    """The singular values of B A (L, r), in f64 through both factors'
    QR: B A = Q1 (R1 R2^T) Q2^T."""
    _, r1 = torch.linalg.qr(f["a"].to(dev).double().mT)
    _, r2 = torch.linalg.qr(f["b"].to(dev).double())
    return torch.linalg.svdvals(r1 @ r2.mT)


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _rel(x, y) -> float:
    return float((x - y).norm() / y.norm().clamp(min=1e-30))


NUMBERS = ("loss", "grad", "client", "sigma", "approx", "change")


def compare(prog: list, refr: list, global0: dict, dev, checked: int
            ) -> dict:
    """The numbers compared, each the worst over the compared rounds (the
    ``checked`` rounds of the set-up, then any of the window), both sides
    starting each round from the same global factors:

    ``loss``: each client's loss at each local step, relative (where the
    program kept fewer steps, as of the window's round, its last ones);
    ``grad``: the first local step's gradient norm of each factor leaf, as
    the gap between the norms over the larger of the reference's norm and
    its median leaf's (leaves under a thousandth of the median left out);
    ``client``: each client's trained product B_k A_k of each adapter, the
    norm of the difference over the reference's;
    ``sigma``: the global product's singular values against the top
    r_max of the reference's update, each layer's over its largest;
    ``approx``: how much farther the global product lies from the
    reference's update dW than the reference's own rank-r_max cut, over
    the norm of dW, each layer (the cut's error moves only to second order
    where singular values at the cut lie close together, and the product
    itself turns there);
    ``change``: the global products' change over the checked rounds, the
    gap between the norms over the larger of the reference's and its
    median adapter's. The reference starts each round from the program's
    factors, so this reads the last checked round's part of the change
    against the first's start."""
    inf = float("inf")
    if [p["clients"] for p in prog] != [r["clients"] for r in refr]:
        return dict.fromkeys(NUMBERS, inf)
    out = dict.fromkeys(NUMBERS[:-1], 0.0)
    with ref.precision(False):
        for i, (p, r) in enumerate(zip(prog, refr)):
            for lp, lr in zip(p["losses"], r["losses"]):
                if lp is None or (len(lp) != len(lr) and not (
                        i >= checked and len(lp) == 1)):
                    out["loss"] = inf
                    continue
                for a, b in zip(lp, lr[len(lr) - len(lp):]):
                    out["loss"] = max(out["loss"], abs(a - b) / abs(b)
                                      if np.isfinite(a) else inf)
            for gp, gr in zip(p["grad_norms"], r["grad_norms"]):
                med = statistics.median(gr.values())
                for k, v in gr.items():
                    if v < 1e-3 * med:
                        continue
                    out["grad"] = max(out["grad"],
                                      abs(gp[k] - v) / max(v, med))
            for cp, cr in zip(p["client_loras"], r["client_loras"]):
                for k in cr:
                    out["client"] = max(out["client"], _rel(
                        _product(cp[k], dev), _product(cr[k], dev)))
            for k, g in r["global"].items():
                sp = _spectrum(p["global"][k], dev)
                sr = g["sigma"].double()
                out["sigma"] = max(out["sigma"], float(
                    ((sp - sr).abs() / sr[..., :1]).max()))
                dw = g["dw"].double()
                e_p = (dw - _product(p["global"][k], dev).double()
                       ).flatten(1).norm(dim=1)
                e_r = (dw - _product(g, dev).double()).flatten(1).norm(dim=1)
                out["approx"] = max(out["approx"], float(
                    ((e_p - e_r).abs() / dw.flatten(1).norm(dim=1)).max()))
        dn = {}
        for side, rounds in (("p", prog), ("r", refr)):
            for k in global0:
                d = (_product(rounds[checked - 1]["global"][k], dev)
                     - _product(global0[k], dev))
                dn[side, k] = float(d.norm())
        med = statistics.median(dn["r", k] for k in global0)
        out["change"] = max(abs(dn["p", k] - dn["r", k])
                            / max(dn["r", k], med) for k in global0)
    return {k: (v if np.isfinite(v) else inf) for k, v in out.items()}
