"""Federated server: Algorithm 1's round loop (port of
``repro/federation/server.py::FederatedLoRA``) without its sharded
engine, with three round engines:

* ``round_engine="batched"`` (default): all sampled clients train at once
  in the all-rank masked step, and every same-shape adapter is stacked
  into one (M, P, L, d, r) bucket and aggregated in one call;
* ``round_engine="sequential"``: the reference loop, one ``trainer.train``
  per client at its own rank and one ``aggregate_layer`` per adapter
  parent, kept to hold the batched engine to;
* ``round_engine="async"`` (DESIGN.md §6): FedBuff-style BUFFERED
  aggregation. Every round plans and trains one ``RoundPlan`` into a
  ``pipeline_depth``-deep buffer; when it fills, ONE staleness-discounted
  bucketed aggregation consumes every pending plan (plan age in rounds is
  its staleness, discounted by ``staleness_gamma**staleness``).
  ``pipeline_depth=1`` is the batched engine. With an ``event_scheduler``
  (DESIGN.md §7) arrival events on a deterministic virtual clock replace
  the cadence: triggers fire aggregations over exactly the updates that
  have arrived (partial cohorts ride the ``present`` mask), staleness is
  arrival-time-derived, and client lifecycle events reshape the sampling
  pool.

Every engine runs every method and backend of ``core.aggregation``, with
optional FactoredServerMomentum (``core/server_opt.py``) and compressed
uploads (``federation/transport.py``, dequantized once at stack-build
time). FLoRA folds its dW into the base weights. The plan stage consumes
the numpy rng in the reference's order, so both packages and every engine
sample the same clients and batches.

Round stats (client losses, the energy probe) are device tensors until
``flush_stats`` reads them: the synchronous engines flush at once, the
async engine keeps ``pipeline_depth - 1`` rounds unread, and between a
dispatch and the flush the buffered engines read nothing back from the
device themselves. ``save``/``restore`` write and read the reference's
checkpoint layout (``checkpointing/checkpoint.py``), so a checkpoint of
either package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, LoRAConfig
from repro_torch.core.aggregation import Aggregator
from repro_torch.core.energy import EnergyTrace
from repro_torch.core.lora import (adapter_parents, flatten, merge_lora,
                                   split_lora, unflatten)
from repro_torch.federation.client import LocalTrainer
from repro_torch.federation.topology import ClientRegistry
from repro_torch.federation.transport import (QuantFactor, TransportConfig,
                                              UpdateTransport, is_quantized)
from repro_torch.models.transformer import Model
from repro_torch.optim import get_schedule


@dataclass
class RoundStats:
    round: int
    clients: List[int]
    ranks: List[int]
    lr: float
    mean_client_loss: float
    sigma_probe: Optional[np.ndarray]  # singular values of probe adapter
    wall_time_s: float
    # event-driven engine: the virtual-clock time at the round's window end
    virtual_time: Optional[float] = None


def flatten_cohort(members, ranks, n_k, staleness=None, present=None,
                   r_min: int = 1):
    """Permute per-sampled-client vectors into stacked group-member order.
    ``members[j]`` is the sampled-client index at stacked position j, or
    -1 for a ghost: rank ``r_min``, zero samples, zero staleness, never
    present, so every weight it receives is exactly zero."""
    ranks_o = [ranks[i] if i >= 0 else r_min for i in members]
    n_k_o = [n_k[i] if i >= 0 else 0 for i in members]
    stal_o = (None if staleness is None else
              [staleness[i] if i >= 0 else 0 for i in members])
    pres_o = (None if present is None else
              [bool(present[i]) if i >= 0 else False for i in members])
    return ranks_o, n_k_o, stal_o, pres_o


@dataclass
class RoundPlan:
    """One round's sampled work order, carried between the stages.
    Everything rng-dependent is fixed at plan time; after training the
    plan carries the trained factor stacks and per-group loss tensors, so
    the async engine can buffer trained-but-unaggregated rounds."""

    round: int                 # the logical round this plan aggregates into
    version: int               # global model version when training ran
    clients: List[int]
    ranks: List[int]
    n_k: List[int]
    lr: float
    client_batches: Optional[list] = None
    group_factors: Optional[list] = None    # [(members, r_max, factors)]
    loss_parts: Optional[list] = None       # [(members, (C,) loss | None)]
    # sequential engine: per-client factor dicts and float losses
    client_factors: Optional[list] = None
    losses: Optional[list] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1 item 9)")


class FederatedLoRA:
    """End-to-end heterogeneous-rank FedLoRA server."""

    def __init__(self, model: Model, fl: FLConfig, lora: LoRAConfig,
                 registry: ClientRegistry,
                 batch_fn: Callable[[int, np.random.Generator], list],
                 *, base_params=None, seed: Optional[int] = None,
                 backend: str = "factored",
                 partial_up_to: Optional[int] = None,
                 server_momentum=None,
                 round_engine: str = "batched",
                 mesh=None,
                 pipeline_depth: int = 1,
                 staleness_gamma: float = 1.0,
                 event_scheduler=None,
                 transport=None):
        """batch_fn(client_id, rng) -> list of training batches (dicts of
        numpy arrays). ``base_params``: a full parameter tree (e.g. from
        ``repro_torch.convert``); None draws one from ``fl.seed`` on the
        model's device. ``server_momentum``: a FactoredServerMomentum or
        None. ``transport``: an UpdateTransport (or TransportConfig)
        compressing the uploads, None ships f32. ``pipeline_depth``,
        ``staleness_gamma`` and ``event_scheduler`` shape the async
        engine."""
        if round_engine == "sharded" or mesh is not None:
            raise _not_ported("the sharded engine (round_engine='sharded', "
                              "mesh=)")
        assert round_engine in ("batched", "sequential", "async"), \
            round_engine
        assert pipeline_depth >= 1, pipeline_depth
        assert 0.0 < staleness_gamma <= 1.0, staleness_gamma
        assert event_scheduler is None or round_engine == "async", \
            "event_scheduler rides round_engine='async'"
        self.round_engine = round_engine
        self.pipeline_depth = pipeline_depth if round_engine == "async" else 1
        self.staleness_gamma = staleness_gamma
        self.model = model
        self.device = model.device
        self.fl = fl
        self.lora_cfg = lora
        self.registry = registry
        self.batch_fn = batch_fn
        self.rng = np.random.default_rng(fl.seed if seed is None else seed)
        if base_params is None:
            gen = torch.Generator(device=self.device).manual_seed(fl.seed)
            base_params = model.init(gen)
        params = unflatten({p: x.to(self.device)
                            for p, x in flatten(base_params).items()})
        self.base, self.global_lora = split_lora(params)
        self.trainer = LocalTrainer(model, weight_decay=fl.weight_decay,
                                    freeze_a=(fl.aggregator == "ffa"))
        if isinstance(transport, TransportConfig):
            transport = UpdateTransport(transport)
        assert transport is None or isinstance(transport, UpdateTransport), \
            transport
        self.transport = transport
        self.server_momentum = server_momentum
        self.aggregator = Aggregator(fl.aggregator, lora.rank_levels,
                                     backend=backend,
                                     partial_up_to=partial_up_to)
        self.schedule = get_schedule(fl.lr_schedule, fl.learning_rate,
                                     fl.num_rounds)
        self.round_idx = 0
        self._plan_idx = 0
        self.adapter_version = 0
        self._post_aggregate_hooks: List[Callable] = []
        self.energy = EnergyTrace(lora.rank_levels)
        self.history: List[RoundStats] = []
        # async engine: FIFO of trained-but-unaggregated plans
        self._pending: "deque[RoundPlan]" = deque()
        # finalized rounds whose stats still hold unread device tensors
        self._stat_queue: deque = deque()
        self.event_scheduler = None
        if event_scheduler is not None:
            self.set_event_scheduler(event_scheduler)

    def set_event_scheduler(self, scheduler) -> None:
        """Attach an event scheduler before the first round (callers may
        read the registry first, e.g. to pick the straggler set)."""
        assert self.round_engine == "async", self.round_engine
        assert self.round_idx == 0 and not self._pending, \
            "attach the event scheduler before running rounds"
        self.event_scheduler = scheduler
        scheduler.bind_join_hook(self._apply_join)

    def _apply_join(self, ev) -> None:
        """Apply a "join" lifecycle event to the registry; idempotent, so
        replaying the lifecycle after a restore cannot double-register."""
        if ev.client < self.registry.num_clients:
            return
        assert ev.client == self.registry.num_clients, \
            (ev.client, self.registry.num_clients)
        assert ev.rank is not None and ev.shard is not None, ev
        self.registry.add_client(ev.rank, ev.shard)

    # -- adapter plumbing ---------------------------------------------------

    @staticmethod
    def _extract_factors(lora_tree: dict, rank: int) -> Dict[tuple, tuple]:
        """{adapter parent: (B (..., d_in, r_k), A (..., r_k, d_out))} in
        sorted-key (JAX pytree) order. Model layout: lora_a (..., r, in),
        lora_b (..., out, r); paper layout: B = lora_a^T, A = lora_b^T."""
        flat = flatten(lora_tree)
        out = {}
        for parent in adapter_parents(lora_tree):
            a_model = flat[parent + ("lora_a",)]
            b_model = flat[parent + ("lora_b",)]
            out[parent] = (a_model.mT[..., :rank],
                           b_model.mT[..., :rank, :])
        return out

    def _write_factors(self, results: Dict[tuple, tuple]) -> None:
        """Write the aggregated {adapter parent: (B_g (..., d, r),
        A_g (..., r, n))} back into the global lora tree, bump the adapter
        version and fire the hooks."""
        flat = flatten(self.global_lora)
        for parent, (b_g, a_g) in results.items():
            dt = flat[parent + ("lora_a",)].dtype
            flat[parent + ("lora_a",)] = b_g.mT.to(dt).contiguous()
            flat[parent + ("lora_b",)] = a_g.mT.to(dt).contiguous()
        self.global_lora = unflatten(flat)
        # hooks degrade to skip-and-warn: a failing subscriber must not
        # take down the round loop from inside its landing notification
        self.adapter_version += 1
        for hook in self._post_aggregate_hooks:
            try:
                hook(self.adapter_version, self.global_lora)
            except Exception as e:  # noqa: BLE001 -- hooks are best-effort
                warnings.warn(
                    f"post-aggregate hook {hook!r} failed at adapter "
                    f"version {self.adapter_version} ({e}); skipping",
                    RuntimeWarning, stacklevel=2)

    def add_post_aggregate_hook(self, hook) -> None:
        """Register ``hook(adapter_version, global_lora)`` for every
        aggregation landing, in every engine."""
        self._post_aggregate_hooks.append(hook)

    def _merge_flora_delta(self, deltas: Dict[tuple, torch.Tensor]) -> None:
        """FLoRA: fold each dW (paper layout (..., d_in, d_out)) into its
        parent's base weight ``w`` (..., in, out), in f32."""
        flat = flatten(self.base)
        for parent, dw in deltas.items():
            w = flat[parent + ("w",)]
            flat[parent + ("w",)] = (w.float() + dw.float()).to(w.dtype)
        self.base = unflatten(flat)

    # -- local training -------------------------------------------------------

    def _stack_batches(self, batches: list) -> dict:
        return {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                                   device=self.device)
                for k in batches[0]}

    def _train_sequential(self, client_batches, ranks, lr, clients):
        """TRAIN, sequential engine: one ``trainer.train`` call per sampled
        client at its own rank; factors sliced to that rank (and encoded
        by the transport, if any)."""
        client_factors, losses = [], []
        for batches, rank, cid in zip(client_batches, ranks, clients):
            trained, metrics = self.trainer.train(
                self.base, self.global_lora, rank, batches, lr)
            factors = self._extract_factors(trained, rank)
            if self.transport is not None:
                factors = self.transport.encode_client(cid, factors)
            client_factors.append(factors)
            loss = metrics.get("loss")
            losses.append(float("nan") if loss is None else float(loss))
        return client_factors, losses

    def _train_grouped(self, client_batches, ranks, lr, clients):
        """TRAIN: one masked multi-client run per step-count group (step
        counts are homogeneous in the common case). Factors stay stacked
        over each group's client axis, zero beyond each client's rank;
        with a transport each group's upload is encoded under the clients'
        GLOBAL ids (quantization keeps the zero columns zero: scale 0)."""
        groups: Dict[int, List[int]] = {}
        for i, batches in enumerate(client_batches):
            groups.setdefault(len(batches), []).append(i)
        group_factors, loss_parts = [], []
        r_max = self.lora_cfg.r_max
        for steps, members in sorted(groups.items()):
            stacks = [self._stack_batches([client_batches[i][t]
                                           for i in members])
                      for t in range(steps)]
            lora_g, metrics = self.trainer.train_group_masked(
                self.base, self.global_lora, [ranks[i] for i in members],
                stacks, lr)
            factors = self._extract_factors(lora_g, r_max)
            if self.transport is not None:
                factors = self.transport.encode_group(
                    [clients[i] for i in members], factors)
            group_factors.append((members, r_max, factors))
            loss_parts.append((members, metrics.get("loss")))
        return group_factors, loss_parts

    @staticmethod
    def _losses_from_parts(loss_parts, num_clients: int) -> List[float]:
        """Per-group (C,) losses -> floats in sampled-client order (ghost
        losses dropped): the train stage's device read, done at flush."""
        losses = [float("nan")] * num_clients
        for members, loss_g in loss_parts:
            if loss_g is None:
                continue
            vals = loss_g.detach().cpu().numpy()
            for j, i in enumerate(members):
                if i >= 0:
                    losses[i] = float(vals[j])
        return losses

    # -- aggregation ---------------------------------------------------------

    def _aggregate_sequential(self, client_factors, ranks, n_k):
        """AGGREGATE, sequential engine: one ``aggregate_layer`` call per
        adapter parent (scan-stacked (L, d, r) factors stay stacked)."""
        results, deltas, sigmas = {}, {}, {}
        global_factors = self._extract_factors(self.global_lora,
                                               self.lora_cfg.r_max)
        parents = list(client_factors[0])
        for parent in parents:
            g_b, g_a = global_factors[parent]
            res = self.aggregator.aggregate_layer(
                [cf[parent] for cf in client_factors], ranks, n_k,
                global_b=g_b, global_a=g_a)
            self._record_result(parent, (g_b, g_a), res, results, deltas,
                                sigmas)
        return results, deltas, self._sigma_probe(parents, sigmas)

    def _record_result(self, parent, global_pair, res, results, deltas,
                       sigmas) -> None:
        if self.server_momentum is not None:
            results[parent] = self.server_momentum.apply(
                parent, global_pair, (res.b_g, res.a_g), self.lora_cfg.r_max)
        else:
            results[parent] = (res.b_g, res.a_g)
        if res.merge_delta is not None:
            deltas[parent] = res.merge_delta
        if res.sigma is not None:
            sigmas[parent] = res.sigma

    @staticmethod
    def _sigma_probe(parents, sigmas) -> Optional[torch.Tensor]:
        """The energy probe: the first adapter's spectrum, (r,) or
        (L, r) for scan-stacked layers, unread."""
        for parent in parents:
            if parent in sigmas:
                return sigmas[parent]
        return None

    def _aggregate_grouped(self, group_factors, ranks, n_k, *,
                           staleness=None, present=None):
        """AGGREGATE, batched and async engines: bucket adapters by factor
        shape (first-seen, i.e. sorted-key, order) and aggregate each
        bucket in one call, then (if configured) its server momentum in
        one ``apply_bucket``. ``staleness``: per-sampled-client ages (async
        engine); ``present``: per-sampled-client arrival mask (event
        engine). The energy probe is the FIRST adapter's spectrum."""
        results, deltas = {}, {}
        sigma_probe = None
        r_max = self.lora_cfg.r_max
        global_factors = self._extract_factors(self.global_lora, r_max)
        members = [i for mem, _, _ in group_factors for i in mem]
        ranks_o, n_k_o, stal_o, pres_o = flatten_cohort(
            members, ranks, n_k, staleness, present,
            min(self.lora_cfg.rank_levels))
        buckets: Dict[tuple, List[tuple]] = {}
        for parent in group_factors[0][2]:
            gb0, ga0 = global_factors[parent]
            buckets.setdefault((tuple(gb0.shape), tuple(ga0.shape)),
                               []).append(parent)
        for group in buckets.values():
            res = self.aggregator.aggregate_grouped(
                [[fg[p][0] for p in group] for _, _, fg in group_factors],
                [[fg[p][1] for p in group] for _, _, fg in group_factors],
                ranks_o, n_k_o,
                global_bs=[global_factors[p][0] for p in group],
                global_as=[global_factors[p][1] for p in group],
                staleness=stal_o, gamma=self.staleness_gamma,
                present=pres_o)
            b_new, a_new = res.b_g, res.a_g
            if self.server_momentum is not None:
                b_new, a_new = self.server_momentum.apply_bucket(
                    tuple(group), [global_factors[p] for p in group],
                    b_new, a_new, r_max)
            for j, parent in enumerate(group):
                results[parent] = (b_new[j], a_new[j])
                if res.merge_delta is not None:
                    deltas[parent] = res.merge_delta[j]
            if res.sigma is not None and sigma_probe is None:
                sigma_probe = res.sigma[0]
        return results, deltas, sigma_probe

    # -- the round: plan -> train -> aggregate stages ------------------------

    def _now(self) -> float:
        """The round-stat clock: the VIRTUAL clock with an event scheduler
        (the event path never reads the host clock, so a run is a function
        of its seed), wall time otherwise."""
        if self.event_scheduler is not None:
            return self.event_scheduler.clock.now
        return time.time()

    def _plan_round(self) -> RoundPlan:
        """PLAN: sample clients/ranks/n_k/lr and draw the data batches, in
        the reference's rng order (one ``sample_round``, then one
        ``batch_fn`` per client). With an event scheduler the sample comes
        from the active pool; without lifecycle events ``active`` is None
        and the rng stream is the cadence engines'."""
        fl = self.fl
        active = (None if self.event_scheduler is None else
                  self.event_scheduler.active_clients(
                      self.registry.num_clients))
        clients = self.registry.sample_round(fl.clients_per_round, self.rng,
                                             active=active).tolist()
        plan = RoundPlan(
            round=self._plan_idx, version=self.round_idx, clients=clients,
            ranks=[int(self.registry.ranks[c]) for c in clients],
            n_k=[max(self.registry.num_samples(c), 1) for c in clients],
            lr=self.schedule(self._plan_idx),
            client_batches=[self.batch_fn(cid, self.rng) for cid in clients])
        self._plan_idx += 1
        return plan

    def _train_stage(self, plan: RoundPlan) -> None:
        """TRAIN stage of any engine; frees the plan's batches."""
        if self.round_engine == "sequential":
            plan.client_factors, plan.losses = self._train_sequential(
                plan.client_batches, plan.ranks, plan.lr, plan.clients)
        else:
            plan.group_factors, plan.loss_parts = self._train_grouped(
                plan.client_batches, plan.ranks, plan.lr, plan.clients)
        plan.client_batches = None

    def _aggregate_stage(self, plan: RoundPlan):
        """AGGREGATE stage of a synchronous engine: (results, deltas,
        probe)."""
        if self.round_engine == "sequential":
            return self._aggregate_sequential(plan.client_factors,
                                              plan.ranks, plan.n_k)
        return self._aggregate_grouped(plan.group_factors, plan.ranks,
                                       plan.n_k)

    def _finalize_round(self, plan: RoundPlan, results, deltas, sigma_probe,
                        t0: float) -> RoundStats:
        """Write back the aggregate (``results=None`` on buffer-fill
        rounds), record the round and queue its unread stats: the
        synchronous engines flush at once, the async engine keeps
        ``pipeline_depth - 1`` rounds queued. The returned RoundStats is
        completed IN PLACE at its flush; ``run``, ``save`` and
        ``drain_pending`` flush everything."""
        if results is not None:
            self._write_factors(results)
        if deltas:
            self._merge_flora_delta(deltas)
        stats = RoundStats(
            round=plan.round, clients=plan.clients, ranks=plan.ranks,
            lr=plan.lr, mean_client_loss=float("nan"), sigma_probe=None,
            wall_time_s=self._now() - t0)
        self.history.append(stats)
        self.round_idx += 1
        self._stat_queue.append((stats, plan, sigma_probe))
        self.flush_stats(keep=(self.pipeline_depth - 1
                               if self.round_engine == "async" else 0))
        return stats

    @staticmethod
    def _materialize_probe(sigma_probe) -> Optional[np.ndarray]:
        """One device read of a probe: (r,) as is, (L, r) layer-averaged."""
        if sigma_probe is None:
            return None
        arr = sigma_probe.detach().cpu().numpy()
        return arr if arr.ndim == 1 else arr.mean(axis=0)

    def flush_stats(self, keep: int = 0) -> None:
        """Read queued round stats (oldest first) until at most ``keep``
        remain: losses -> mean client loss, probe -> energy trace and the
        round's entry. An event round may carry a LIST of probes (several
        fires in one window): each enters the energy trace, the round
        keeps the last. The only place the buffered engines read the
        device."""
        while len(self._stat_queue) > keep:
            stats, plan, sigma_probe = self._stat_queue.popleft()
            probes = (sigma_probe if isinstance(sigma_probe, list)
                      else [sigma_probe])
            for handle in probes:
                probe = self._materialize_probe(handle)
                if probe is not None:
                    self.energy.record(probe)
                    stats.sigma_probe = probe
            losses = (plan.losses if plan.losses is not None
                      else self._losses_from_parts(plan.loss_parts,
                                                   len(plan.ranks)))
            # nanmean: a zero-batch client reports NaN, which must not
            # poison the round's stat
            arr = np.asarray(losses, dtype=np.float64)
            stats.mean_client_loss = (
                float(np.nanmean(arr)) if not np.all(np.isnan(arr))
                else float("nan"))

    def run_round(self) -> RoundStats:
        if self.round_engine == "async":
            return self._run_round_async()
        t0 = self._now()
        plan = self._plan_round()
        self._train_stage(plan)
        results, deltas, sigma_probe = self._aggregate_stage(plan)
        return self._finalize_round(plan, results, deltas, sigma_probe, t0)

    def _run_round_async(self) -> RoundStats:
        """One async round: plan and train this round into the buffer, and
        run ONE buffered aggregation when ``pipeline_depth`` plans are
        pending (plan age in rounds = staleness, 0..depth-1). Buffer-fill
        rounds report losses only; probes come with aggregations. With an
        event scheduler, arrival events replace the cadence."""
        if self.event_scheduler is not None:
            return self._run_round_event()
        t0 = self._now()
        plan = self._plan_round()
        self._train_stage(plan)
        self._pending.append(plan)
        results, deltas, sigma_probe = None, None, None
        if len(self._pending) >= self.pipeline_depth:
            results, deltas, sigma_probe = self._aggregate_buffer(plan.round)
        return self._finalize_round(plan, results, deltas, sigma_probe, t0)

    # -- event-driven async rounds (DESIGN.md §7) ----------------------------

    def _run_round_event(self) -> RoundStats:
        """One event round: plan and train at the current virtual time,
        register the clients' arrivals, then advance the clock one
        ``round_interval``; every trigger fire aggregates exactly the
        arrived-but-unaggregated updates and applies them at once."""
        t0 = self._now()
        sched = self.event_scheduler
        plan = self._plan_round()
        self._train_stage(plan)
        self._pending.append(plan)
        sched.dispatch(plan.round, plan.clients)
        probes = []
        for fire_time in sched.advance_window():
            probe = self._fire_aggregation(fire_time)
            if probe is not None:
                probes.append(probe)
        self._retire_completed()
        stats = self._finalize_round(plan, None, None, probes or None, t0)
        stats.virtual_time = sched.clock.now
        return stats

    def _fire_aggregation(self, fire_time: float):
        """Aggregate and apply every arrived-but-unaggregated update at one
        fire; returns the unread probe, or None if nothing was buffered."""
        results, deltas, sigma_probe = self._aggregate_arrivals(fire_time)
        if results is None:
            return None
        self._write_factors(results)
        if deltas:
            self._merge_flora_delta(deltas)
        return sigma_probe

    def _aggregate_arrivals(self, fire_time: float):
        """Merge the pending plans with ready members into one bucketed
        step: full factor stacks with a ``present`` mask (a plan may be
        consumed over several fires, each member once) and
        arrival-time-derived staleness."""
        sched = self.event_scheduler
        ready = sched.take_ready()
        plans = [p for p in self._pending if p.round in ready]
        if not plans:
            return None, None, None
        ranks, n_k, group_factors = self._merge_plan_groups(plans)
        staleness, present = [], []
        for p in plans:
            arrived = ready[p.round]
            for j in range(len(p.clients)):
                present.append(j in arrived)
                staleness.append(sched.staleness_of(fire_time, arrived[j])
                                 if j in arrived else 0)
        return self._aggregate_grouped(group_factors, ranks, n_k,
                                       staleness=staleness, present=present)

    def _retire_completed(self) -> None:
        """Drop pending plans whose every member was aggregated or lost to
        a dropout (their loss tensors stay on the stat queue)."""
        done = set(self.event_scheduler.completed_plans())
        if not done:
            return
        for p in self._pending:
            if p.round in done:
                p.group_factors = None
                self.event_scheduler.forget_plan(p.round)
        self._pending = deque(p for p in self._pending
                              if p.round not in done)

    @staticmethod
    def _merge_plan_groups(plans):
        """Merge pending plans' rank groups onto ONE sampled-client axis:
        member indices rebase by each plan's offset (ghosts stay -1). The
        one rebase rule of the cadence buffer and the event arrivals."""
        ranks = [r for p in plans for r in p.ranks]
        n_k = [n for p in plans for n in p.n_k]
        group_factors, off = [], 0
        for p in plans:
            group_factors += [
                ([m + off if m >= 0 else -1 for m in mem], r_max, fg)
                for mem, r_max, fg in p.group_factors]
            off += len(p.clients)
        return ranks, n_k, group_factors

    def _aggregate_buffer(self, as_of_round: int):
        """Aggregate EVERY pending plan in one staleness-discounted
        bucketed step (staleness = ``as_of_round`` - plan round)."""
        plans = list(self._pending)
        self._pending.clear()
        ranks, n_k, group_factors = self._merge_plan_groups(plans)
        staleness = [as_of_round - p.round for p in plans for _ in p.clients]
        out = self._aggregate_grouped(group_factors, ranks, n_k,
                                      staleness=staleness)
        for p in plans:
            p.group_factors = None   # consumed; the stat queue keeps losses
        return out

    def drain_pending(self) -> Optional[np.ndarray]:
        """Aggregate a partly filled buffer now (e.g. before a final
        evaluation). No round is recorded; the aggregate updates the
        global model, the energy trace and the last history entry's probe,
        which is returned (None if nothing was pending). Event engine: the
        remaining arrivals play out (triggers still fire), then whatever
        is buffered is force-aggregated at the final virtual time."""
        if self.event_scheduler is not None:
            self.flush_stats()   # queued probes precede the drain's fires
            probe = None
            for fire_time in self.event_scheduler.drain():
                p = self._materialize_probe(self._fire_aggregation(fire_time))
                if p is not None:
                    self.energy.record(p)
                    probe = p
            self._retire_completed()
            if probe is not None and self.history:
                self.history[-1].sigma_probe = probe
            return probe
        if not self._pending:
            return None
        results, deltas, sigma_probe = self._aggregate_buffer(
            self._pending[-1].round)
        self._write_factors(results)
        if deltas:
            self._merge_flora_delta(deltas)
        self.flush_stats()
        probe = self._materialize_probe(sigma_probe)
        if probe is not None:
            self.energy.record(probe)
            if self.history:
                self.history[-1].sigma_probe = probe
        return probe

    def run(self, rounds: Optional[int] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 10) -> List[RoundStats]:
        rounds = rounds if rounds is not None else self.fl.num_rounds
        for _ in range(rounds):
            self.run_round()
            if eval_fn is not None and self.round_idx % eval_every == 0:
                self.flush_stats()      # eval callbacks see complete history
                eval_fn(self)
        self.flush_stats()
        return self.history

    # -- evaluation / state --------------------------------------------------

    def global_params(self) -> dict:
        return merge_lora(self.base, self.global_lora)

    @torch.no_grad()
    def evaluate(self, batch: dict) -> dict:
        _, metrics = self.model.train_loss(self.global_params(), batch,
                                           lora_rank=self.lora_cfg.r_max)
        return {k: float(v) for k, v in metrics.items()}

    @staticmethod
    def _stats_to_meta(s: RoundStats) -> dict:
        d = dataclasses.asdict(s)
        if d["sigma_probe"] is not None:
            d["sigma_probe"] = np.asarray(d["sigma_probe"]).tolist()
        return d

    @staticmethod
    def _stats_from_meta(d: dict) -> RoundStats:
        d = dict(d)
        if d.get("sigma_probe") is not None:
            d["sigma_probe"] = np.asarray(d["sigma_probe"], np.float32)
        return RoundStats(**d)

    # -- pending-plan (de)serialization: the async engine's buffer ----------
    #
    # A pending plan trained against globals that may be gone by save time,
    # so its trained factor stacks themselves are checkpointed, under the
    # reference's keys: "g{gi}/P/{adapter path}/b|a" for f32 factors,
    # "bq"/"bs" and "aq"/"as" leaves (payload and scales) for quantized
    # ones, "g{gi}/loss" for a group's losses. A bf16 payload is stored as
    # its raw 2-byte words (numpy has no bfloat16; the reference's file
    # holds the same bytes).

    @staticmethod
    def _payload_array(q: torch.Tensor) -> np.ndarray:
        if q.dtype == torch.bfloat16:
            return q.detach().cpu().view(torch.int16).numpy().view("V2")
        return q.detach().cpu().numpy()

    def _payload_tensor(self, arr: np.ndarray) -> torch.Tensor:
        if arr.dtype == np.dtype("V2"):
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(self.device)
        return torch.as_tensor(arr, device=self.device)

    @classmethod
    def _factor_arrays(cls, arrays: Dict[str, np.ndarray], key: str, val,
                       leaf: str) -> None:
        if is_quantized(val):
            arrays[f"{key}/{leaf}q"] = cls._payload_array(val.q)
            arrays[f"{key}/{leaf}s"] = val.scale.detach().cpu().numpy()
        else:
            arrays[f"{key}/{leaf}"] = val.detach().cpu().numpy()

    @classmethod
    def _plan_arrays(cls, plan: RoundPlan) -> Dict[str, np.ndarray]:
        arrays: Dict[str, np.ndarray] = {}
        for gi, (_, _, factors) in enumerate(plan.group_factors):
            for parent, (b, a) in factors.items():
                key = f"g{gi}/P/" + "/".join(parent)
                cls._factor_arrays(arrays, key, b, "b")
                cls._factor_arrays(arrays, key, a, "a")
        for gi, (_, loss_g) in enumerate(plan.loss_parts):
            if loss_g is not None:
                arrays[f"g{gi}/loss"] = loss_g.detach().cpu().numpy()
        return arrays

    @staticmethod
    def _plan_meta(plan: RoundPlan) -> dict:
        return {"round": plan.round, "version": plan.version,
                "clients": plan.clients, "ranks": plan.ranks,
                "n_k": plan.n_k, "lr": plan.lr,
                "groups": [{"members": list(members), "r_max": r_max}
                           for members, r_max, _ in plan.group_factors]}

    def _plan_from_arrays(self, meta: dict, arrays: Dict[str, np.ndarray]
                          ) -> RoundPlan:
        group_factors, loss_parts = [], []
        for gi, g in enumerate(meta["groups"]):
            prefix = f"g{gi}/P/"
            pairs: Dict[tuple, dict] = {}
            for key, arr in arrays.items():
                if key.startswith(prefix):
                    path, leaf = key[len(prefix):].rsplit("/", 1)
                    pairs.setdefault(tuple(path.split("/")), {})[leaf] = arr
            factors = {}
            for parent, ba in pairs.items():
                factors[parent] = tuple(
                    QuantFactor(self._payload_tensor(ba[f + "q"]),
                                torch.as_tensor(ba[f + "s"],
                                                device=self.device))
                    if f + "q" in ba else
                    torch.as_tensor(ba[f], device=self.device)
                    for f in ("b", "a"))
            members = [int(m) for m in g["members"]]
            group_factors.append((members, int(g["r_max"]), factors))
            loss = arrays.get(f"g{gi}/loss")
            loss_parts.append((members, None if loss is None else
                               torch.as_tensor(loss, device=self.device)))
        return RoundPlan(
            round=int(meta["round"]), version=int(meta["version"]),
            clients=[int(c) for c in meta["clients"]],
            ranks=[int(r) for r in meta["ranks"]],
            n_k=[int(n) for n in meta["n_k"]], lr=float(meta["lr"]),
            group_factors=group_factors, loss_parts=loss_parts)

    def save(self, path: str) -> None:
        """Checkpoint the whole server state: base and global adapters,
        the rng stream, energy trace and history, momentum, the transport's
        residuals, the async buffer's trained plans and the event
        scheduler (the reference's files and keys)."""
        from repro_torch.checkpointing.checkpoint import save_flat, save_pytree
        self.flush_stats()      # checkpointed history/energy are complete
        save_pytree(path + ".base", self.base)
        meta = {"round": self.round_idx,
                "adapter_version": self.adapter_version,
                "method": self.fl.aggregator,
                "rng_state": self.rng.bit_generator.state,
                "energy": self.energy.state_dict(),
                "history": [self._stats_to_meta(s) for s in self.history]}
        if self.server_momentum is not None and self.server_momentum.state:
            save_flat(path + ".momentum",
                      self.server_momentum.state_arrays())
            meta["momentum"] = True
        if self.transport is not None:
            save_flat(path + ".transport", self.transport.state_arrays())
            meta["transport"] = True
        if self._pending:
            meta["pending"] = [self._plan_meta(p) for p in self._pending]
            for i, plan in enumerate(self._pending):
                save_flat(path + f".pending{i}", self._plan_arrays(plan))
        if self.event_scheduler is not None:
            meta["events"] = self.event_scheduler.state_dict()
        save_pytree(path + ".lora", self.global_lora, metadata=meta)

    def restore(self, path: str) -> None:
        """Reset the server to a checkpoint of either package: in-flight
        state (queued stats, pending plans, momentum, residuals) always
        comes from the checkpoint, never from before the restore."""
        from repro_torch.checkpointing.checkpoint import (load_flat,
                                                          load_metadata,
                                                          load_pytree)
        self.base = load_pytree(path + ".base", self.base)
        self.global_lora = load_pytree(path + ".lora", self.global_lora)
        self._stat_queue.clear()
        self._pending.clear()
        if self.server_momentum is not None:
            self.server_momentum.state = None
        if self.transport is not None:
            self.transport.reset()
        meta = load_metadata(path + ".lora")
        if meta:
            self.round_idx = meta.get("round", self.round_idx)
            self.adapter_version = meta.get("adapter_version",
                                            self.adapter_version)
            if meta.get("rng_state") is not None:
                # in place on the server's seeded stream
                self.rng.bit_generator.state = meta["rng_state"]
            if meta.get("energy") is not None:
                self.energy = EnergyTrace.from_state(meta["energy"])
            if meta.get("history") is not None:
                self.history = [self._stats_from_meta(d)
                                for d in meta["history"]]
            if meta.get("momentum") and self.server_momentum is not None:
                self.server_momentum.load_state_arrays(
                    load_flat(path + ".momentum"), device=self.device)
            if self.transport is not None:
                if meta.get("transport"):
                    self.transport.load_state_arrays(
                        load_flat(path + ".transport"))
                else:
                    # a checkpoint from before the transport: resume with
                    # zero residuals (the telescoping restarts at e_0 = 0)
                    warnings.warn(
                        "checkpoint predates the compressed update "
                        "transport; error-feedback accumulators "
                        "initialize to zero", RuntimeWarning,
                        stacklevel=2)
            for i, pm in enumerate(meta.get("pending") or []):
                self._pending.append(self._plan_from_arrays(
                    pm, load_flat(path + f".pending{i}")))
            if self.event_scheduler is not None:
                # the checkpoint's event state (pristine if it had none);
                # replays applied "join" events into the registry
                self.event_scheduler.load_state_dict(meta.get("events"))
            else:
                # resuming an event run without a scheduler would redraw
                # latencies and fire on the wrong cadence
                assert meta.get("events") is None, \
                    ("checkpoint carries event-scheduler state; attach an "
                     "EventScheduler before restore()")
        # pending plans belong to rounds already counted
        self._plan_idx = self.round_idx
