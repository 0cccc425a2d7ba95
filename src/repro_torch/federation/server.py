"""Federated server: Algorithm 1's round loop (port of
``repro/federation/server.py::FederatedLoRA``), with two round engines:

* ``round_engine="batched"`` (default): all sampled clients train at once
  in the all-rank masked step, and every same-shape adapter is stacked
  into one (M, P, L, d, r) bucket and aggregated in one call;
* ``round_engine="sequential"``: the reference loop, one ``trainer.train``
  per client at its own rank and one ``aggregate_layer`` per adapter
  parent, kept to hold the batched engine to.

Either engine runs every method and backend of ``core.aggregation``. FLoRA
folds its dW into the base weights. The plan stage consumes the numpy rng
in the reference's order, so both packages and both engines sample the
same clients and batches.
"""
from __future__ import annotations

import time
import warnings
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


@dataclass
class RoundPlan:
    """One round's sampled work order, carried between the stages."""

    round: int
    clients: List[int]
    ranks: List[int]
    n_k: List[int]
    lr: float
    client_batches: Optional[list] = None
    group_factors: Optional[list] = None    # [(members, r_max, factors)]
    loss_parts: Optional[list] = None       # [(members, (C,) loss)]
    # sequential engine: per-client factor dicts and float losses
    client_factors: Optional[list] = None
    losses: Optional[list] = None


_ENGINE_ITEMS = {"sharded": 9, "async": 8}


class FederatedLoRA:
    """End-to-end heterogeneous-rank FedLoRA server."""

    def __init__(self, model: Model, fl: FLConfig, lora: LoRAConfig,
                 registry: ClientRegistry,
                 batch_fn: Callable[[int, np.random.Generator], list],
                 *, base_params=None, seed: Optional[int] = None,
                 backend: str = "factored",
                 partial_up_to: Optional[int] = None,
                 round_engine: str = "batched"):
        """batch_fn(client_id, rng) -> list of training batches (dicts of
        numpy arrays). ``base_params``: a full parameter tree (e.g. from
        ``repro_torch.convert``); None draws one from ``fl.seed`` on the
        model's device."""
        if round_engine not in ("batched", "sequential"):
            item = _ENGINE_ITEMS.get(round_engine)
            raise NotImplementedError(
                f"round_engine={round_engine!r} is not ported yet"
                + (f" (ROADMAP.md queue 1 item {item})" if item else ""))
        self.round_engine = round_engine
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
        aggregation landing."""
        self._post_aggregate_hooks.append(hook)

    def _merge_flora_delta(self, deltas: Dict[tuple, torch.Tensor]) -> None:
        """FLoRA: fold each dW (paper layout (..., d_in, d_out)) into its
        parent's base weight ``w`` (..., in, out), in f32."""
        flat = flatten(self.base)
        for parent, dw in deltas.items():
            w = flat[parent + ("w",)]
            flat[parent + ("w",)] = (w.float() + dw.float()).to(w.dtype)
        self.base = unflatten(flat)

    # -- round stages ----------------------------------------------------------

    def _plan_round(self) -> RoundPlan:
        """PLAN: sample clients/ranks/n_k/lr and draw the data batches, in
        the reference's rng order (one ``sample_round``, then one
        ``batch_fn`` per client)."""
        fl = self.fl
        clients = self.registry.sample_round(fl.clients_per_round,
                                             self.rng).tolist()
        plan = RoundPlan(
            round=self._plan_idx, clients=clients,
            ranks=[int(self.registry.ranks[c]) for c in clients],
            n_k=[max(self.registry.num_samples(c), 1) for c in clients],
            lr=self.schedule(self._plan_idx),
            client_batches=[self.batch_fn(cid, self.rng) for cid in clients])
        self._plan_idx += 1
        return plan

    def _stack_batches(self, batches: list) -> dict:
        return {k: torch.as_tensor(np.stack([b[k] for b in batches]),
                                   device=self.device)
                for k in batches[0]}

    def _train_sequential(self, client_batches, ranks, lr):
        """TRAIN, sequential engine: one ``trainer.train`` call per sampled
        client at its own rank; factors sliced to that rank."""
        client_factors, losses = [], []
        for batches, rank in zip(client_batches, ranks):
            trained, metrics = self.trainer.train(
                self.base, self.global_lora, rank, batches, lr)
            client_factors.append(self._extract_factors(trained, rank))
            loss = metrics.get("loss")
            losses.append(float("nan") if loss is None else float(loss))
        return client_factors, losses

    def _train_grouped(self, client_batches, ranks, lr):
        """TRAIN: one masked multi-client run per step-count group (step
        counts are homogeneous in the common case). Factors stay stacked
        over each group's client axis, zero beyond each client's rank."""
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
            group_factors.append(
                (members, r_max, self._extract_factors(lora_g, r_max)))
            loss_parts.append((members, metrics.get("loss")))
        return group_factors, loss_parts

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
            self._record_result(parent, res, results, deltas, sigmas)
        return results, deltas, self._sigma_probe(parents, sigmas)

    @staticmethod
    def _record_result(parent, res, results, deltas, sigmas) -> None:
        results[parent] = (res.b_g, res.a_g)
        if res.merge_delta is not None:
            deltas[parent] = res.merge_delta
        if res.sigma is not None:
            sigmas[parent] = res.sigma

    @staticmethod
    def _sigma_probe(parents, sigmas) -> Optional[torch.Tensor]:
        """The energy probe: the first adapter's spectrum, (r,) or
        (L, r) for scan-stacked layers."""
        for parent in parents:
            if parent in sigmas:
                return sigmas[parent]
        return None

    def _aggregate_grouped(self, group_factors, ranks, n_k):
        """AGGREGATE, batched engine: bucket adapters by factor shape
        (first-seen, i.e. sorted-key, order) and aggregate each bucket in
        one call. The energy probe is the FIRST adapter's spectrum."""
        results, deltas = {}, {}
        sigma_probe = None
        r_max = self.lora_cfg.r_max
        global_factors = self._extract_factors(self.global_lora, r_max)
        members = [i for mem, _, _ in group_factors for i in mem]
        ranks_o = [ranks[i] for i in members]
        n_k_o = [n_k[i] for i in members]
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
                global_as=[global_factors[p][1] for p in group])
            for j, parent in enumerate(group):
                results[parent] = (res.b_g[j], res.a_g[j])
                if res.merge_delta is not None:
                    deltas[parent] = res.merge_delta[j]
            if res.sigma is not None and sigma_probe is None:
                sigma_probe = res.sigma[0]
        return results, deltas, sigma_probe

    @staticmethod
    def _losses_from_parts(loss_parts, num_clients: int) -> List[float]:
        """Per-group (C,) losses -> floats in sampled-client order."""
        losses = [float("nan")] * num_clients
        for members, loss_g in loss_parts:
            if loss_g is None:
                continue
            vals = loss_g.detach().cpu().numpy()
            for j, i in enumerate(members):
                losses[i] = float(vals[j])
        return losses

    def _finalize_round(self, plan: RoundPlan, results, deltas, sigma_probe,
                        t0: float) -> RoundStats:
        """Write the new globals back and fold FLoRA's deltas into the
        base, then record the round: the probe spectrum (first adapter,
        layer-averaged) into the energy trace, the per-client losses into
        the round's nan-mean."""
        self._write_factors(results)
        if deltas:
            self._merge_flora_delta(deltas)
        probe = None
        if sigma_probe is not None:
            arr = sigma_probe.detach().cpu().numpy()
            probe = arr if arr.ndim == 1 else arr.mean(axis=0)
            self.energy.record(probe)
        losses = (plan.losses if plan.losses is not None else
                  self._losses_from_parts(plan.loss_parts, len(plan.ranks)))
        arr = np.asarray(losses, dtype=np.float64)
        mean_loss = (float(np.nanmean(arr)) if not np.all(np.isnan(arr))
                     else float("nan"))
        stats = RoundStats(
            round=plan.round, clients=plan.clients, ranks=plan.ranks,
            lr=plan.lr, mean_client_loss=mean_loss, sigma_probe=probe,
            wall_time_s=time.time() - t0)
        self.history.append(stats)
        self.round_idx += 1
        return stats

    def flush_stats(self) -> None:
        """Kept for the reference's API: the synchronous batched engine
        records every round's stats in ``_finalize_round``."""

    def _train_stage(self, plan: RoundPlan) -> None:
        """TRAIN stage of either engine; frees the plan's batches."""
        if self.round_engine == "sequential":
            plan.client_factors, plan.losses = self._train_sequential(
                plan.client_batches, plan.ranks, plan.lr)
        else:
            plan.group_factors, plan.loss_parts = self._train_grouped(
                plan.client_batches, plan.ranks, plan.lr)
        plan.client_batches = None

    def _aggregate_stage(self, plan: RoundPlan):
        """AGGREGATE stage of either engine: (results, deltas, probe)."""
        if self.round_engine == "sequential":
            return self._aggregate_sequential(plan.client_factors,
                                              plan.ranks, plan.n_k)
        return self._aggregate_grouped(plan.group_factors, plan.ranks,
                                       plan.n_k)

    def run_round(self) -> RoundStats:
        t0 = time.time()
        plan = self._plan_round()
        self._train_stage(plan)
        results, deltas, sigma_probe = self._aggregate_stage(plan)
        return self._finalize_round(plan, results, deltas, sigma_probe, t0)

    def run(self, rounds: Optional[int] = None,
            eval_fn: Optional[Callable] = None,
            eval_every: int = 10) -> List[RoundStats]:
        rounds = rounds if rounds is not None else self.fl.num_rounds
        for _ in range(rounds):
            self.run_round()
            if eval_fn is not None and self.round_idx % eval_every == 0:
                eval_fn(self)
        return self.history

    # -- evaluation ------------------------------------------------------------

    def global_params(self) -> dict:
        return merge_lora(self.base, self.global_lora)

    @torch.no_grad()
    def evaluate(self, batch: dict) -> dict:
        _, metrics = self.model.train_loss(self.global_params(), batch,
                                           lora_rank=self.lora_cfg.r_max)
        return {k: float(v) for k, v in metrics.items()}
