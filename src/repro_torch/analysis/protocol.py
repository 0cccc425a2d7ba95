"""Protocol verifier: exhaustive bounded-interleaving model checking of the
port's event-driven federated round path (a copy of
``repro/analysis/protocol.py``; DESIGN.md §10).

The event scheduler's promises -- exactly-once consumption, the ghost /
present-mask weight rule, bounded staleness, cancelled arrivals never
aggregated, checkpoint-cut replay equivalence -- are checked over ALL
bounded interleavings of a small federation (~3 clients x 2-3 plans x
every trigger family), driving the port's own ``EventScheduler``,
``flatten_cohort`` and ``cohort_weights``.

The split of responsibilities is the point of the design:

* the MODEL supplies only the event order: each (plan, client) dispatch
  is assigned a latency from a small grid (``Scenario.grid``), and the
  sweep enumerates every assignment;
* the IMPLEMENTATION supplies every transition: runs drive a REAL
  ``events.EventScheduler`` (or a deliberately sabotaged subclass, for
  the positive controls) through the exact consumption protocol
  ``FederatedLoRA`` uses -- ``dispatch`` / ``advance_window`` /
  ``take_ready`` / ``completed_plans`` / ``forget_plan`` / ``drain`` --
  and cohort weights come from the same ``flatten_cohort`` +
  ``cohort_weights`` code the aggregation consumes.

A violation is therefore a finding against the implementation, never a
modeling artifact.

Partial-order reduction: the model's choices frequently commute, and the
sweep runs one representative per commuting class (``CheckStats`` records
the reduction). Two mechanisms:

* schedule-signature dedupe: assignments realizing the SAME arrival
  schedule (identical multiset of ``(arrival_time, plan, member)``) are
  one class -- the sorted multiset canonicalizes the pop order of
  simultaneous arrivals, which cannot change what any fire consumes
  (a fire takes the whole arrived set) or any weight (weights key on
  ``(plan, member)``, not pop order);
* symmetry reduction: a scenario may declare clients INTERCHANGEABLE
  (``Scenario.symmetric``) when they have identical ``(rank, n_k)`` and
  no lifecycle event names them (validated at sweep time). Permuting
  the latencies of interchangeable clients within one plan permutes
  member labels in every observable, and every protocol invariant is
  label-permutation-invariant, so the sweep canonicalizes each plan's
  draws over a symmetric group to sorted order.

Checkpoint cuts: the uninterrupted run snapshots ``state_dict()`` at
every reachable event boundary -- after each dispatch, after each trigger
firing (mid-window AND mid-drain), and at each window end -- and each
snapshot is restored into a FRESH scheduler that replays the remainder.
Replays must reproduce the uninterrupted run's remaining fires (times,
delivered members, arrival times, staleness, present masks, weights) and
its final ``state_dict`` EXACTLY: the mid-buffer resume becomes a
checked invariant over every path.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.analysis.rules import Finding, ProgramContext, RuleSet
from repro_torch.core.aggregation import cohort_weights
from repro_torch.federation.events import (BufferTrigger, ClientLifecycle,
                                     EventScheduler, LatencyModel)
from repro_torch.federation.server import flatten_cohort

WEIGHT_TOL = 1e-9


# ---------------------------------------------------------------------------
# the model's only degree of freedom: which latency each dispatch draws
# ---------------------------------------------------------------------------

class FixedLatency(LatencyModel):
    """Replay a per-client latency table: client ``c``'s i-th dispatch
    draws ``table[c][i]``. This is how the model checker injects one
    enumerated interleaving into the REAL scheduler -- everything else
    (arrival order, trigger decisions, cancellation, staleness) is the
    implementation's own behavior. Checkpointable like every other
    ``LatencyModel`` (per-client draw cursors)."""

    def __init__(self, table: Dict[int, Sequence[float]]):
        super().__init__(seed=0)
        self.table = {int(c): tuple(float(l) for l in ls)
                      for c, ls in table.items()}
        self.pos: Dict[int, int] = {}

    def sample(self, client: int) -> float:
        c = int(client)
        i = self.pos.get(c, 0)
        draws = self.table[c]
        assert i < len(draws), f"latency table exhausted for client {c}"
        self.pos[c] = i + 1
        return draws[i]

    def state_dict(self) -> dict:
        return {"pos": {str(c): self.pos[c] for c in sorted(self.pos)}}

    def load_state_dict(self, state: Optional[dict]) -> None:
        self.pos = ({} if not state else
                    {int(c): int(p) for c, p in state["pos"].items()})


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Scenario:
    """One model-checked configuration: a fixed federation shape, trigger
    family and lifecycle script; the sweep enumerates every latency
    assignment from ``grid`` over the slots the scenario actually
    dispatches."""

    name: str
    num_clients: int
    num_plans: int
    trigger_fn: Callable[[], BufferTrigger]
    lifecycle_fn: Callable[[], ClientLifecycle]
    grid: Tuple[float, ...]
    n_k: Tuple[int, ...]            # per base client (joined clients: 1)
    ranks: Tuple[int, ...]
    round_interval: float = 1.0
    gamma: float = 0.6
    # armed for the staleness-bound trigger family: consumed staleness may
    # never exceed it (rule proto-staleness-bound)
    staleness_bound: Optional[int] = None
    r_min: int = 4
    join_rank: int = 8
    # groups of interchangeable client ids (symmetry reduction): each
    # group's members must share (rank, n_k) and appear in no lifecycle
    # event -- validated by check_scenario
    symmetric: Tuple[Tuple[int, ...], ...] = ()

    def client_rank(self, c: int) -> int:
        return (int(self.ranks[c]) if c < len(self.ranks)
                else self.join_rank)

    def client_n_k(self, c: int) -> int:
        return int(self.n_k[c]) if c < len(self.n_k) else 1


# ---------------------------------------------------------------------------
# run records (what the rules inspect)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Fire:
    """One trigger firing as the server-protocol driver consumed it."""

    time: float
    phase: str                                   # "w{p}" | "drain"
    delivered: Tuple[Tuple[int, int, float], ...]  # (plan, member, arrival)
    staleness: Tuple[int, ...]                   # flattened cohort order
    present: Tuple[bool, ...]
    ghost: Tuple[bool, ...]
    weights: Tuple[float, ...]

    def key(self):
        return (self.time, self.phase, self.delivered, self.staleness,
                self.present, self.ghost, self.weights)


@dataclass
class RunRecord:
    """Everything one interleaving produced; the payload the protocol
    rules run over."""

    scenario: str
    signature: Tuple = ()
    dispatch_slots: List[Tuple[int, int]] = field(default_factory=list)
    plan_sizes: Dict[int, int] = field(default_factory=dict)
    fires: List[Fire] = field(default_factory=list)
    consume_counts: Dict[Tuple[int, int], int] = field(default_factory=dict)
    dropped: Set[Tuple[int, int]] = field(default_factory=set)
    final_state: Optional[dict] = None
    boundaries: int = 0
    replays: int = 0
    replay_mismatches: List[str] = field(default_factory=list)
    drain_horizon: Optional[float] = None


@dataclass(frozen=True)
class _Boundary:
    """A reachable event boundary of the uninterrupted run: the snapshot
    taken there plus the driver context a resume needs."""

    kind: str                       # "dispatch" | "fire" | "window" | "drain-fire"
    plan: int
    window_end: Optional[float]
    snapshot: dict
    fires_done: int
    pending: Tuple[int, ...]
    plan_clients: Dict[int, Tuple[int, ...]]
    horizon: Optional[float]


class _Registry:
    """Registry surrogate for "join" lifecycle events -- mirrors
    ``FederatedLoRA._apply_join``'s append-only, idempotent id rule."""

    def __init__(self, base: int):
        self.num = int(base)

    def apply_join(self, ev) -> None:
        if ev.client < self.num:
            return                   # already applied (restore replay)
        assert ev.client == self.num, (ev.client, self.num)
        self.num += 1


# ---------------------------------------------------------------------------
# the server-protocol driver
# ---------------------------------------------------------------------------

class Driver:
    """Drives a real ``EventScheduler`` through the exact protocol the
    server uses, recording every transition into a ``RunRecord``.

    ``break_present=True`` is the injected ghost-rule bug (positive
    control): cohort weights are computed IGNORING the present mask, the
    way a naive aggregation would -- ``proto-ghost-weight`` must trip.
    """

    def __init__(self, scenario: Scenario, table: Dict[int, Sequence[float]],
                 *, sched_cls=EventScheduler, break_present: bool = False):
        self.scenario = scenario
        self.sched = sched_cls(FixedLatency(table), scenario.trigger_fn(),
                               round_interval=scenario.round_interval,
                               lifecycle=scenario.lifecycle_fn())
        self.registry = _Registry(scenario.num_clients)
        self.sched.bind_join_hook(self.registry.apply_join)
        self.break_present = break_present
        self.record = RunRecord(scenario=scenario.name)
        self.plan_clients: Dict[int, List[int]] = {}
        self.pending: List[int] = []

    # -- protocol steps (each one mirrors a FederatedLoRA call site) --------

    def _dispatch(self, pr: int) -> None:
        pool = self.sched.active_clients(self.registry.num)
        clients = ([int(c) for c in pool] if pool is not None
                   else list(range(self.registry.num)))
        self.sched.dispatch(pr, clients)
        self.plan_clients[pr] = clients
        self.pending.append(pr)
        self.record.dispatch_slots += [(pr, c) for c in clients]
        self.record.plan_sizes[pr] = len(clients)

    def _fire(self, fire_time: float, phase: str) -> None:
        """Mirror of ``FederatedLoRA._aggregate_arrivals``: take the ready
        set, assemble the merged cohort over the pending plans that have
        ready members, and run the REAL weight rule (one ghost member is
        appended, as shard padding would, so the ghost-zero rule is
        checked on every fire)."""
        sc = self.scenario
        ready = self.sched.take_ready()
        delivered = tuple(sorted((pr, m, t) for pr, rd in ready.items()
                                 for m, t in rd.items()))
        for pr, m, _ in delivered:
            key = (pr, m)
            self.record.consume_counts[key] = \
                self.record.consume_counts.get(key, 0) + 1
        plans = [pr for pr in self.pending if pr in ready]
        if not plans:
            self.record.fires.append(Fire(fire_time, phase, delivered,
                                          (), (), (), ()))
            return
        members, ranks, n_k, staleness, present = [], [], [], [], []
        off = 0
        for pr in plans:
            clients = self.plan_clients[pr]
            arrived = ready[pr]
            for j, c in enumerate(clients):
                members.append(off + j)
                present.append(j in arrived)
                staleness.append(
                    self.sched.staleness_of(fire_time, arrived[j])
                    if j in arrived else 0)
                ranks.append(sc.client_rank(c))
                n_k.append(sc.client_n_k(c))
            off += len(clients)
        members.append(-1)           # the shard-padding ghost
        ranks_o, n_k_o, stal_o, pres_o = flatten_cohort(
            members, ranks, n_k, staleness, present, sc.r_min)
        weights = cohort_weights(
            n_k_o, stal_o, None if self.break_present else pres_o, sc.gamma)
        self.record.fires.append(Fire(
            fire_time, phase, delivered,
            tuple(int(s) for s in stal_o), tuple(bool(p) for p in pres_o),
            tuple(m < 0 for m in members),
            tuple(float(w) for w in weights)))

    def _capture_dropped(self) -> None:
        """Record cancelled (dropped-out) members before plans can be
        retired and their bookkeeping forgotten."""
        book = self.sched.state_dict()["book"]
        for pr, b in book.items():
            self.record.dropped |= {(int(pr), int(m))
                                    for m in b["dropped"]}

    def _retire(self) -> None:
        self._capture_dropped()
        for pr in self.sched.completed_plans():
            self.sched.forget_plan(pr)
            self.pending.remove(pr)

    def _drain_horizon(self) -> Optional[float]:
        heap = self.sched.state_dict()["heap"]
        return max((item[0] for item in heap), default=None)

    def _finish(self) -> RunRecord:
        self._capture_dropped()
        self.record.final_state = self.sched.state_dict()
        return self.record

    # -- the uninterrupted run ----------------------------------------------

    def run_full(self, *, cuts: bool = False) -> List[_Boundary]:
        """Drive every plan's window plus the drain; with ``cuts`` a
        snapshot is taken at EVERY reachable event boundary."""
        bounds: List[_Boundary] = []

        def mark(kind, plan, window_end=None, horizon=None):
            self.record.boundaries += 1
            self._capture_dropped()
            if cuts:
                bounds.append(_Boundary(
                    kind, plan, window_end, self.sched.state_dict(),
                    len(self.record.fires), tuple(self.pending),
                    {pr: tuple(cl)
                     for pr, cl in self.plan_clients.items()},
                    horizon))

        for pr in range(self.scenario.num_plans):
            self._dispatch(pr)
            end = self.sched.clock.now + self.scenario.round_interval
            mark("dispatch", pr, window_end=end)
            for t in self.sched.advance_window():
                self._fire(t, f"w{pr}")
                mark("fire", pr, window_end=end)
            self._retire()
            mark("window", pr)
        horizon = self._drain_horizon()
        self.record.drain_horizon = horizon
        for t in self.sched.drain():
            self._fire(t, "drain")
            mark("drain-fire", self.scenario.num_plans - 1, horizon=horizon)
        self._finish()
        return bounds


# ---------------------------------------------------------------------------
# checkpoint-cut replay
# ---------------------------------------------------------------------------

def _corrupt(snapshot: dict) -> dict:
    """The replay-divergence positive control: a deliberately torn
    snapshot that must make the replay diverge from the uninterrupted
    run. Three tears, by what the snapshot still holds: lose an
    in-flight arrival; falsely mark a buffered update consumed; or (when
    neither exists) corrupt the dispatch sequence counter -- each is
    observable in the remaining fires or the final state, and none
    violates the clock's monotonicity."""
    snap = copy.deepcopy(snapshot)
    if snap["heap"]:
        snap["heap"] = snap["heap"][:-1]
        return snap
    for b in snap["book"].values():
        pending = [int(m) for m in b["arrived"]
                   if int(m) not in set(b["consumed"])]
        if pending:
            b["consumed"] = sorted(set(b["consumed"]) | {pending[0]})
            return snap
    snap["seq"] = int(snap["seq"]) + 1
    return snap


def replay_from(scenario: Scenario, table: Dict[int, Sequence[float]],
                boundary: _Boundary, base: RunRecord, *,
                corrupt: bool = False) -> List[str]:
    """Restore ``boundary``'s snapshot into a FRESH scheduler, replay the
    remainder of the run, and return the list of divergences from the
    uninterrupted run (empty = bit-equal replay)."""
    sc = scenario
    d = Driver(sc, table)
    snap = _corrupt(boundary.snapshot) if corrupt \
        else copy.deepcopy(boundary.snapshot)
    d.sched.load_state_dict(snap)
    d.pending = list(boundary.pending)
    d.plan_clients = {pr: list(cl)
                      for pr, cl in boundary.plan_clients.items()}
    kind, p = boundary.kind, boundary.plan
    if kind in ("dispatch", "fire"):
        # finish the interrupted window: same end the original used
        for t in d.sched._events(boundary.window_end):
            d._fire(t, f"w{p}")
        d._retire()
        nxt = p + 1
    elif kind == "window":
        nxt = p + 1
    else:                            # "drain-fire": mid-drain resume
        nxt = sc.num_plans
    for pr in range(nxt, sc.num_plans):
        d._dispatch(pr)
        for t in d.sched.advance_window():
            d._fire(t, f"w{pr}")
        d._retire()
    if kind == "drain-fire":
        # the drain horizon is fixed at drain START (events.py): the
        # resume must play out to the ORIGINAL horizon, then force-fire
        if boundary.horizon is not None:
            for t in d.sched._events(boundary.horizon):
                d._fire(t, "drain")
        if d.sched.pending_ready_count > 0:
            d._fire(d.sched._fire(d.sched.clock.now), "drain")
    else:
        for t in d.sched.drain():
            d._fire(t, "drain")
    d._finish()

    at = f"{kind}@plan{p}/fire{boundary.fires_done}"
    mism = []
    expect = [f.key() for f in base.fires[boundary.fires_done:]]
    got = [f.key() for f in d.record.fires]
    if got != expect:
        i = next((i for i, (g, e) in enumerate(zip(got, expect))
                  if g != e), min(len(got), len(expect)))
        mism.append(f"replay from {at}: fires diverge at post-cut fire "
                    f"{i} ({len(got)} vs {len(expect)} fires)")
    if d.record.final_state != base.final_state:
        mism.append(f"replay from {at}: final scheduler state diverges")
    return mism


# ---------------------------------------------------------------------------
# interleaving enumeration with partial-order reduction
# ---------------------------------------------------------------------------

def discover_slots(scenario: Scenario) -> List[Tuple[int, int]]:
    """The (plan, client) dispatch slots the scenario realizes.

    The sampling pool evolves only through SCRIPTED lifecycle events at
    fixed virtual times, never through arrivals, so the slot list is
    latency-independent -- one probe run of the real scheduler discovers
    it (no re-derivation of the pool rule in the model)."""
    draws = max(scenario.num_plans, 1)
    probe_table = {c: (scenario.grid[0],) * draws
                   for c in range(scenario.num_clients + scenario.num_plans)}
    probe = Driver(scenario, probe_table)
    probe.run_full()
    return list(probe.record.dispatch_slots)


def _validate_symmetry(scenario: Scenario) -> None:
    """Interchangeability preconditions (module docstring): identical
    (rank, n_k) within a group and no lifecycle event naming a member."""
    scripted = {ev.client for ev in scenario.lifecycle_fn().events}
    for group in scenario.symmetric:
        shapes = {(scenario.client_rank(c), scenario.client_n_k(c))
                  for c in group}
        assert len(shapes) == 1, \
            f"symmetric group {group} mixes (rank, n_k) shapes {shapes}"
        hit = set(group) & scripted
        assert not hit, f"symmetric clients {hit} appear in the lifecycle"


def canonical_combo(scenario: Scenario, slots: Sequence[Tuple[int, int]],
                    combo: Sequence[float]) -> Tuple[float, ...]:
    """Symmetry-reduced representative: within each plan, the draws
    assigned to a symmetric group are re-dealt in sorted order (slot
    order is ascending client id, so this is a canonical relabeling)."""
    if not scenario.symmetric:
        return tuple(combo)
    group_of = {c: gi for gi, g in enumerate(scenario.symmetric) for c in g}
    lat = list(combo)
    cells: Dict[Tuple[int, int], List[int]] = {}
    for i, (pr, c) in enumerate(slots):
        gi = group_of.get(c)
        if gi is not None:
            cells.setdefault((pr, gi), []).append(i)
    for idxs in cells.values():
        for i, v in zip(idxs, sorted(lat[i] for i in idxs)):
            lat[i] = v
    return tuple(lat)


def signature_of(scenario: Scenario, slots: Sequence[Tuple[int, int]],
                 combo: Sequence[float]) -> Tuple:
    """Canonical schedule signature: the sorted multiset of
    ``(arrival_time, plan, member)``. Assignments sharing it are one
    commuting class (see module docstring)."""
    member_of: Dict[int, int] = {}
    sig = []
    for (pr, _c), lat in zip(slots, combo):
        j = member_of.get(pr, 0)
        member_of[pr] = j + 1
        sig.append((round(pr * scenario.round_interval + lat, 9), pr, j))
    return tuple(sorted(sig))


def table_of(slots: Sequence[Tuple[int, int]],
             combo: Sequence[float]) -> Dict[int, List[float]]:
    """Latency table realizing one assignment: per-client draws in the
    client's dispatch order."""
    table: Dict[int, List[float]] = {}
    for (_pr, c), lat in zip(slots, combo):
        table.setdefault(c, []).append(lat)
    return table


@dataclass
class CheckStats:
    assignments: int = 0
    unique_schedules: int = 0
    fires: int = 0
    boundaries: int = 0
    replays: int = 0

    def to_json(self) -> dict:
        return {"assignments": self.assignments,
                "unique_schedules": self.unique_schedules,
                "por_reduction": self.assignments - self.unique_schedules,
                "fires": self.fires, "boundaries": self.boundaries,
                "replays": self.replays}


def check_scenario(scenario: Scenario, *, replay: bool = True,
                   sched_cls=EventScheduler, break_present: bool = False,
                   corrupt_replay: bool = False,
                   keep_records: bool = False
                   ) -> Tuple[List[Finding], CheckStats, List[RunRecord]]:
    """Exhaustively model-check one scenario: every latency assignment
    (one representative per commuting class), the invariant rules on each
    run, and -- with ``replay`` -- a save -> restore -> replay check from
    every reachable event boundary of every run."""
    _validate_symmetry(scenario)
    slots = discover_slots(scenario)
    stats = CheckStats()
    findings: List[Finding] = []
    records: List[RunRecord] = []
    seen: Set[Tuple] = set()
    for raw in itertools.product(scenario.grid, repeat=len(slots)):
        stats.assignments += 1
        combo = canonical_combo(scenario, slots, raw)
        sig = signature_of(scenario, slots, combo)
        if sig in seen:
            continue                 # commuting class already checked
        seen.add(sig)
        stats.unique_schedules += 1
        table = table_of(slots, combo)
        driver = Driver(scenario, table, sched_cls=sched_cls,
                        break_present=break_present)
        bounds = driver.run_full(cuts=replay)
        rec = driver.record
        rec.signature = sig
        if replay:
            for b in bounds:
                rec.replays += 1
                rec.replay_mismatches += replay_from(
                    scenario, table, b, rec, corrupt=corrupt_replay)
        stats.fires += len(rec.fires)
        stats.boundaries += rec.boundaries
        stats.replays += rec.replays
        ctx = ProgramContext(
            program=scenario.name, kind="protocol", payload=rec,
            meta={"staleness_bound": scenario.staleness_bound,
                  "signature": sig})
        findings.extend(PROTOCOL_RULES.run(ctx))
        if keep_records:
            records.append(rec)
    return findings, stats, records


# ---------------------------------------------------------------------------
# invariant rules
# ---------------------------------------------------------------------------

PROTOCOL_RULES = RuleSet("protocol")


def _sig(ctx: ProgramContext) -> str:
    sig = ctx.meta.get("signature", ())
    return "sched[" + ",".join(f"{t}:{pr}.{m}" for t, pr, m in sig) + "]"


@PROTOCOL_RULES.rule(
    "proto-exactly-once",
    "every dispatched (plan, member) arrival is aggregated exactly once "
    "across all fires, or explicitly cancelled by a dropout -- never "
    "twice, never lost")
def _check_exactly_once(ctx: ProgramContext):
    rec: RunRecord = ctx.payload
    for (pr, m), cnt in sorted(rec.consume_counts.items()):
        if cnt > 1:
            yield (f"plan {pr} member {m} aggregated {cnt} times",
                   _sig(ctx))
    for pr, size in sorted(rec.plan_sizes.items()):
        for m in range(size):
            if (rec.consume_counts.get((pr, m), 0) == 0
                    and (pr, m) not in rec.dropped):
                yield (f"plan {pr} member {m} neither aggregated nor "
                       f"cancelled after drain", _sig(ctx))


@PROTOCOL_RULES.rule(
    "proto-cancelled-consumed",
    "a cancelled (dropped-out) arrival is never consumed by any fire")
def _check_cancelled(ctx: ProgramContext):
    rec: RunRecord = ctx.payload
    for key in sorted(set(rec.consume_counts) & rec.dropped):
        yield (f"plan {key[0]} member {key[1]} was cancelled by a dropout "
               f"AND aggregated", _sig(ctx))


@PROTOCOL_RULES.rule(
    "proto-ghost-weight",
    "present-mask weight conservation: every fire's cohort weights sum "
    "to exactly 1 with absent clients AND ghost members at exactly zero "
    "(the ghost rule)")
def _check_weights(ctx: ProgramContext):
    rec: RunRecord = ctx.payload
    for i, fire in enumerate(rec.fires):
        if not fire.weights:
            continue
        total = float(np.sum(fire.weights))
        if abs(total - 1.0) > WEIGHT_TOL:
            yield (f"fire {i} @ t={fire.time}: weights sum to {total!r}",
                   _sig(ctx))
        for j, (w, p, g) in enumerate(zip(fire.weights, fire.present,
                                          fire.ghost)):
            if g and w != 0.0:
                yield (f"fire {i} @ t={fire.time}: ghost slot {j} got "
                       f"weight {w!r}", _sig(ctx))
            elif not g and not p and w != 0.0:
                yield (f"fire {i} @ t={fire.time}: absent slot {j} got "
                       f"weight {w!r}", _sig(ctx))


@PROTOCOL_RULES.rule(
    "proto-staleness-bound",
    "under the staleness-bound trigger no consumed update's staleness "
    "exceeds the bound; armed via meta['staleness_bound']")
def _check_staleness(ctx: ProgramContext):
    bound = ctx.meta.get("staleness_bound")
    if bound is None:
        return
    rec: RunRecord = ctx.payload
    for i, fire in enumerate(rec.fires):
        for j, (s, p) in enumerate(zip(fire.staleness, fire.present)):
            if p and s > bound:
                yield (f"fire {i} @ t={fire.time}: slot {j} consumed at "
                       f"staleness {s} > bound {bound}", _sig(ctx))


@PROTOCOL_RULES.rule(
    "proto-empty-fire",
    "a trigger firing always consumes at least one buffered update (the "
    "scheduler promises pending_ready_count > 0 at every fire)")
def _check_empty_fire(ctx: ProgramContext):
    rec: RunRecord = ctx.payload
    for i, fire in enumerate(rec.fires):
        if not fire.delivered:
            yield f"fire {i} @ t={fire.time} consumed nothing", _sig(ctx)


@PROTOCOL_RULES.rule(
    "proto-replay-divergence",
    "save -> restore at EVERY reachable event boundary replays bit-equal "
    "to the uninterrupted run (fires and final scheduler state)")
def _check_replay(ctx: ProgramContext):
    rec: RunRecord = ctx.payload
    for msg in rec.replay_mismatches:
        yield msg, _sig(ctx)


# ---------------------------------------------------------------------------
# sabotaged schedulers (positive controls)
# ---------------------------------------------------------------------------

class DoubleConsumeScheduler(EventScheduler):
    """Injected double-fire bug: every fire re-delivers each plan's
    ALREADY-CONSUMED members alongside the fresh ones -- the classic
    double-aggregation protocol bug. ``proto-exactly-once`` must trip."""

    def take_ready(self):
        prev = {pr: {m: b["arrived"][m] for m in sorted(b["consumed"])
                     if m in b["arrived"]}
                for pr, b in self._book.items()}
        out = super().take_ready()
        for pr, extra in prev.items():
            if extra:
                out.setdefault(pr, {}).update(extra)
        return out


class CancelledDeliveryScheduler(EventScheduler):
    """Injected cancellation bug: fires deliver members a dropout already
    cancelled (as if the dropped client's update arrived anyway).
    ``proto-cancelled-consumed`` must trip on any dropout scenario."""

    def take_ready(self):
        out = super().take_ready()
        for pr, b in self._book.items():
            for m in sorted(b["dropped"]):
                out.setdefault(pr, {})[m] = self.clock.now
        return out
