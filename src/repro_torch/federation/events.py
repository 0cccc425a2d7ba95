"""Event-driven round scheduling on a deterministic virtual clock: a copy
of ``repro/federation/events.py`` (numpy only) without its host-cost
hooks. The draws, fire times and ``state_dict`` are the reference's, so
both packages' checkpoints carry the same event state.

The async round engine (DESIGN.md §6) buffers trained plans on a FIXED
cadence (``pipeline_depth``). Real FedLoRA deployments are driven by
wall-clock client latency instead: heterogeneous system resources make
high-rank clients slow, stragglers trickle in, clients drop out mid-round.
This module turns the async engine into a simulation-grade scheduler
(DESIGN.md §7):

* ``VirtualClock`` -- deterministic virtual time. Plan i dispatches at
  ``i * round_interval``; client k of that plan ARRIVES at dispatch time +
  its sampled latency. Nothing reads the host clock, so runs are exactly
  reproducible and checkpointable.
* ``LatencyModel`` family -- seeded per-client latency draws: lognormal
  (the classic straggler-free heavy tail), bimodal (two device classes),
  straggler-tail (a designated straggler subset multiplied by a tail
  scale), constant (the unit-latency trace that reduces the whole machine
  back to the fixed cadence), and ``TraceLatency`` which replays a JSONL
  trace recorded by ``RecordingLatency`` (``data/traces.py``).
* ``BufferTrigger`` family -- pluggable "when to aggregate" policies
  evaluated event-by-event: ``CountTrigger`` (>= K arrived updates),
  ``TimeoutTrigger`` (virtual seconds since the last aggregation),
  ``StalenessBoundTrigger`` (the oldest buffered arrival may not exceed a
  staleness bound).
* ``ClientLifecycle`` -- timed dropout / rejoin / mid-run join events:
  a dropped client leaves the sampling pool and its in-flight updates are
  cancelled; a joined client enters the registry and the pool.

Staleness is ARRIVAL-TIME-derived: an update that arrived at time ``a``
and is aggregated at time ``T`` carries staleness
``floor((T - a) / round_interval)``. Under the unit-latency trace
(latency == round_interval) this reduces EXACTLY to the cadence engine's
plan-age staleness, which is what makes the count trigger with a unit
trace bit-equal to ``pipeline_depth=k`` (tests/test_events.py).

The scheduler owns only EVENT state (clock, arrival heap, per-plan arrival
bookkeeping, latency rng streams); trained factor stacks stay on the
server's pending plans. ``state_dict``/``load_state_dict`` round-trip the
whole thing through checkpoint metadata (JSON-safe), so save -> restore ->
run equals the uninterrupted event-driven run exactly.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set

import numpy as np

from repro_torch.analysis import host_cost
from repro_torch.data.traces import TraceRecord


# ---------------------------------------------------------------------------
# virtual clock
# ---------------------------------------------------------------------------

class VirtualClock:
    """Monotone deterministic simulation time (virtual seconds)."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def advance(self, t: float) -> None:
        assert t >= self.now - 1e-9, (t, self.now)
        self.now = max(self.now, float(t))

    def __repr__(self):
        return f"VirtualClock(now={self.now:.4f})"


# ---------------------------------------------------------------------------
# latency models
# ---------------------------------------------------------------------------

class LatencyModel:
    """Seeded per-client latency draws.

    Each client gets its OWN ``np.random.Generator`` stream (spawned from
    ``SeedSequence([seed, client])``), so a client's latency sequence does
    not depend on which other clients were sampled around it -- scenario
    edits (dropouts, different triggers) perturb only what they touch.
    Streams are created lazily and their bit-generator states are
    checkpointable (``state_dict``)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rngs: Dict[int, np.random.Generator] = {}

    def _rng(self, client: int) -> np.random.Generator:
        if client not in self._rngs:
            self._rngs[client] = np.random.default_rng(
                np.random.SeedSequence([self.seed, int(client)]))
        return self._rngs[client]

    def sample(self, client: int) -> float:
        raise NotImplementedError

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        # sorted client order: the serialized form must be byte-stable
        # regardless of which client sampled first (dict insertion order
        # is first-draw order, which scenario edits perturb)
        return {"rng": {str(c): self._rngs[c].bit_generator.state
                        for c in sorted(self._rngs)}}

    def load_state_dict(self, state: Optional[dict]) -> None:
        self._rngs = {}
        if not state:
            return
        for c, st in state.get("rng", {}).items():
            rng = self._rng(int(c))
            rng.bit_generator.state = st


class ConstantLatency(LatencyModel):
    """Every client takes exactly ``latency`` virtual seconds. With
    ``latency == round_interval`` this is the unit-latency trace: the
    count trigger reduces to the fixed pipeline cadence."""

    def __init__(self, latency: float = 1.0):
        super().__init__(seed=0)
        assert latency > 0, latency
        self.latency = float(latency)

    def sample(self, client: int) -> float:
        return self.latency


class LognormalLatency(LatencyModel):
    """``median * exp(sigma * N(0,1))`` per draw -- the standard
    heavy-ish-tailed client round-trip model."""

    def __init__(self, median: float = 1.0, sigma: float = 0.25,
                 seed: int = 0):
        super().__init__(seed=seed)
        assert median > 0, median
        self.median = float(median)
        self.sigma = float(sigma)

    def sample(self, client: int) -> float:
        z = float(self._rng(client).standard_normal())
        return self.median * math.exp(self.sigma * z)


class BimodalLatency(LatencyModel):
    """Two device classes: a draw is ``slow`` with probability
    ``slow_prob``, else ``fast`` (each jittered by a small lognormal)."""

    def __init__(self, fast: float = 1.0, slow: float = 4.0,
                 slow_prob: float = 0.3, jitter: float = 0.1, seed: int = 0):
        super().__init__(seed=seed)
        assert fast > 0 and slow > 0 and 0.0 <= slow_prob <= 1.0
        self.fast, self.slow = float(fast), float(slow)
        self.slow_prob = float(slow_prob)
        self.jitter = float(jitter)

    def sample(self, client: int) -> float:
        rng = self._rng(client)
        base = self.slow if rng.random() < self.slow_prob else self.fast
        return base * math.exp(self.jitter * float(rng.standard_normal()))


class StragglerTailLatency(LatencyModel):
    """Lognormal base latency with a designated straggler subset whose
    draws are multiplied by ``tail_scale``.

    Membership is either explicit (``straggler_clients``, e.g. "the
    high-rank clients" for the rank-collapse regression scenario) or drawn
    deterministically per client with probability ``straggler_frac`` from
    the seed -- the same client is a straggler in every run of a seed."""

    def __init__(self, median: float = 1.0, sigma: float = 0.2,
                 tail_scale: float = 6.0, straggler_frac: float = 0.25,
                 straggler_clients: Optional[Sequence[int]] = None,
                 seed: int = 0):
        super().__init__(seed=seed)
        assert median > 0 and tail_scale >= 1.0
        self.median, self.sigma = float(median), float(sigma)
        self.tail_scale = float(tail_scale)
        self.straggler_frac = float(straggler_frac)
        self.straggler_clients = (None if straggler_clients is None
                                  else set(int(c) for c in straggler_clients))

    def is_straggler(self, client: int) -> bool:
        if self.straggler_clients is not None:
            return int(client) in self.straggler_clients
        # deterministic membership: own stream, disjoint from the draw rng
        u = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7919, int(client)])).random()
        return bool(u < self.straggler_frac)

    def sample(self, client: int) -> float:
        z = float(self._rng(client).standard_normal())
        lat = self.median * math.exp(self.sigma * z)
        return lat * self.tail_scale if self.is_straggler(client) else lat


class TraceLatency(LatencyModel):
    """Strict replay of a recorded trace: the i-th ``sample`` call must be
    for the i-th record's client and returns its recorded latency. This
    pins the whole arrival schedule, making a run a pure function of
    (server seed, trace)."""

    def __init__(self, records: Sequence[TraceRecord]):
        super().__init__(seed=0)
        self.records = list(records)
        self.pos = 0

    def sample(self, client: int) -> float:
        assert self.pos < len(self.records), \
            f"trace exhausted after {self.pos} draws"
        rec = self.records[self.pos]
        assert rec.client == int(client), \
            (f"trace replay diverged at draw {self.pos}: "
             f"recorded client {rec.client}, asked for {client}")
        self.pos += 1
        return rec.latency

    def state_dict(self) -> dict:
        return {"pos": self.pos}

    def load_state_dict(self, state: Optional[dict]) -> None:
        self.pos = int(state["pos"]) if state else 0


class RecordingLatency(LatencyModel):
    """Tee wrapper: samples ``inner`` and records every draw as a
    ``TraceRecord`` (write with ``repro_torch.data.traces.write_trace``)."""

    def __init__(self, inner: LatencyModel):
        super().__init__(seed=0)
        self.inner = inner
        self.records: List[TraceRecord] = []

    def sample(self, client: int) -> float:
        lat = self.inner.sample(client)
        self.records.append(TraceRecord(client=int(client), latency=lat))
        return lat

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(),
                "records": [[r.client, r.latency] for r in self.records]}

    def load_state_dict(self, state: Optional[dict]) -> None:
        if not state:
            self.records = []
            self.inner.load_state_dict(None)
            return
        self.inner.load_state_dict(state.get("inner"))
        self.records = [TraceRecord(client=int(c), latency=float(l))
                        for c, l in state.get("records", [])]


# ---------------------------------------------------------------------------
# buffer triggers
# ---------------------------------------------------------------------------

class BufferTrigger:
    """When does the buffered aggregation fire?

    Two hooks, both side-effect-free:

    * ``on_arrival(sched)`` -- checked after each arrival event; return
      True to fire AT the arrival's timestamp.
    * ``deadline(sched)`` -- an absolute virtual time at which the trigger
      fires regardless of further arrivals (None = no deadline). The
      scheduler fires deadlines in event order, so a timeout expiring
      before the next arrival aggregates WITHOUT it.

    The scheduler guarantees ``pending_ready_count > 0`` at every fire
    (an empty buffer never aggregates) and resets ``last_fire`` itself.
    """

    def on_arrival(self, sched: "EventScheduler") -> bool:
        return False

    def deadline(self, sched: "EventScheduler") -> Optional[float]:
        return None

    def describe(self) -> str:
        return type(self).__name__


class CountTrigger(BufferTrigger):
    """Fire when >= ``k`` client updates are buffered (FedBuff's K). With
    the unit-latency trace and ``k = depth * clients_per_round`` this is
    bit-equal to the ``pipeline_depth=depth`` cadence."""

    def __init__(self, k: int):
        assert k >= 1, k
        self.k = int(k)

    def on_arrival(self, sched: "EventScheduler") -> bool:
        return sched.pending_ready_count >= self.k

    def describe(self) -> str:
        return f"count>={self.k}"


class TimeoutTrigger(BufferTrigger):
    """Fire ``timeout`` virtual seconds after the previous fire (provided
    anything is buffered; an empty buffer defers to the next arrival)."""

    def __init__(self, timeout: float):
        assert timeout > 0, timeout
        self.timeout = float(timeout)

    def on_arrival(self, sched: "EventScheduler") -> bool:
        # an arrival landing after an empty-buffer expiry fires immediately
        return sched.clock.now >= sched.last_fire + self.timeout - 1e-9

    def deadline(self, sched: "EventScheduler") -> Optional[float]:
        if sched.pending_ready_count == 0:
            return None
        return sched.last_fire + self.timeout

    def describe(self) -> str:
        return f"timeout={self.timeout}"


class StalenessBoundTrigger(BufferTrigger):
    """Fire before any buffered arrival's staleness would exceed
    ``max_staleness`` (staleness = floor(age / round_interval)): the
    deadline is ``oldest arrival + max_staleness * round_interval``, so an
    update is always aggregated at staleness <= max_staleness."""

    def __init__(self, max_staleness: int):
        assert max_staleness >= 0, max_staleness
        self.max_staleness = int(max_staleness)

    def deadline(self, sched: "EventScheduler") -> Optional[float]:
        oldest = sched.oldest_ready_time
        if oldest is None:
            return None
        return oldest + self.max_staleness * sched.round_interval

    def describe(self) -> str:
        return f"staleness<={self.max_staleness}"


# ---------------------------------------------------------------------------
# client lifecycle
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LifecycleEvent:
    """A timed client lifecycle change.

    kind="dropout": ``client`` leaves the sampling pool at ``time``; its
    in-flight (dispatched, not yet arrived) updates are cancelled -- they
    never reach the server. Already-arrived updates still aggregate.
    kind="rejoin":  ``client`` re-enters the sampling pool.
    kind="join":    a NEW client appears mid-run. ``client`` is the id it
    takes (must equal the registry size at apply time -- explicit so replay
    after a checkpoint restore is idempotent); ``rank``/``shard`` describe
    it for ``ClientRegistry.add_client``.
    """

    time: float
    kind: str            # "dropout" | "rejoin" | "join"
    client: int
    rank: Optional[int] = None
    shard: Optional[np.ndarray] = None

    def __post_init__(self):
        assert self.kind in ("dropout", "rejoin", "join"), self.kind


class ClientLifecycle:
    """A time-ordered scenario script of lifecycle events."""

    def __init__(self, events: Sequence[LifecycleEvent] = ()):
        self.events = sorted(events, key=lambda e: (e.time, e.client))

    def __len__(self):
        return len(self.events)


# ---------------------------------------------------------------------------
# the canonical sweep scenario (shared by bench_round_latency --engine event
# and fl_dryrun --trigger, so the dry-run cohort analysis always describes
# the same trigger/latency configuration the tracked benchmark rows record)
# ---------------------------------------------------------------------------

def standard_trigger(name: str, clients_per_round: int) -> BufferTrigger:
    """The sweep's trigger instances: count = a 2-round cohort (the
    pipeline_depth=2 analogue), a 2-virtual-second timeout, staleness
    bound 1."""
    return {"count": CountTrigger(2 * clients_per_round),
            "timeout": TimeoutTrigger(2.0),
            "staleness": StalenessBoundTrigger(1)}[name]


def standard_straggler_latency(straggler_frac: float,
                               seed: int = 0) -> StragglerTailLatency:
    """The sweep's latency model: lognormal(0.9, 0.2) with a x6 straggler
    tail drawn at ``straggler_frac``."""
    return StragglerTailLatency(median=0.9, sigma=0.2, tail_scale=6.0,
                                straggler_frac=straggler_frac, seed=seed)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

@dataclass
class FireRecord:
    """One buffered-aggregation firing (for tests and the latency bench)."""

    time: float
    consumed: int
    max_staleness: int
    trigger: str


class EventScheduler:
    """Arrival-event bookkeeping between the server's round stages.

    Protocol (driven by ``FederatedLoRA``):

    1. ``active_clients(n)`` -> sampling pool for the next plan.
    2. ``dispatch(plan_round, clients)`` after the plan's training is
       dispatched: samples one latency per client, schedules arrivals.
    3. ``for fire_time in advance_window():`` -- advances the clock one
       ``round_interval``, processing arrivals and lifecycle events in
       time order. Each yield is a trigger firing; the consumer MUST call
       ``take_ready()`` (and aggregate) before resuming iteration.
    4. ``completed_plans()`` / ``forget_plan`` retire fully-consumed plans.
    5. ``drain()`` at end of run: processes every remaining arrival, then
       force-fires whatever is left buffered.
    """

    def __init__(self, latency: LatencyModel, trigger: BufferTrigger, *,
                 round_interval: float = 1.0,
                 lifecycle: Optional[ClientLifecycle] = None):
        assert round_interval > 0, round_interval
        self.latency = latency
        self.trigger = trigger
        self.round_interval = float(round_interval)
        self.lifecycle = lifecycle or ClientLifecycle()
        self.clock = VirtualClock()
        self.last_fire = 0.0
        self.fire_log: List[FireRecord] = []
        self._heap: List[tuple] = []    # (time, seq, plan_round, member, client)
        self._seq = 0
        # plan_round -> {"size", "arrived" {member: time}, "consumed" set,
        #                "dropped" set}
        self._book: Dict[int, dict] = {}
        self._inactive: Set[int] = set()
        self._lc_idx = 0
        self._on_join: Optional[Callable[[LifecycleEvent], None]] = None

    # -- pool / dispatch -----------------------------------------------------

    def bind_join_hook(self, hook: Callable[[LifecycleEvent], None]) -> None:
        """Server hook applying "join" events to its client registry."""
        self._on_join = hook

    def active_clients(self, num_clients: int) -> Optional[np.ndarray]:
        """Sampling pool for the next plan; None = every client (the exact
        rng-stream-preserving fast path)."""
        if not self._inactive:
            return None
        # O(num_clients) pool scan, only on the lifecycle-event slow path:
        # the host-cost registry contract rides on the None fast path
        host_cost.tick("events/active_scan", num_clients)
        pool = np.array([c for c in range(num_clients)
                         if c not in self._inactive], dtype=np.int64)
        assert pool.size > 0, "every client has dropped out"
        return pool

    def dispatch(self, plan_round: int, clients: Sequence[int]) -> None:
        host_cost.tick("events/dispatch", len(clients))
        t = self.clock.now
        self._book[plan_round] = {"size": len(clients), "arrived": {},
                                  "consumed": set(), "dropped": set()}
        for member, client in enumerate(clients):
            lat = float(self.latency.sample(int(client)))
            assert lat > 0, (client, lat)
            heapq.heappush(self._heap,
                           (t + lat, self._seq, int(plan_round),
                            int(member), int(client)))
            self._seq += 1

    # -- buffer state --------------------------------------------------------

    @property
    def pending_ready_count(self) -> int:
        """Arrived-but-unaggregated client updates across all plans."""
        return sum(len(b["arrived"]) - len(b["consumed"])
                   for b in self._book.values())

    @property
    def oldest_ready_time(self) -> Optional[float]:
        times = [t for b in self._book.values()
                 for m, t in b["arrived"].items() if m not in b["consumed"]]
        return min(times) if times else None

    def staleness_of(self, fire_time: float, arrival_time: float) -> int:
        """Arrival-time-derived staleness: whole ``round_interval``s the
        update waited in the buffer. Reduces to the cadence engine's
        plan-age staleness under the unit-latency trace (DESIGN.md §7)."""
        age = (fire_time - arrival_time) / self.round_interval
        return max(0, int(math.floor(age + 1e-9)))

    def take_ready(self) -> Dict[int, Dict[int, float]]:
        """{plan_round: {member: arrival_time}} of every buffered update,
        marking them consumed. Called by the aggregation at a fire."""
        out: Dict[int, Dict[int, float]] = {}
        host_cost.tick("events/book_scan", len(self._book))
        # explicit client-iteration order: ascending plan round, ascending
        # member within a plan -- the aggregation's client axis (and thus
        # the fire log and the consumed bookkeeping) must not depend on
        # dict insertion history
        for pr in sorted(self._book):
            b = self._book[pr]
            ready = {m: b["arrived"][m] for m in sorted(b["arrived"])
                     if m not in b["consumed"]}
            if ready:
                out[pr] = ready
                b["consumed"].update(ready)
                host_cost.tick("events/ready", len(ready))
        if out:
            stal = max(self.staleness_of(self.clock.now, t)
                       for rd in out.values() for t in rd.values())
            self.fire_log.append(FireRecord(
                time=self.clock.now,
                consumed=sum(len(rd) for rd in out.values()),
                max_staleness=stal, trigger=self.trigger.describe()))
        return out

    def completed_plans(self) -> List[int]:
        """Plan rounds whose every member has been consumed or dropped
        (ascending plan order -- explicit, not insertion-dependent)."""
        return [pr for pr in sorted(self._book)
                if (len(self._book[pr]["consumed"])
                    + len(self._book[pr]["dropped"]))
                >= self._book[pr]["size"]]

    def forget_plan(self, plan_round: int) -> None:
        self._book.pop(plan_round, None)

    # -- the event loop ------------------------------------------------------

    def _process_lifecycle(self, ev: LifecycleEvent) -> None:
        if ev.kind == "dropout":
            self._inactive.add(ev.client)
            # cancel in-flight arrivals: the dropped client never reports
            kept = []
            for item in self._heap:
                if item[4] == ev.client:
                    self._book[item[2]]["dropped"].add(item[3])
                else:
                    kept.append(item)
            if len(kept) != len(self._heap):
                self._heap = kept
                heapq.heapify(self._heap)
        elif ev.kind == "rejoin":
            self._inactive.discard(ev.client)
        else:                               # join
            assert self._on_join is not None, \
                "join events need a bound registry hook"
            self._on_join(ev)

    def _fire(self, t: float) -> float:
        self.clock.advance(t)
        self.last_fire = self.clock.now
        return self.clock.now

    def _events(self, end: float) -> Iterator[float]:
        """Process arrivals + lifecycle events with time <= ``end`` in
        time order, yielding trigger fire times; the clock lands at
        ``end``."""
        while True:
            # next event: lifecycle events tie-break BEFORE arrivals at the
            # same timestamp (a dropout at t cancels an arrival at t)
            lc = (self.lifecycle.events[self._lc_idx]
                  if self._lc_idx < len(self.lifecycle.events) else None)
            arr = self._heap[0] if self._heap else None
            pick_lc = lc is not None and (arr is None or lc.time <= arr[0])
            nxt_time = (lc.time if pick_lc else
                        arr[0] if arr is not None else None)
            bound = min(nxt_time if nxt_time is not None else math.inf, end)
            # deadline fires come first: a timeout expiring before the next
            # event aggregates without it
            dl = self.trigger.deadline(self)
            if (dl is not None and dl <= bound + 1e-9
                    and self.pending_ready_count > 0):
                before = self.pending_ready_count
                yield self._fire(max(dl, self.clock.now))
                assert self.pending_ready_count < before, \
                    "fire consumer must take_ready()"
                continue
            if nxt_time is None or nxt_time > end:
                break
            if pick_lc:
                self.clock.advance(lc.time)
                self._lc_idx += 1
                self._process_lifecycle(lc)
                continue
            t, _, pr, member, client = heapq.heappop(self._heap)
            self.clock.advance(t)
            self._book[pr]["arrived"][member] = t
            if (self.pending_ready_count > 0
                    and self.trigger.on_arrival(self)):
                before = self.pending_ready_count
                yield self._fire(t)
                assert self.pending_ready_count < before, \
                    "fire consumer must take_ready()"
        self.clock.advance(end)

    def advance_window(self) -> Iterator[float]:
        """One round's event window: everything due in
        ``(now, now + round_interval]``, the clock left at the window end."""
        return self._events(self.clock.now + self.round_interval)

    def drain(self) -> Iterator[float]:
        """End-of-run: play events out to the ARRIVAL horizon (the last
        in-flight arrival -- triggers still apply on the way), then
        force-fire whatever is left buffered AT the horizon. The clock
        stops there: lifecycle events scripted beyond the horizon are
        irrelevant to draining and must not inflate the final staleness
        or the recorded virtual times."""
        if self._heap:
            yield from self._events(max(item[0] for item in self._heap))
        if self.pending_ready_count > 0:
            yield self._fire(self.clock.now)

    # -- checkpointing -------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "now": self.clock.now,
            "last_fire": self.last_fire,
            "seq": self._seq,
            "lc_idx": self._lc_idx,
            "inactive": sorted(self._inactive),
            "heap": [list(item) for item in sorted(self._heap)],
            # sorted plan/member order (not insertion order): the
            # serialized state -- and therefore checkpoint metadata -- is
            # byte-stable across runs that built the book differently
            "book": {str(pr): {"size": self._book[pr]["size"],
                               "arrived": {str(m):
                                           self._book[pr]["arrived"][m]
                                           for m in sorted(
                                               self._book[pr]["arrived"])},
                               "consumed": sorted(self._book[pr]["consumed"]),
                               "dropped": sorted(self._book[pr]["dropped"])}
                     for pr in sorted(self._book)},
            "fires": [[f.time, f.consumed, f.max_staleness, f.trigger]
                      for f in self.fire_log],
            "latency": self.latency.state_dict(),
        }

    def load_state_dict(self, state: Optional[dict]) -> None:
        """Reset to the checkpoint's event state (None: pristine). "join"
        lifecycle events before the restored cursor are replayed through
        the registry hook (idempotent: the event carries its client id)."""
        self.clock = VirtualClock(0.0 if not state else state["now"])
        self.last_fire = 0.0 if not state else float(state["last_fire"])
        self._seq = 0 if not state else int(state["seq"])
        self._lc_idx = 0 if not state else int(state["lc_idx"])
        self._inactive = (set() if not state
                          else set(int(c) for c in state["inactive"]))
        self._heap = ([] if not state else
                      [(float(t), int(s), int(pr), int(m), int(c))
                       for t, s, pr, m, c in state["heap"]])
        heapq.heapify(self._heap)
        self._book = {}
        self.fire_log = []
        if state:
            for pr, b in state["book"].items():
                self._book[int(pr)] = {
                    "size": int(b["size"]),
                    "arrived": {int(m): float(t)
                                for m, t in b["arrived"].items()},
                    "consumed": set(int(m) for m in b["consumed"]),
                    "dropped": set(int(m) for m in b["dropped"])}
            self.fire_log = [FireRecord(time=float(t), consumed=int(n),
                                        max_staleness=int(s), trigger=str(tr))
                             for t, n, s, tr in state.get("fires", [])]
        self.latency.load_state_dict(None if not state
                                     else state.get("latency"))
        for ev in self.lifecycle.events[:self._lc_idx]:
            if ev.kind == "join" and self._on_join is not None:
                self._on_join(ev)
