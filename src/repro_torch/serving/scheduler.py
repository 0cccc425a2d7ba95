"""Continuous-batching request scheduler (DESIGN.md §11), ported from
``repro/serving/scheduler.py``.

Runs a :class:`ServingEngine` under the federation stack's deterministic
``VirtualClock``/latency-model machinery: requests are admitted into free
slots as they arrive (prefill), every active slot advances one token per
scheduler step (decode), and finished requests are evicted so their slots
recycle immediately -- prefill/decode interleave at step granularity, the
standard continuous-batching discipline.

Timing is VIRTUAL and deterministic: a decode step costs ``step_cost``
plus the slowest active slot's latency draw (one seeded per-tenant stream
each, the same :class:`LatencyModel` family the round engines use), and a
prefill admission adds ``prefill_cost``. Per-request latency percentiles
and token throughput therefore replay bit for bit for a fixed scenario,
and equal the JAX batcher's; no wall clock enters ``stats()``.

The engine's tokens come back to the host once per engine call (one
``.cpu()`` of the admit's or the decode step's token vector); the decode
mask goes to the engine as a host bool array.

All prompts within one batcher share a prompt length (fixed-shape
prefill; heterogeneous lengths would need left-padding the cache seed,
out of scope here) -- asserted at submit().
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.federation.events import LatencyModel, VirtualClock


@dataclasses.dataclass
class ServeRequest:
    """One generation request for tenant ``adapter_id``."""
    rid: Any
    prompt: Any                       # (L,) int token ids
    adapter_id: Any
    max_new_tokens: int = 8
    arrival: float = 0.0              # virtual seconds
    # filled by the batcher
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


class ContinuousBatcher:
    """Admit/evict request scheduler over a fixed-slot engine."""

    def __init__(self, engine, *, clock: Optional[VirtualClock] = None,
                 latency: Optional[LatencyModel] = None,
                 step_cost: float = 0.01, prefill_cost: float = 0.05,
                 eos_token: Optional[int] = None):
        self.engine = engine
        self.clock = clock or VirtualClock()
        self.latency = latency
        self.step_cost = float(step_cost)
        self.prefill_cost = float(prefill_cost)
        self.eos_token = eos_token
        self.queue: Deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * engine.slots
        self.done: List[ServeRequest] = []
        self._prompt_len: Optional[int] = None
        self.steps = 0

    # -- intake ---------------------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        lp = len(req.prompt)
        if self._prompt_len is None:
            self._prompt_len = lp
        assert lp == self._prompt_len, (lp, self._prompt_len)
        self.queue.append(req)

    # -- one scheduler step ---------------------------------------------------

    def step(self) -> None:
        """Admit into free slots, then decode every active slot once."""
        free = [i for i, r in enumerate(self.slots) if r is None]
        admits: List[ServeRequest] = []
        idxs: List[int] = []
        while free and self.queue and self.queue[0].arrival <= self.clock.now:
            req = self.queue.popleft()
            slot = free.pop(0)
            self.slots[slot] = req
            admits.append(req)
            idxs.append(slot)
        cost = 0.0
        if admits:
            first = self.engine.admit(
                idxs, torch.stack([torch.as_tensor(r.prompt)
                                   for r in admits]),
                [r.adapter_id for r in admits])
            # the admitted slots' tokens, in admit order
            for r, tok in zip(admits, torch.as_tensor(first).cpu().tolist()):
                r.t_admit = self.clock.now
                r.t_first = self.clock.now   # refined after the charge below
                r.tokens.append(int(tok))
            cost += self.prefill_cost
        active = np.asarray([r is not None for r in self.slots], bool)
        if active.any():
            # skip slots whose request completed with the prefill token
            decode_mask = active.copy()
            for i, r in enumerate(self.slots):
                if r is not None and self._finished(r):
                    decode_mask[i] = False
            if decode_mask.any():
                toks = torch.as_tensor(
                    self.engine.decode(decode_mask)).cpu().tolist()
                for i, r in enumerate(self.slots):
                    if r is not None and decode_mask[i]:
                        r.tokens.append(int(toks[i]))
            cost += self.step_cost
            if self.latency is not None:
                draws = [self.latency.sample(self._client_of(r))
                         for r in self.slots if r is not None]
                cost += max(draws)
        if cost:
            self.clock.advance(self.clock.now + cost)
        for r in admits:
            r.t_first = self.clock.now
        # evict finished requests so their slots recycle next step
        for i, r in enumerate(self.slots):
            if r is not None and self._finished(r):
                r.t_done = self.clock.now
                self.done.append(r)
                self.slots[i] = None
        self.steps += 1

    def _client_of(self, req: ServeRequest) -> int:
        # process-independent (built-in hash() is salted): virtual stats
        # must replay bit for bit across sessions
        aid = req.adapter_id
        return aid if isinstance(aid, int) \
            else zlib.crc32(str(aid).encode()) % (2 ** 31)

    def _finished(self, req: ServeRequest) -> bool:
        if self.eos_token is not None and req.tokens \
                and req.tokens[-1] == self.eos_token:
            return True
        return len(req.tokens) >= req.max_new_tokens

    def run(self, max_steps: int = 10_000) -> None:
        """Step until every submitted request completes."""
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slots):
                return
            if self.queue and not any(self.slots) \
                    and self.queue[0].arrival > self.clock.now:
                self.clock.advance(self.queue[0].arrival)
            self.step()
        raise RuntimeError(f"scheduler did not drain in {max_steps} steps")

    # -- stats ----------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Deterministic virtual-time serving metrics over completed
        requests: token throughput and request-latency percentiles."""
        if not self.done:
            return {"completed": 0}
        lats = np.asarray([r.t_done - r.arrival for r in self.done])
        firsts = np.asarray([r.t_first - r.arrival for r in self.done])
        toks = sum(len(r.tokens) for r in self.done)
        elapsed = max(self.clock.now, 1e-9)
        return {
            "completed": float(len(self.done)),
            "tokens": float(toks),
            "virtual_throughput_tok_per_s": toks / elapsed,
            "virtual_p50_s": float(np.percentile(lats, 50)),
            "virtual_p95_s": float(np.percentile(lats, 95)),
            "virtual_ttft_p50_s": float(np.percentile(firsts, 50)),
            "virtual_elapsed_s": float(self.clock.now),
            "steps": float(self.steps),
        }
