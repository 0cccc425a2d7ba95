"""Replayable client-latency traces (JSONL), a copy of
``repro/data/traces.py`` (plain Python, no array library).

The event-driven round scheduler (``federation/events.py``) draws one
latency sample per dispatched client. A *trace* is that sample stream
written down: one JSON object per line, in global dispatch order,

    {"client": 3, "latency": 1.8042}

so replaying a trace through ``events.TraceLatency`` reproduces the exact
arrival schedule of the recorded run -- the federated trajectory becomes a
pure function of (seed, trace). Traces are the bridge to REAL system
measurements: a production deployment can log per-client round-trip times
in this format and the simulator replays them bit-for-bit.

Records are kept deliberately minimal (client id + latency seconds in
VIRTUAL time units). Dispatch times are not recorded because the scheduler
re-derives them: plan i dispatches at ``i * round_interval``, so the trace
stays valid under a different ``round_interval`` or trigger -- only the
latency draws are pinned.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Sequence


@dataclass(frozen=True)
class TraceRecord:
    """One latency draw: ``client`` (registry id) took ``latency`` virtual
    seconds to return its update after its plan's dispatch."""

    client: int
    latency: float


def write_trace(path: str, records: Iterable[TraceRecord]) -> None:
    """Write records as JSONL (one object per line, dispatch order)."""
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps({"client": int(rec.client),
                                "latency": float(rec.latency)}) + "\n")


def read_trace(path: str) -> List[TraceRecord]:
    """Load a JSONL trace written by ``write_trace`` (blank lines skipped)."""
    out: List[TraceRecord] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            out.append(TraceRecord(client=int(obj["client"]),
                                   latency=float(obj["latency"])))
    return out


def constant_trace(schedule: Sequence[int],
                   latency: float = 1.0) -> List[TraceRecord]:
    """The unit-latency trace for a known dispatch ``schedule`` (client ids
    in dispatch order): every client takes exactly ``latency`` virtual
    seconds. Under this trace the event-driven engine's count trigger
    reduces to the fixed ``pipeline_depth`` cadence (DESIGN.md §7)."""
    return [TraceRecord(client=int(c), latency=float(latency))
            for c in schedule]


def trace_schedule(records: Sequence[TraceRecord]) -> List[int]:
    """The dispatch-order client id sequence of a trace."""
    return [rec.client for rec in records]
