"""Client registry: heterogeneous rank assignment + data shard bookkeeping
(numpy port of ``repro/federation/topology.py::ClientRegistry``; the same
rng draws give the same ranks and samples as the reference)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.analysis import host_cost
from repro_torch.configs.base import FLConfig, LoRAConfig


@dataclass
class ClientRegistry:
    ranks: np.ndarray                 # (K,) int
    shards: List[np.ndarray]          # per-client sample indices
    rank_levels: Sequence[int]

    @classmethod
    def create(cls, fl: FLConfig, lora: LoRAConfig,
               shards: List[np.ndarray],
               rng: Optional[np.random.Generator] = None) -> "ClientRegistry":
        rng = rng or np.random.default_rng(fl.seed)
        k = fl.num_clients
        assert len(shards) == k, (len(shards), k)
        ranks = rng.choice(lora.rank_levels, size=k, p=lora.rank_probs)
        return cls(ranks=ranks.astype(int), shards=shards,
                   rank_levels=tuple(lora.rank_levels))

    @property
    def num_clients(self) -> int:
        return len(self.ranks)

    def num_samples(self, k: int) -> int:
        return len(self.shards[k])

    def add_client(self, rank: int, shard: np.ndarray) -> int:
        """Register a NEW client mid-run (the event engine's "join"
        lifecycle event) and return its id. Ids are append-only, so plans
        and shards recorded before the join stay valid."""
        cid = self.num_clients
        # np.append copies the whole (K,) rank vector: an O(K) cost per
        # join event (not per round), which the host-cost shim records
        host_cost.tick("registry/add_client")
        self.ranks = np.append(self.ranks, int(rank)).astype(int)
        self.shards.append(np.asarray(shard, dtype=np.int64))
        return cid

    def inflate(self, total_clients: int,
                rng: Optional[np.random.Generator] = None) -> None:
        """Grow the registry to ``total_clients`` synthetic clients for
        scale tests: ranks drawn from the configured levels, shards
        aliased round-robin onto the existing ones (no data copies)."""
        k = self.num_clients
        extra = int(total_clients) - k
        if extra <= 0:
            return
        rng = rng or np.random.default_rng(0)
        new_ranks = rng.choice(list(self.rank_levels), size=extra)
        self.ranks = np.concatenate([self.ranks, new_ranks.astype(int)])
        self.shards.extend(self.shards[i % k] for i in range(extra))

    def sample_round(self, m: int, rng: np.random.Generator,
                     active: Optional[np.ndarray] = None) -> np.ndarray:
        """Uniform sampling without replacement (Alg. 1 line 3).
        ``active`` (event engine) restricts the pool to those clients and
        caps m at its size; ``active=None`` keeps the rng stream of the
        cadence engines exactly."""
        if active is None:
            host_cost.tick("registry/sample", m)
            return rng.choice(self.num_clients, size=m, replace=False)
        active = np.asarray(active)
        host_cost.tick("registry/active_pool", active.size)
        m = min(int(m), active.size)
        return active[rng.choice(active.size, size=m, replace=False)]
