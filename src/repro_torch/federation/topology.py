"""Client registry: heterogeneous rank assignment + data shard bookkeeping
(numpy port of ``repro/federation/topology.py::ClientRegistry``; the same
rng draws give the same ranks and samples as the reference)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

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

    def sample_round(self, m: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform sampling without replacement (Alg. 1 line 3)."""
        return rng.choice(self.num_clients, size=m, replace=False)
