"""Non-IID client partitioning: Dirichlet and pathological label skew.

Matches the paper's setups: regular Dirichlet(alpha) partitioning, and the
pathological c<labels>(alpha) setting where each client holds at most
``labels_per_client`` labels with Dirichlet-weighted proportions.
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int,
                  rng: np.random.Generator) -> List[np.ndarray]:
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_client: int = 2) -> List[np.ndarray]:
    """Regular Dirichlet label-skew partitioning."""
    classes = np.unique(labels)
    shards: List[list] = [[] for _ in range(num_clients)]
    for c in classes:
        idx_c = rng.permutation(np.where(labels == c)[0])
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for shard, part in zip(shards, np.split(idx_c, cuts)):
            shard.extend(part.tolist())
    # ensure every client has at least a few samples
    all_idx = rng.permutation(len(labels))
    out = []
    spare = 0
    for shard in shards:
        if len(shard) < min_per_client:
            extra = all_idx[spare:spare + min_per_client]
            spare += min_per_client
            shard = list(shard) + extra.tolist()
        out.append(np.sort(np.asarray(shard, dtype=np.int64)))
    return out


def pathological_partition(labels: np.ndarray, num_clients: int,
                           labels_per_client: int, alpha: float,
                           rng: np.random.Generator) -> List[np.ndarray]:
    """c<labels>(alpha): each client restricted to a label subset, with
    Dirichlet-distributed proportions over that subset."""
    classes = np.unique(labels)
    by_class = {c: rng.permutation(np.where(labels == c)[0]).tolist()
                for c in classes}
    cursor = {c: 0 for c in classes}
    shards: List[np.ndarray] = []
    per_client = len(labels) // num_clients
    for _ in range(num_clients):
        chosen = rng.choice(classes, size=min(labels_per_client, len(classes)),
                            replace=False)
        props = rng.dirichlet(np.full(len(chosen), alpha))
        counts = np.maximum((props * per_client).astype(int), 1)
        take: list = []
        for c, cnt in zip(chosen, counts):
            pool = by_class[c]
            start = cursor[c]
            grabbed = pool[start:start + cnt]
            if len(grabbed) < cnt:  # wrap around if the class is exhausted
                grabbed = grabbed + pool[:cnt - len(grabbed)]
                cursor[c] = cnt - len(grabbed)
            else:
                cursor[c] = start + cnt
            take.extend(grabbed)
        shards.append(np.sort(np.asarray(take, dtype=np.int64)))
    return shards


def make_partition(kind: str, labels: np.ndarray, num_clients: int, *,
                   alpha: float = 1.0, labels_per_client: int = 20,
                   seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    if kind == "iid":
        return iid_partition(labels, num_clients, rng)
    if kind == "dirichlet":
        return dirichlet_partition(labels, num_clients, alpha, rng)
    if kind == "pathological":
        return pathological_partition(labels, num_clients, labels_per_client,
                                      alpha, rng)
    raise ValueError(f"unknown partition kind {kind!r}")
