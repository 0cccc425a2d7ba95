"""Synthetic classification data standing in for the paper's CIFAR100.

A numpy copy of ``repro.data.synthetic.ClusterClassification`` and
``batches``: the same seed gives identical arrays on both sides, so a
parity test and the chip run draw the data the reference draws.

``ClusterClassification`` draws class prototypes in a D-dim latent space
and emits patch-sequence inputs (frontend-embedding format). A class is a
mixture of ``modes_per_class`` prototype modes, so the Bayes-optimal
adapter update has rank well above r_1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class ClusterClassification:
    num_classes: int = 20
    dim: int = 64                # latent / embedding dim
    patches: int = 16            # sequence length of patch embeddings
    modes_per_class: int = 4     # intra-class modes -> high-rank structure
    noise: float = 0.6
    samples_per_class: int = 100
    seed: int = 0

    def generate(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (x (N, patches, dim) f32, y (N,) i32)."""
        rng = np.random.default_rng(self.seed)
        protos = rng.normal(
            size=(self.num_classes, self.modes_per_class, self.patches,
                  self.dim)).astype(np.float32)
        xs, ys = [], []
        for c in range(self.num_classes):
            modes = rng.integers(0, self.modes_per_class,
                                 size=self.samples_per_class)
            base = protos[c, modes]                       # (S, P, D)
            x = base + self.noise * rng.normal(
                size=base.shape).astype(np.float32)
            xs.append(x.astype(np.float32))
            ys.append(np.full(self.samples_per_class, c, np.int32))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        order = rng.permutation(len(y))
        return x[order], y[order]

    def train_test_split(self, test_frac: float = 0.2):
        x, y = self.generate()
        n_test = int(len(y) * test_frac)
        return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


def batches(x: np.ndarray, y: np.ndarray, batch_size: int,
            rng: np.random.Generator, epochs: int = 1):
    """Shuffled minibatch iterator over one client's shard."""
    n = len(y)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield x[sel], y[sel]
        if n < batch_size:  # tiny shard: one padded batch
            sel = rng.choice(n, size=batch_size, replace=True)
            yield x[sel], y[sel]
