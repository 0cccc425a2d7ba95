"""The cells' inputs, made from the seed and handed alike to the program
and to the reference: parameter trees, the federated clients' images,
labels, shards and ranks, the served requests and the tenants' adapters.

Parameters are drawn on the device with one ``torch.Generator``: one
``normal_`` over a flat buffer in the served dtype, carved into the
leaves (each at a 256-byte boundary), then each leaf scaled in place by
its rule (``leaf_rule``). The federated images are a pool drawn on the
device and kept on the host, since the port's ``batch_fn`` hands the
server numpy batches; a client's sample is a pool image with its patch
tokens rotated, so every sample of the data set differs from every other.
Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

ALIGN = 128   # elements between leaf starts: 256 bytes in bf16, 512 in f32


def leaves(tree: dict, prefix=()) -> Dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def build(flat: Dict[tuple, object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def leaf_rule(path: tuple, shape: tuple) -> tuple:
    """(std, mean) of a leaf: projections N(0, 1/fan_in) as the model's
    own init draws them, the token table N(0, 1/d), biases N(0, 0.02^2),
    norm scales 1 + N(0, 0.1^2); LoRA factors as a federated fine-tune
    holds them after some rounds: A N(0, 1/r), B N(0, (0.01)^2 / r)."""
    key = path[-1]
    if key == "w":
        return shape[-2] ** -0.5, 0.0
    if key == "embed":
        return shape[-1] ** -0.5, 0.0
    if key == "b":
        return 0.02, 0.0
    if key == "scale":
        return 0.1, 1.0
    if key == "lora_a":
        return shape[-2] ** -0.5, 0.0
    if key == "lora_b":
        return 0.01 * shape[-1] ** -0.5, 0.0
    raise ValueError(f"no rule for leaf {path}")


def draw_tree(shapes: Dict[tuple, tuple], gen: torch.Generator, dtype,
              device, rule=leaf_rule) -> Dict[tuple, torch.Tensor]:
    """Leaves of ``shapes`` ({path: shape}) drawn in one call into a flat
    buffer and scaled in place by ``rule``."""
    offsets, total = {}, 0
    for path, shape in shapes.items():
        offsets[path] = total
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    out = {}
    for path, shape in shapes.items():
        t = buf[offsets[path]:offsets[path] + math.prod(shape)].view(shape)
        std, mean = rule(path, tuple(shape))
        t.mul_(std)
        if mean:
            t.add_(mean)
        out[path] = t
    return out


def fingerprint(tree: dict, block: int = 1 << 26) -> float:
    """A sum of every leaf's values in f64, a block at a time (no copy of
    a whole leaf): the inputs' state, to see that the program left them
    as they were made."""
    total = 0.0
    for t in leaves(tree).values():
        flat = t.detach().reshape(-1)
        for i in range(0, flat.numel(), block):
            total += float(flat[i:i + block].sum(dtype=torch.float64))
    return total


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one input stream of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *stream])


# -- the federated clients -----------------------------------------------------

class ImagePool:
    """The clients' data set: ``classes`` x ``samples_per_class`` samples of
    ``tokens`` patch embeddings of width ``dim``. Sample s has label
    c = s // samples_per_class; it is pool image c * per_class + (k %
    per_class), k = s % samples_per_class, its tokens rotated by k //
    per_class positions. A pool image is its class's mean plus unit
    noise, drawn on the device and kept on the host."""

    def __init__(self, seed: int, classes: int, samples_per_class: int,
                 per_class: int, tokens: int, dim: int, device):
        assert samples_per_class <= per_class * tokens, \
            "more samples per class than distinct rotations"
        self.classes, self.spc, self.per_class = classes, samples_per_class, \
            per_class
        self.tokens = tokens
        g = generator(seed, 1, device)
        means = torch.randn(classes, 1, tokens, dim, generator=g,
                            device=device)
        pool = torch.randn(classes, per_class, tokens, dim, generator=g,
                           device=device) + means
        self.images = pool.reshape(classes * per_class, tokens, dim).cpu(
        ).numpy()

    def batch(self, ids: np.ndarray) -> dict:
        """The port's classification batch of samples ``ids`` (numpy): the
        label read at position 0."""
        c, k = ids // self.spc, ids % self.spc
        p = c * self.per_class + k % self.per_class
        roll = k // self.per_class
        pos = (np.arange(self.tokens)[None, :] + roll[:, None]) % self.tokens
        b = len(ids)
        targets = np.zeros((b, self.tokens), np.int32)
        targets[:, 0] = c
        mask = np.zeros((b, self.tokens), np.float32)
        mask[:, 0] = 1.0
        return {"embeds": self.images[p[:, None], pos], "targets": targets,
                "loss_mask": mask}


def dirichlet_shards(seed: int, classes: int, samples_per_class: int,
                     clients: int, alpha: float) -> List[np.ndarray]:
    """Each class's samples split over the clients by Dirichlet(alpha)
    proportions (the paper's non-IID partition)."""
    rng = host_rng(seed, 2)
    shards: List[list] = [[] for _ in range(clients)]
    for c in range(classes):
        ids = c * samples_per_class + rng.permutation(samples_per_class)
        props = rng.dirichlet([alpha] * clients)
        cuts = (np.cumsum(props)[:-1] * samples_per_class).astype(int)
        for k, part in enumerate(np.split(ids, cuts)):
            shards[k].extend(part.tolist())
    return [np.sort(np.asarray(s, dtype=np.int64)) for s in shards]


def client_ranks(cohort_seed: int, clients: int, levels: Sequence[int],
                 probs: Sequence[float]) -> np.ndarray:
    """Each client's LoRA rank, drawn from the levels' probabilities."""
    rng = host_rng(cohort_seed, 3)
    return rng.choice(np.asarray(levels), size=clients,
                      p=np.asarray(probs)).astype(int)


def draw_ids(shard: np.ndarray, need: int, rng: np.random.Generator
             ) -> np.ndarray:
    """A client's ``need`` samples of a round: a shuffled prefix of its
    shard (the round's local batches), or draws with replacement from a
    shard smaller than that."""
    if len(shard) >= need:
        return shard[rng.permutation(len(shard))[:need]]
    return shard[rng.integers(0, len(shard), need)]


def plan_rounds(cohort_seed: int, rounds: int, clients: int, per_round: int,
                shards: List[np.ndarray], need: int) -> list:
    """The server's plan of each round as Algorithm 1 draws it from its
    numpy generator (the reference's order: the cohort, then each
    client's samples): [(clients, [ids per client])]."""
    rng = np.random.default_rng(cohort_seed)
    out = []
    for _ in range(rounds):
        cohort = rng.choice(clients, size=per_round, replace=False)
        out.append((cohort.tolist(),
                    [draw_ids(shards[c], need, rng) for c in cohort]))
    return out


# -- serving --------------------------------------------------------------------

def tenant_rule(path: tuple, shape: tuple) -> tuple:
    """A tenant's trained adapter: A N(0, 1/in), B N(0, 0.01 / r), so that
    its terms move a projection's output by about a tenth."""
    if path[-1] == "lora_a":
        return shape[-1] ** -0.5, 0.0
    if path[-1] == "lora_b":
        return 0.1 * shape[-1] ** -0.5, 0.0
    raise ValueError(f"no tenant rule for leaf {path}")


class Requests:
    """Each client's stream of requests: request j of client c has a
    prompt of ``prompt_len`` ids uniform over the vocabulary, drawn from
    ``seed``, and a tenant uniform over the tenants and an output length
    uniform over [out_min, out_max], drawn from the mix's fixed
    ``traffic_seed``: every seed sends the same lengths and tenants, so
    it does the same work. Each client has its own generators, so a
    stream does not depend on timing."""

    def __init__(self, seed: int, traffic_seed: int, clients: int,
                 prompt_len: int, out_min: int, out_max: int, tenants: int,
                 vocab: int):
        self.rngs = [host_rng(seed, 4, c) for c in range(clients)]
        self.mix = [host_rng(traffic_seed, 6, c) for c in range(clients)]
        self.prompt_len, self.out = prompt_len, (out_min, out_max)
        self.tenants, self.vocab = tenants, vocab

    def next(self, client: int) -> dict:
        rng, mix = self.rngs[client], self.mix[client]
        return {"prompt": rng.integers(0, self.vocab, self.prompt_len,
                                       dtype=np.int64),
                "tenant": int(mix.integers(0, self.tenants)),
                "out_len": int(mix.integers(self.out[0], self.out[1] + 1))}
