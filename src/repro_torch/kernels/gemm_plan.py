"""Host plans for the f32 SGEMM mainloop of ``csrc/sgemm_f32.cuh``, which
K2 (``gram.cu``), K3 (``rank_partition_agg.cu``), K4 and K5
(``lora_apply.cu``) share: the output tile a block owns, and the split of
the contraction depth into ranges, one block each, whose partial tiles
are summed in range order (no atomics, so a repeat gives the same bits).

The plans are pure Python and cached: every wrapper call plans, and the
host's time per call is as large as the card's at these sizes.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, NamedTuple, Tuple

SLAB = 16                 # sgemm_f32.cuh's kBK: a split is a multiple deep
MIN_SPLIT_DEPTH = 128     # no split is planned shallower than this
WAVE = 128                # blocks that about fill the H100's 132 SMs
SMS = 132                 # the H100's SMs
RESIDENT = 2              # SGEMM blocks an SM holds (<= 128 registers each)
TILES = ((128, 128), (64, 128))   # the SGEMM tiles lora_apply.cu builds
# gram.cu's square tile. A 128-wide one never pads the triangle less (at
# R = 192: 3 tiles of 128^2 against 6 of 64^2, 2.65x against 1.33x the
# triangle's work), so it is not built.
GRAM_TILE = 64
GRAM_RESIDENT = 4         # gram.cu's blocks an SM holds (<= 64 registers)
# rank_partition_agg.cu's tile: its depth is short (6 live slabs at the
# vit-base buckets), so a block's load ramp and store are a large share of
# its time, and three blocks an SM (<= 85 registers) overlap them better
# than two of 128 x 128
AGG_TILE = (64, 128)
AGG_RESIDENT = 3


class GemmPlan(NamedTuple):
    """A bm x bn output tile a block, ``tiles`` tiles in all, the depth cut
    into ``splits`` ranges of ``depth`` (the last one shorter where the
    depth is not a multiple)."""
    bm: int
    bn: int
    splits: int
    depth: int
    tiles: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def report(self) -> dict:
        return {"tile": [self.bm, self.bn], "splits": self.splits,
                "depth": self.depth, "blocks": self.blocks}


def split_ranges(k: int, depth: int) -> List[Tuple[int, int]]:
    """The [start, end) ranges of the depth that the blocks of one tile
    sum."""
    return [(k0, min(k, k0 + depth)) for k0 in range(0, k, depth)] or \
        [(0, 0)]


def split_sum(part: Callable[[int, int], Any], k: int, depth: int) -> Any:
    """part(k0, k1) for each range of a split ``depth`` deep, added in
    range order, as the kernels sum their partial tiles."""
    out = None
    for k0, k1 in split_ranges(k, max(depth, 1)):
        p = part(k0, k1)
        out = p if out is None else out + p
    return out


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _candidates(bm: int, bn: int, tiles: int, k: int) -> List[GemmPlan]:
    """Unsplit, and (where the tiles alone stay under ``WAVE``) every split
    into ranges at least ``MIN_SPLIT_DEPTH`` deep, a multiple of ``SLAB``,
    with all blocks resident at once."""
    plans = [GemmPlan(bm, bn, 1, max(SLAB, _round_up(k, SLAB)), tiles)]
    if tiles >= WAVE:
        return plans
    s = 2
    while True:
        depth = _round_up(-(-k // s), SLAB)
        plan = GemmPlan(bm, bn, -(-k // max(depth, 1)), depth, tiles)
        if depth < MIN_SPLIT_DEPTH or plan.blocks > RESIDENT * SMS:
            return plans
        plans.append(plan)
        s += 1


def _busiest(p: GemmPlan) -> int:
    """The depth the busiest SM sums, one block after another."""
    return -(-p.blocks // SMS) * p.depth


def _fullest(plans: List[GemmPlan]):
    """Of the plans reaching ``WAVE`` blocks, the one that gives the
    busiest SM the least depth to sum, ceil(blocks / SMS) x depth, the
    fewer splits on a tie; None where no plan reaches ``WAVE``."""
    full = [p for p in plans if p.blocks >= WAVE]
    return min(full, key=lambda p: (_busiest(p), p.splits)) if full else None


@functools.lru_cache(maxsize=1024)   # the wrappers plan every call
def plan_gemm(m: int, n: int, k: int) -> GemmPlan:
    """K4's and K5's tile and split over K for an (m, k) @ (k, n)
    product.

    Tiles are tried from the least padded work (ceil(m/bm) bm ceil(n/bn)
    bn) up, the larger tile first on a tie. A tile whose blocks alone
    reach ``WAVE`` runs unsplit. Otherwise K is split (``_candidates``),
    and of the splits reaching ``WAVE`` blocks the one that gives the
    busiest SM the least depth wins (at Qwen2-7B's 128-row q: 9 splits of
    400, 252 blocks, two on most SMs, rather than the first to reach
    ``WAVE``, 5 of 720, whose 140 blocks leave 8 SMs with twice the depth
    of the rest). Where no tile reaches ``WAVE``: the most blocks any tile
    and split can give."""
    order = sorted(TILES, key=lambda t: _round_up(m, t[0]) * _round_up(
        n, t[1]))
    best = None
    for bm, bn in order:
        plans = _candidates(bm, bn, -(-m // bm) * -(-n // bn), k)
        full = _fullest(plans)
        if full is not None:
            return full
        top = max(plans, key=lambda p: p.blocks)
        if best is None or top.blocks > best.blocks:
            best = top
    return best


def _plan_tile(bm: int, bn: int, tiles: int, k: int,
               resident: int) -> GemmPlan:
    """K2's and K3's split of the depth over a fixed tile. Where the tiles
    alone fill every resident slot of the card, unsplit. Otherwise, of the
    splits into ranges at least ``MIN_SPLIT_DEPTH`` deep (a multiple of
    ``SLAB``), the one that gives the busiest SM the least depth to sum,
    wave after wave, the fewer splits on a tie (K2's attn_qkvo bucket at
    R = 192: 288 tiles, 4 splits of 192; its up and down buckets over a
    depth of 3072: 72 tiles, 11 splits of 288)."""
    unsplit = GemmPlan(bm, bn, 1, max(SLAB, _round_up(k, SLAB)), tiles)
    if tiles >= resident * SMS:
        return unsplit
    plans, s = [unsplit], 2
    while _round_up(-(-k // s), SLAB) >= MIN_SPLIT_DEPTH:
        depth = _round_up(-(-k // s), SLAB)
        plans.append(GemmPlan(bm, bn, -(-k // depth), depth, tiles))
        s += 1
    return min(plans, key=lambda p: (_busiest(p), p.splits))


@functools.lru_cache(maxsize=1024)
def plan_gram(layers: int, rr: int, k: int) -> GemmPlan:
    """K2's plan for ``layers`` (R, R) Gram cores over a depth of k: the
    tiles on or above the diagonal of each layer."""
    t = -(-rr // GRAM_TILE)
    return _plan_tile(GRAM_TILE, GRAM_TILE, layers * t * (t + 1) // 2, k,
                      GRAM_RESIDENT)


@functools.lru_cache(maxsize=1024)
def plan_agg(layers: int, m: int, d: int, r: int, n: int) -> GemmPlan:
    """K3's plan: ``layers`` (d, M r) @ (M r, n) products (one layer of
    M 10, d 768, r 64: 72 tiles, 5 splits of 128)."""
    bm, bn = AGG_TILE
    return _plan_tile(bm, bn, layers * -(-d // bm) * -(-n // bn), m * r,
                      AGG_RESIDENT)
