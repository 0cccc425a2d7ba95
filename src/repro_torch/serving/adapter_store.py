"""Paged adapter cache with atomic, versioned hot-swap (DESIGN.md §11),
ported from ``repro/serving/adapter_store.py``.

``AdapterStore`` holds one LoRA adapter tree per tenant, bucketed by rank
level as the aggregation side buckets clients: pages are packed
bucket-by-bucket (ascending rank level, insertion order within a bucket).
Factors are stored at ``r_max`` width with zero columns beyond the true
rank (zero columns are spectrum-inert, so a padded page applies exactly
as its truncated original), and each tenant's LoRA scaling is folded into
its ``lora_b`` at packing time, so the engine runs every page at unit
scale.

``publish()`` packs the staged adapters into an immutable
:class:`PublishedAdapters` snapshot under a strictly monotonic version and
flips one reference; readers capture the snapshot once per step.
``bind_server`` re-stages a tenant with the freshly aggregated global
factors at every round landing of a ``FederatedLoRA`` server and
publishes under the server's adapter version.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.lora import _is_lora_path, flatten, unflatten


@dataclasses.dataclass(frozen=True)
class PublishedAdapters:
    """Immutable snapshot of the packed adapter pages.

    ``pages`` mirrors the staged lora tree; every leaf carries a leading
    page axis P: lora_a (P, ..., r_max, in), lora_b (P, ..., out, r_max).
    ``page_of`` maps tenant id -> page index; ``ranks[p]`` is page p's
    true rank; ``scales[p]`` the scaling already folded into its lora_b
    (recorded for introspection only).
    """
    version: int
    pages: dict
    page_of: Mapping[Any, int]
    ranks: Tuple[int, ...]
    scales: Tuple[float, ...]

    @property
    def num_pages(self) -> int:
        return len(self.ranks)

    def page_ids(self, adapter_ids) -> torch.Tensor:
        """Tenant ids -> int32 page indices (a CPU tensor)."""
        return torch.tensor([self.page_of[i] for i in adapter_ids],
                            dtype=torch.int32)


def _mask_and_pad(path: tuple, leaf: torch.Tensor, rank: int,
                  r_max: int) -> torch.Tensor:
    """Zero columns >= rank, pad the rank dim to r_max."""
    key = path[-1]
    if key == "lora_m":
        raise ValueError("DoRA magnitudes are not servable via the paged "
                         "adapter cache (serving supports plain LoRA)")
    ax = leaf.ndim - 2 if key == "lora_a" else leaf.ndim - 1
    r_in = leaf.shape[ax]
    if r_in > r_max:
        raise ValueError(f"{path}: rank width {r_in} exceeds r_max {r_max}")
    shape = [1] * leaf.ndim
    shape[ax] = r_in
    col = torch.arange(r_in, device=leaf.device)
    leaf = leaf * (col < rank).reshape(shape).to(leaf.dtype)
    if r_in < r_max:
        pad = list(leaf.shape)
        pad[ax] = r_max - r_in
        leaf = torch.cat([leaf, leaf.new_zeros(pad)], dim=ax)
    return leaf


class AdapterStore:
    """Rank-level-bucketed tenant adapter store with atomic publish."""

    def __init__(self, rank_levels: Tuple[int, ...], scaling_fn=None):
        self.rank_levels = tuple(sorted(rank_levels))
        self.r_max = max(self.rank_levels)
        # staged: tenant id -> (rank, lora_tree); insertion order preserved
        self._staged: Dict[Any, Tuple[int, dict]] = {}
        self._scaling_fn = scaling_fn or (lambda rank: 1.0)
        self._published: Optional[PublishedAdapters] = None
        self._version = 0

    def put(self, adapter_id, lora_tree: dict, rank: int) -> None:
        """Stage (or replace) a tenant's adapter at its true rank. Takes
        effect only at the next ``publish()``."""
        if rank not in self.rank_levels:
            raise ValueError(f"rank {rank} not in levels {self.rank_levels}")
        self._staged[adapter_id] = (rank, lora_tree)

    def buckets(self) -> Dict[int, list]:
        """rank level -> staged tenant ids (insertion order within)."""
        out: Dict[int, list] = {lvl: [] for lvl in self.rank_levels}
        for aid, (rank, _) in self._staged.items():
            out[rank].append(aid)
        return out

    @property
    def published(self) -> Optional[PublishedAdapters]:
        """The live snapshot. Capture ONCE per step; never re-read
        mid-step."""
        return self._published

    @property
    def version(self) -> int:
        return self._version

    def publish(self, version: Optional[int] = None) -> PublishedAdapters:
        """Pack the staged adapters and atomically flip the live snapshot.
        ``version`` defaults to the next monotonic value; an explicit one
        must be strictly greater than the current one."""
        if not self._staged:
            raise ValueError("publish() with no staged adapters")
        version = self._version + 1 if version is None else int(version)
        if version <= self._version:
            raise ValueError(
                f"version must be monotonic: {version} <= {self._version}")
        buckets = self.buckets()
        order = [aid for lvl in self.rank_levels for aid in buckets[lvl]]
        page_of = {aid: p for p, aid in enumerate(order)}
        ranks = tuple(self._staged[aid][0] for aid in order)
        scales = tuple(float(self._scaling_fn(r)) for r in ranks)
        flats = []
        for aid in order:
            rank, tree = self._staged[aid]
            s = self._scaling_fn(rank)
            flat = {}
            for path, leaf in flatten(tree).items():
                if _is_lora_path(path):
                    leaf = _mask_and_pad(path, leaf, rank, self.r_max)
                    if path[-1] == "lora_b" and s != 1.0:
                        # fold the per-tenant scaling into B (an f32 s, as
                        # the reference multiplies by jnp.asarray(s, dtype))
                        leaf = leaf * torch.tensor(s, dtype=leaf.dtype,
                                                   device=leaf.device)
                flat[path] = leaf
            flats.append(flat)
        pages = unflatten({path: torch.stack([f[path] for f in flats])
                           for path in flats[0]})
        snap = PublishedAdapters(version=version, pages=pages,
                                 page_of=page_of, ranks=ranks,
                                 scales=scales)
        self._published = snap          # the atomic flip
        self._version = version
        return snap

    def bind_server(self, server, adapter_id="global",
                    rank: Optional[int] = None) -> None:
        """Attach to ``FederatedLoRA.add_post_aggregate_hook``: every round
        landing re-stages ``adapter_id`` with the new global factors and
        publishes under the server's adapter version."""
        rank = self.r_max if rank is None else rank

        def on_round_landing(version: int, global_lora: dict) -> None:
            self.put(adapter_id, global_lora, rank)
            self.publish(version)

        server.add_post_aggregate_hook(on_round_landing)
