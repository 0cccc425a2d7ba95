"""Batched multi-adapter inference engine (DESIGN.md §11), ported from
``repro/serving/engine.py``.

``ServingEngine`` runs a fixed number of request SLOTS. Per-request
adapters enter by leaf substitution: the published pages (leading page
axis P, then the layer axis G) are gathered by the slots' page ids into
per-slot factors (S, G, r, in) -- the training layout's client axis with
C = slots and one sequence per slot -- so ``Model.prefill_clients`` /
``decode_step_clients`` run every slot through its own tenant's factors,
and with ``use_kernels`` through the paged LoRA kernel K4.

Version atomicity: every public call captures ``store.published`` exactly
once at entry and logs its version in ``version_log``; a hot-swap between
two calls is the only place a version change can land.

Per-slot KV state: one full-``max_len`` cache from ``Model.init_cache``
with a VECTOR ``len`` (one length per slot), seeded path-aware from
prefill caches by ``seed_cache``.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import torch

from repro_torch.core.lora import flatten, split_lora, unflatten
from repro_torch.kernels.lora_apply import page_index
from repro_torch.serving.adapter_store import AdapterStore

_SEQ_KEYS = ("k", "v", "ckv", "krope")   # per-token cache leaves (seq axis 2)
_STATE_KEYS = ("conv", "ssm")            # positionless SSM states


def seed_cache(cache: dict, prefill_caches: dict, prompt_len: int,
               slot_mask) -> dict:
    """Merge prefill caches into a full-length cache, by path key.

    cache: the engine's ``init_cache`` tree (vector ``len``);
    prefill_caches: ``prefill``'s stacked caches (seq len = prompt_len);
    slot_mask: (S,) bool -- only masked slots are (re)seeded. Sequence
    leaves pad (or ring-scatter, when prompt_len exceeds the ring length
    S_c) on axis 2 of their (G, S, S_c, ...) layout; SSM states transfer
    unchanged; any other leaf key raises.
    """
    mask = torch.as_tensor(slot_mask, dtype=torch.bool,
                           device=cache["len"].device)
    got_flat = flatten(prefill_caches)
    layers = {}
    for path, full in flatten(cache["layers"]).items():
        key = path[-1]
        if key not in _SEQ_KEYS + _STATE_KEYS:
            raise ValueError(f"unknown cache leaf {key!r} at {path}")
        got = got_flat[path].to(full.dtype)
        if key in _SEQ_KEYS:
            s_c = full.shape[2]
            new = torch.zeros_like(full)
            if prompt_len <= s_c:
                new[:, :, :prompt_len] = got
            else:
                # ring discipline: token t lives at slot t % S_c
                idx = torch.arange(prompt_len - s_c, prompt_len,
                                   device=full.device) % s_c
                new[:, :, idx] = got[:, :, prompt_len - s_c:]
        else:
            new = got
        sel = mask.reshape((1, -1) + (1,) * (new.ndim - 2))
        layers[path] = torch.where(sel, new, full)
    length = torch.where(mask, torch.full_like(cache["len"], prompt_len),
                         cache["len"])
    return {"layers": unflatten(layers), "len": length}


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the FIRST maximum along the last axis, int32, by
    ``jnp.argmax``'s rule: a NaN counts as greater than every number, so a
    row that holds one gives its first NaN, and the token stays in range
    whatever the logits. ``torch.argmax`` keeps that rule on the CPU and
    on the card, where ties and NaNs in different blocks of its reduction
    resolve to the lower index."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _gather(pages: dict, page_ids: torch.Tensor) -> dict:
    """Every (P, ...) page leaf gathered by ``page_ids`` (S,) into (S,
    ...), the ids taken as the reference's ``leaf[page_ids]`` takes them
    (``page_index``: negative from the end, then clamped to [0, P - 1])."""
    leaf = next(_leaves(pages))
    idx = page_index(page_ids.to(leaf.device), leaf.shape[0])

    def take(tree):
        return {k: (take(v) if isinstance(v, dict) else v[idx])
                for k, v in tree.items()}
    return take(pages)


class ServingEngine:
    """Fixed-slot multi-tenant engine over a published adapter snapshot.

    ``last_logits`` holds the (S, V) last-position logits of the latest
    call, for callers that check the greedy choice's margin."""

    def __init__(self, model, params: dict, store: AdapterStore, *,
                 max_len: int, slots: int):
        if store.published is None:
            raise ValueError("AdapterStore has no published snapshot; "
                             "stage adapters and publish() first")
        self.model = model
        self.store = store
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.base, _ = split_lora(params)
        dev = model.device
        self.cache = model.init_cache(self.slots, self.max_len)
        self.cache["len"] = torch.zeros(self.slots, dtype=torch.int32,
                                        device=dev)
        self.tokens = torch.zeros(self.slots, dtype=torch.int32, device=dev)
        self.slot_pages = torch.zeros(self.slots, dtype=torch.int32,
                                      device=dev)
        self.version_log: List[int] = []     # one snapshot version per call
        self.last_logits = None
        self._scales = torch.ones(self.slots, dtype=torch.float32,
                                  device=dev)

    @torch.no_grad()
    def admit(self, slot_idx: Sequence[int], prompts,
              adapter_ids: Sequence[Any]) -> torch.Tensor:
        """Prefill ``prompts`` ((n, L) int) into slots ``slot_idx`` with
        tenants ``adapter_ids``; returns the first greedy token of each
        admitted request. One adapter snapshot for the whole call."""
        snap = self.store.published            # THE capture
        self.version_log.append(snap.version)
        dev = self.model.device
        slot_idx = list(slot_idx)
        adapter_ids = list(adapter_ids)
        prompts = torch.as_tensor(prompts, device=dev).to(torch.int32)
        n, lp = prompts.shape
        if not len(slot_idx) == n == len(adapter_ids):
            raise ValueError(f"{len(slot_idx)} slots, {n} prompts and "
                             f"{len(adapter_ids)} tenants do not match")
        rows = torch.tensor(slot_idx, dtype=torch.long, device=dev)
        # full-width prefill: unadmitted rows run on zeros and are discarded
        full_prompts = torch.zeros((self.slots, lp), dtype=torch.int32,
                                   device=dev)
        full_prompts[rows] = prompts
        new_pages = self.slot_pages.clone()
        new_pages[rows] = snap.page_ids(adapter_ids).to(dev)
        logits, caches = self.model.prefill_clients(
            self.base, _gather(snap.pages, new_pages),
            {"tokens": full_prompts[:, None]}, self._scales)
        self.last_logits = logits[:, 0, -1]
        next_tok = greedy(self.last_logits)
        mask = torch.zeros(self.slots, dtype=torch.bool, device=dev)
        mask[rows] = True
        self.cache = seed_cache(self.cache, caches, lp, mask)
        self.tokens = torch.where(mask, next_tok, self.tokens)
        self.slot_pages = new_pages
        return next_tok[rows]

    @torch.no_grad()
    def decode(self, active_mask) -> torch.Tensor:
        """One greedy decode step for every active slot; inactive slots are
        frozen (token, every cache leaf and ``len``). Returns the (S,)
        token vector. One adapter snapshot for the whole step."""
        snap = self.store.published            # THE capture
        self.version_log.append(snap.version)
        active = torch.as_tensor(active_mask, dtype=torch.bool,
                                 device=self.model.device)
        logits, new_cache = self.model.decode_step_clients(
            self.base, _gather(snap.pages, self.slot_pages),
            {"token": self.tokens[:, None, None]}, self.cache, self._scales)
        self.last_logits = logits[:, 0, -1]
        self.tokens = torch.where(active, greedy(self.last_logits),
                                  self.tokens)
        old = flatten(self.cache["layers"])
        layers = {path: torch.where(
            active.reshape((1, -1) + (1,) * (new.ndim - 2)), new, old[path])
            for path, new in flatten(new_cache["layers"]).items()}
        self.cache = {"layers": unflatten(layers),
                      "len": torch.where(active, new_cache["len"],
                                         self.cache["len"])}
        return self.tokens

    def slot_len(self) -> torch.Tensor:
        return self.cache["len"]
