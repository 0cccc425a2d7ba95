"""Compressed update transport with error feedback (DESIGN.md §12), a port
of ``repro/federation/transport.py``.

Clients ship quantized factors instead of f32: each paper-layout pair
(B (..., d, r), A (..., r, n)) is encoded per RANK COLUMN with absmax
scales -- B's scale is the absmax over its d rows per column
((..., 1, r)), A's the absmax over its n entries per row ((..., r, 1)) --
so a zero column (every column beyond a client's rank in the masked
layout) gets scale exactly 0 and decodes to exactly zero. Every consumer
dequantizes BEFORE weighting, so the rank-partition math downstream is
unchanged.

DoRA magnitudes (``(parent, "m")`` entries, (..., out) vectors that are
FedAvg'd, not rank-structured) ship uncompressed and keep no residual.

Error feedback: the encoder compresses x' = x + e, where e is the
client's residual from its previous participation, and keeps
e' = x' - deq(q); over K rounds the residuals telescope,
sum_t deq(q_t) = sum_t x_t + e_0 - e_K. Optional top-k keeps the k most
energetic rank columns (||B_col|| * ||A_row||); the dropped mass lands in
the residual.

The arithmetic is the reference's program as XLA compiles it on the CPU,
so the same inputs give the same payload, scales and residuals bit for
bit: the scale is absmax times f32(1/127) (XLA turns the division by the
constant into that product), the payload rounds x / scale half to even
(``torch.round``, as ``jnp.round``), and the residual x - q * scale is
rounded once, as XLA's fused multiply-add does -- computed here in f64,
where it is exact (|x - q * scale| <= scale / 2, so the subtraction is
exact by Sterbenz's lemma), and rounded to f32. Where the reference keeps
its accumulators as host numpy and reads the device once a round late,
here they stay tensors on the factors' device: encoding never
synchronizes with the host. ``state_arrays`` (checkpoints) is the one
device read.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

# the layout's one decoder lives with the kernels that consume it
from repro_torch.kernels.ops import dequantize, is_quantized  # noqa: F401

MODES = ("int8", "bf16")
_INV_127 = float(np.float32(1.0 / 127.0))     # exact in f32


class QuantFactor(NamedTuple):
    """One quantized factor: an int8 (absmax grid) or bf16 (scale 1)
    payload ``q`` and f32 per-column scales, (..., 1, r) for B factors and
    (..., r, 1) for A factors, exactly 0 for all-zero columns."""
    q: torch.Tensor
    scale: torch.Tensor


def _quantize(x: torch.Tensor, axis: int, mode: str) -> QuantFactor:
    """Per-column absmax quantization along ``axis`` (kept as size 1)."""
    if mode == "bf16":
        ones = torch.ones_like(torch.amax(x, dim=axis, keepdim=True))
        return QuantFactor(x.to(torch.bfloat16), ones)
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = amax * _INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    q = torch.where(scale > 0, q, torch.zeros_like(q))
    return QuantFactor(q, scale)


def _topk_mask(b: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """(..., r) keep-mask of the k most energetic rank columns; every
    nonzero column survives when fewer than k are nonzero. The k-th
    largest comes from an ascending sort of -energy, as the reference
    takes it, so a NaN column sorts last (a descending sort puts it
    first)."""
    eb = torch.sqrt(torch.sum(b * b, dim=-2))
    ea = torch.sqrt(torch.sum(a * a, dim=-1))
    energy = eb * ea
    thr = -torch.sort(-energy, dim=-1).values[..., k - 1:k]
    return ((energy >= thr) | (thr <= 0)).to(b.dtype)


@torch.no_grad()
def _encode_pair(b, a, eb, ea, *, mode: str, top_k: Optional[int]):
    """Quantize one (B, A) pair with error feedback. Returns (qb, qa, rb,
    ra): the QuantFactor pair and the new residuals x + e - deq."""
    xb = b.float() + eb
    xa = a.float() + ea
    yb, ya = xb, xa
    if top_k is not None and top_k < b.shape[-1]:
        mask = _topk_mask(xb, xa, top_k)
        yb = xb * mask[..., None, :]
        ya = xa * mask[..., :, None]
    qb = _quantize(yb, axis=-2, mode=mode)          # B: absmax over d rows
    qa = _quantize(ya, axis=-1, mode=mode)          # A: absmax over n cols
    return qb, qa, _residual(xb, qb), _residual(xa, qa)


def _residual(x: torch.Tensor, qf: QuantFactor) -> torch.Tensor:
    """x - q * scale with one rounding (see the module docstring)."""
    return (x.double() - qf.q.double() * qf.scale.double()).float()


def _gather_residuals(residuals: Dict[tuple, tuple], gather
                      ) -> Dict[tuple, tuple]:
    """{parent: (rb, ra)} block stacks -> every rank's, through one
    ``gather`` of all of them flattened side by side."""
    flat = [t for pair in residuals.values() for t in pair]
    width = flat[0].shape[0]
    full = gather(torch.cat([t.reshape(width, -1) for t in flat], dim=1))
    parts = iter(torch.split(full, [t[0].numel() for t in flat], dim=1))
    return {parent: tuple(next(parts).reshape((full.shape[0],)
                                              + tuple(t.shape[1:]))
                          for t in pair)
            for parent, pair in residuals.items()}


def is_magnitude(parent) -> bool:
    """A DoRA magnitude entry ``(parent, "m")``: shipped uncompressed."""
    return (len(parent) == 2 and isinstance(parent[0], tuple)
            and parent[1] == "m")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """``mode`` "int8" or "bf16"; ``error_feedback`` carries per-client
    residuals; ``top_k`` keeps the k most energetic rank columns per
    adapter (None: all)."""
    mode: str = "int8"
    error_feedback: bool = True
    top_k: Optional[int] = None

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        assert self.top_k is None or self.top_k >= 1, self.top_k


class UpdateTransport:
    """Stateful encoder: per-(client, adapter) error-feedback residuals
    (f32 tensors, kept where they were made) and the quantizer."""

    def __init__(self, config: Optional[TransportConfig] = None, **kw):
        self.cfg = config if config is not None else TransportConfig(**kw)
        # cid -> parent -> (eb, ea)
        self._acc: Dict[int, Dict[tuple, Tuple[torch.Tensor,
                                               torch.Tensor]]] = {}

    # -- encoding ------------------------------------------------------------

    def encode_group(self, client_ids: List[int],
                     factors: Dict[tuple, tuple], *,
                     replicate: Optional[tuple] = None
                     ) -> Dict[tuple, tuple]:
        """Encode one grouped-engine factor stack ({parent: (B, A)} with a
        leading client axis). ``client_ids[j]`` is the GLOBAL client id at
        stacked position j, or -1 for a ghost (zero residual in, residual
        out discarded).

        ``replicate`` (the sharded engine): (all_ids, gather), where the
        stack is this rank's block of the group whose ids are
        ``all_ids``, and ``gather`` maps a block-stacked tensor to every
        rank's blocks (``core.collective.gather_blocks``). The accumulators
        are keyed by client and a client lands on another rank from round
        to round, so every rank keeps every client's residual: the
        residuals of all parents travel in ONE gather a group."""
        out, residuals = {}, {}
        for parent, val in factors.items():
            if is_magnitude(parent):
                out[parent] = val
                continue
            b, a = val
            eb, ea = self._residual_stack(client_ids, parent, b, a)
            qb, qa, rb, ra = _encode_pair(b, a, eb, ea, mode=self.cfg.mode,
                                          top_k=self.cfg.top_k)
            out[parent] = (qb, qa)
            residuals[parent] = (rb, ra)
        if self.cfg.error_feedback:
            if replicate is not None:
                client_ids, gather = replicate
                residuals = _gather_residuals(residuals, gather)
            for parent, (rb, ra) in residuals.items():
                for j, cid in enumerate(client_ids):
                    if cid >= 0:
                        self._acc.setdefault(cid, {})[parent] = (rb[j],
                                                                 ra[j])
        return out

    def encode_client(self, cid: int,
                      factors: Dict[tuple, tuple]) -> Dict[tuple, tuple]:
        """Sequential-engine variant: one client's rank-r_k factors
        ((..., d, r_k) / (..., r_k, n), no client axis)."""
        out, residuals = {}, {}
        for parent, val in factors.items():
            if is_magnitude(parent):
                out[parent] = val
                continue
            b, a = val
            eb, ea = self._residual_one(cid, parent, b, a)
            qb, qa, rb, ra = _encode_pair(b, a, eb, ea, mode=self.cfg.mode,
                                          top_k=self.cfg.top_k)
            out[parent] = (qb, qa)
            residuals[parent] = (rb, ra)
        if self.cfg.error_feedback:
            for parent, pair in residuals.items():
                self._acc.setdefault(cid, {})[parent] = pair
        return out

    # -- error-feedback accumulators ----------------------------------------

    def _get(self, cid, parent, b_shape, a_shape):
        """The stored residual pair when its shapes match, else None (e.g.
        a client re-encoding at another rank)."""
        got = self._acc.get(cid, {}).get(parent)
        if got is not None and tuple(got[0].shape) == tuple(b_shape) \
                and tuple(got[1].shape) == tuple(a_shape):
            return got
        return None

    def _residual_stack(self, client_ids, parent, b, a):
        """Previous residuals stacked in client order on b's device (zeros
        where absent)."""
        eb = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        ea = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        for j, cid in enumerate(client_ids):
            got = self._get(cid, parent, b.shape[1:], a.shape[1:])
            if got is not None:
                eb[j] = got[0]
                ea[j] = got[1]
        return eb, ea

    def _residual_one(self, cid, parent, b, a):
        got = self._get(cid, parent, b.shape, a.shape)
        if got is not None:
            return got[0].to(b.device), got[1].to(a.device)
        return (torch.zeros(b.shape, dtype=torch.float32, device=b.device),
                torch.zeros(a.shape, dtype=torch.float32, device=a.device))

    # -- checkpoint state (flat npz, bit-exact f32) --------------------------

    def has_state(self) -> bool:
        return bool(self._acc)

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """{"c{cid}/{adapter path}/b|a": residual}, np.float32, the
        reference's keys: the checkpoints load in either package."""
        out: Dict[str, np.ndarray] = {}
        for cid in sorted(self._acc):
            for parent, (eb, ea) in self._acc[cid].items():
                key = f"c{cid}/" + "/".join(parent)
                out[key + "/b"] = eb.detach().cpu().numpy().astype(np.float32)
                out[key + "/a"] = ea.detach().cpu().numpy().astype(np.float32)
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Inverse of ``state_arrays``; the residuals move to the factors'
        device at their next use."""
        self.reset()
        pairs: Dict[tuple, dict] = {}
        for key, arr in arrays.items():
            cid_s, rest = key.split("/", 1)
            path, leaf = rest.rsplit("/", 1)
            pairs.setdefault((int(cid_s[1:]), tuple(path.split("/"))),
                             {})[leaf] = torch.from_numpy(
                np.array(arr, dtype=np.float32))
        for (cid, parent), ba in pairs.items():
            self._acc.setdefault(cid, {})[parent] = (ba["b"], ba["a"])

    def reset(self) -> None:
        self._acc = {}

    # -- reporting -----------------------------------------------------------

    def payload_bytes(self, d: int, n: int, r: int) -> int:
        """Wire bytes of one encoded (B, A) adapter pair at (d, r, n)."""
        itemsize = 1 if self.cfg.mode == "int8" else 2
        return (d * r + r * n) * itemsize + (r + r) * 4   # payload + scales
