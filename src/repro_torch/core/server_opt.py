"""Server momentum on LOW-RANK factors (beyond-paper), a port of
``repro/core/server_opt.py``.

FedAvgM on the factored adapters: every quantity (momentum m_t, the update
Delta_t, the new global) is a rank-r_max (B, A) pair kept by truncated
SVD of a factor stack, never a (d, n) buffer:

    Delta_t = B'A' - BA                      (rank <= 2 r_max, as a stack)
    m_t     = trunc_svd([sqrt(beta) B_m | B' | B],
                        [sqrt(beta) A_m ; A' ; -A])       (rank r_max)
    W^{t+1} = trunc_svd([B | eta B_m^t], [A ; A_m^t])     (rank r_max)

``apply`` takes one adapter (the sequential engine), ``apply_bucket`` one
whole shape bucket (the grouped engines); the truncation
(``svd_realloc_factored``) batches over every leading axis natively.
Bucket state lives stacked under the bucket key; checkpoints always
serialize per adapter, with the reference's keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.svd import svd_realloc_factored


def _stack(*pairs):
    """pairs of (B (..., d, r), A (..., r, n)) -> concatenated factors."""
    us = torch.cat([b for b, _ in pairs], dim=-1)
    vs = torch.cat([a for _, a in pairs], dim=-2)
    return us, vs


def _trunc(u, v, r_max):
    """Rank-r_max truncation of a factor stack over any leading axes."""
    b, a, _ = svd_realloc_factored(u, v, r_max)
    return b, a


def _momentum_step(old_b, old_a, new_b, new_a, state_b, state_a, beta, eta,
                   r_max):
    """One momentum update on (possibly batch-stacked) factor pairs.
    ``state_b`` None means no momentum yet: m_0 = Delta_0 exactly."""
    du, dv = _stack((new_b, new_a), (old_b, -old_a))
    if state_b is None:
        mu, mv = du, dv
    else:
        sq = beta ** 0.5
        mu, mv = _stack((sq * state_b, sq * state_a), (du, dv))
    b_m, a_m = _trunc(mu, mv, r_max)
    gu, gv = _stack((old_b, old_a), (eta * b_m, a_m))
    b_g, a_g = _trunc(gu, gv, r_max)
    return b_g, a_g, b_m, a_m


@dataclass
class FactoredServerMomentum:
    """FedAvgM on factored adapters. state: {adapter: (B_m, A_m)}, or
    {bucket (tuple of adapters): stacked (B_m, A_m)}."""

    beta: float = 0.9
    eta: float = 1.0
    state: Optional[Dict] = None
    bucket_calls: int = 0       # apply_bucket calls so far

    def apply(self, adapter_key, old_ba: Tuple, new_ba: Tuple,
              r_max: int) -> Tuple:
        """old/new (B, A) of one adapter -> the momentum-corrected (B, A)."""
        if self.state is None:
            self.state = {}
        prev = self.state.get(adapter_key)
        b_g, a_g, b_m, a_m = _momentum_step(
            *old_ba, *new_ba,
            None if prev is None else prev[0],
            None if prev is None else prev[1],
            self.beta, self.eta, r_max)
        self.state[adapter_key] = (b_m, a_m)
        return b_g, a_g

    def apply_bucket(self, adapter_keys: Sequence, old_pairs: Sequence[Tuple],
                     new_b, new_a, r_max: int) -> Tuple:
        """Momentum for a whole shape bucket: ``old_pairs`` the global
        (B, A) per adapter in bucket order, ``new_b``/``new_a`` the
        aggregation's (P, ..., d, r_max)/(P, ..., r_max, n) stacks. The
        same math as ``apply``, batched over the bucket axis. Per-adapter
        entries (from ``apply`` or a restored checkpoint) migrate into the
        bucket stack at first use."""
        if self.state is None:
            self.state = {}
        bucket_key = tuple(adapter_keys)
        prev = self.state.get(bucket_key)
        if prev is None and all(k in self.state for k in adapter_keys):
            prev = (torch.stack([self.state[k][0] for k in adapter_keys]),
                    torch.stack([self.state[k][1] for k in adapter_keys]))
            for k in adapter_keys:
                del self.state[k]
        b_g, a_g, b_m, a_m = _momentum_step(
            torch.stack([b for b, _ in old_pairs]),
            torch.stack([a for _, a in old_pairs]), new_b, new_a,
            None if prev is None else prev[0],
            None if prev is None else prev[1],
            self.beta, self.eta, r_max)
        self.bucket_calls += 1
        self.state[bucket_key] = (b_m, a_m)
        return b_g, a_g

    # -- checkpointing ------------------------------------------------------

    @staticmethod
    def _is_bucket_key(key) -> bool:
        return (isinstance(key, tuple) and len(key) > 0
                and isinstance(key[0], tuple))

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """{"<adapter path joined by '/'>/B_m" | ".../A_m": array}, always
        per adapter (bucket stacks are sliced): engine- and
        package-portable."""
        def host(x):
            return x.detach().cpu().numpy()
        out: Dict[str, np.ndarray] = {}
        for key, (b_m, a_m) in (self.state or {}).items():
            if self._is_bucket_key(key):
                for j, adapter in enumerate(key):
                    name = "/".join(adapter)
                    out[name + "/B_m"] = host(b_m[j])
                    out[name + "/A_m"] = host(a_m[j])
            else:
                name = "/".join(key) if isinstance(key, tuple) else str(key)
                out[name + "/B_m"] = host(b_m)
                out[name + "/A_m"] = host(a_m)
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray],
                          device=None) -> None:
        """Inverse of ``state_arrays``: {adapter: (B_m, A_m)} on
        ``device`` (the CPU when None)."""
        state: Dict = {}
        for name, arr in arrays.items():
            path, leaf = name.rsplit("/", 1)
            pair = state.setdefault(tuple(path.split("/")), [None, None])
            pair[0 if leaf == "B_m" else 1] = torch.as_tensor(
                np.asarray(arr), device=device)
        for key, (b_m, a_m) in state.items():
            assert b_m is not None and a_m is not None, key
        self.state = {k: (b, a) for k, (b, a) in state.items()}
