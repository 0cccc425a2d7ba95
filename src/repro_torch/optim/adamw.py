"""AdamW over flat {path: tensor} parameter dicts with a per-client step
count (port of ``repro/optim/adamw.py``).

Parameters may carry a leading client axis C; ``step`` is then a (C,)
vector so every client's bias correction sees its own step index, as the
reference's vmapped optimizer state does. A slice whose gradient is
exactly zero from the start keeps m = v = 0 and moves by 0 / (0 + eps) = 0,
so rank-masked adapter slices stay exactly zero.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # () or (C,) int32
    mu: Dict[tuple, torch.Tensor]
    nu: Dict[tuple, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Dict[tuple, torch.Tensor],
             num_clients: int = 0) -> AdamWState:
        """``num_clients`` > 0: a (C,) step vector for client-stacked
        parameters; 0: a scalar step."""
        device = next(iter(params.values())).device
        shape = (num_clients,) if num_clients else ()
        zeros = {p: torch.zeros_like(x, dtype=torch.float32)
                 for p, x in params.items()}
        return AdamWState(torch.zeros(shape, dtype=torch.int32, device=device),
                          zeros, {p: z.clone() for p, z in zeros.items()})

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr: float):
        step = state.step + 1
        stepf = step.float()
        c1 = 1.0 - self.b1 ** stepf
        c2 = 1.0 - self.b2 ** stepf
        new_params, mu, nu = {}, {}, {}
        for path, p in params.items():
            g32 = grads[path].float()
            m = self.b1 * state.mu[path] + (1 - self.b1) * g32
            v = self.b2 * state.nu[path] + (1 - self.b2) * torch.square(g32)
            # per-client corrections broadcast over each client's slice
            shape = (-1,) + (1,) * (p.ndim - 1) if stepf.ndim else ()
            mhat = m / c1.reshape(shape)
            vhat = v / c2.reshape(shape)
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            new_params[path] = (p.float() - lr * delta).to(p.dtype)
            mu[path], nu[path] = m, v
        return new_params, AdamWState(step, mu, nu)
