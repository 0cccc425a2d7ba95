"""How the parameter inits put their leaves: new, or into given tensors.

Every init takes ``out``: None, or the tree of tensors its leaves go into
(``Model.init`` hands each layer group's init the group's slices of the
stacked leaves). ``normal`` and ``keep`` put one leaf. Without ``out``
they return a new tensor; with it they write into it in place and return
it, so no drawn tensor exists beside its destination.

``normal`` is ``(torch.randn(shape) * scale).to(dtype)``, the one draw
every init makes; into ``out`` it is ``out.normal_().mul_(scale)``. In f32
the two are bit for bit the same (``randn`` is ``empty().normal_()`` and
the scaling is the same f32 multiply); in another dtype the in-place draw
and scaling round in that dtype, and only the distribution is the plain
draw's. On the meta device nothing is drawn (a meta tensor holds no
values): ``normal`` gives the empty leaf, which spares a meta-device
random op its one-off import of ``torch._dynamo`` (seconds).
"""
from __future__ import annotations

from typing import Optional

import torch


def sub(out: Optional[dict], key: str):
    """``out``'s subtree or leaf ``key``; None without ``out``."""
    return None if out is None else out[key]


def _check(out: torch.Tensor, shape, dtype) -> None:
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise ValueError(f"a leaf of {tuple(shape)} {dtype} does not fit "
                         f"its destination {tuple(out.shape)} {out.dtype}")


def normal(gen: Optional[torch.Generator], shape, scale: float,
           dtype=torch.float32, device=None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0, scale**2) of ``shape`` in ``dtype``, or drawn into ``out``."""
    if out is None:
        if device is not None and torch.device(device).type == "meta":
            return torch.empty(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)
    _check(out, shape, dtype)
    if out.is_meta:
        return out
    return out.normal_(generator=gen).mul_(scale)


def keep(t: torch.Tensor, out: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """A leaf that is not drawn: ``t``, or ``t`` copied into ``out``."""
    if out is None:
        return t
    _check(out, t.shape, t.dtype)
    return out.copy_(t)
