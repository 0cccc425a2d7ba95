"""The sharded round engine's collective over a 1-D ``("data",)`` mesh
(``launch.mesh.make_fl_mesh``): each rank of the mesh holds one
contiguous block of every client axis, and each of the reference's
``jax.lax.psum`` reductions is one ``all_reduce`` here (DESIGN.md §5).
The expert-parallel MoE sums over the ``"model"`` axis of a
``("data", "model")`` mesh (``launch.mesh.make_host_mesh``) through the
same counted ``all_reduce``."""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS = "data"


def shard_count(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def shard_index(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(AXIS)


def block(size: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous block of a client axis of ``size`` (a
    multiple of the shard count)."""
    shards = shard_count(mesh)
    assert size % shards == 0, (size, shards)
    width = size // shards
    lo = shard_index(mesh) * width
    return slice(lo, lo + width)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh,
               axis: str = AXIS) -> torch.Tensor:
    """Sum ``x`` over the ranks of the mesh's ``axis``, in place (the
    reference's ``jax.lax.psum``); a failed collective raises. Counted in
    ``all_reduce.calls``, its payload in ``all_reduce.bytes``. Returns
    ``x``."""
    dist.all_reduce(x, group=mesh.get_group(axis))
    all_reduce.calls += 1
    all_reduce.bytes += x.numel() * x.element_size()
    return x


all_reduce.calls = 0
all_reduce.bytes = 0


def gather_blocks(x: torch.Tensor, mesh: DeviceMesh,
                  dim: int = 0) -> torch.Tensor:
    """Every rank's equal-width block along ``dim``, in rank order, on
    every rank: each rank writes its block into a zero tensor of the full
    width and one all-reduce sums them. Every element has one nonzero
    term, so the sum is exact in any dtype (int8 and bf16 payloads too).
    It is the reference's zero-scatter-and-psum, and needs no
    ``all_gather``, which gloo lacks for CUDA tensors."""
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * shard_count(mesh)
    full = x.new_zeros(shape)
    full.narrow(dim, shard_index(mesh) * width, width).copy_(x)
    return all_reduce(full, mesh)


def barrier(mesh: DeviceMesh, device) -> None:
    """Wait on the host until every rank got here (one uncounted
    one-element all-reduce, read back)."""
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag, group=mesh.get_group(AXIS))
    flag.item()
