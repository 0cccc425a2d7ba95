"""The port's process meshes (``repro/launch/mesh.py::make_fl_mesh`` and
``make_host_mesh``).

Each rank of a ``torch.distributed`` process group plays one shard of the
reference's 1-D ``("data",)`` mesh: where the reference runs one
``shard_map`` program over devices and reduces with ``jax.lax.psum``,
every rank here runs the same program on its own block of clients and
reduces with ``all_reduce`` (``core/collective.py``, DESIGN.md §5). The
reference's TPU partition specs (``sharding/specs.py``) have no
counterpart. ``make_host_mesh`` adds the reference's ``"model"`` axis,
over which the expert-parallel MoE shards its experts.

``spawn_ranks`` starts a process group of ``world`` ranks on this host
(the CPU tests' gloo ranks, the benches' shard sweeps); nothing on the
host names a cluster, so it gives each rank the address, world size and
rank itself.
"""
from __future__ import annotations

import os
import pickle
import socket
import tempfile
from datetime import timedelta
from typing import Callable, List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.collective import AXIS
from repro_torch.device import resolve_device


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _process_group(dev: torch.device) -> None:
    """Make a one-rank group over a local store if there is none, and
    refuse an existing group whose backend does not fit ``dev`` (see
    ``make_fl_mesh``); make ``dev`` the current CUDA device."""
    want = default_backend(dev)
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    have = dist.get_backend()
    shared_card = (have == "gloo" and dev.type == "cuda"
                   and dist.get_world_size() > 1)
    if have != want and not shared_card:
        raise ValueError(f"the process group runs {have}; a "
                         f"{dist.get_world_size()}-rank mesh on {dev} "
                         f"needs {want}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())


def make_fl_mesh(*, device=None) -> DeviceMesh:
    """The 1-D ``("data",)`` mesh of the sharded round engine over every
    rank of the process group. Every rank of the group must call it (a
    mesh's group is made collectively). The reference's ``shards`` (the
    first S devices of one process) has no counterpart: a sweep over
    shard counts spawns one group for each (``spawn_ranks``).

    Without a process group, a one-rank group is made in this process
    over a local store (``HashStore``), on ``default_backend(device)``:
    the counterpart of the reference's one-device mesh, on which every
    all-reduce is an identity. Whoever made it destroys it
    (``FederatedLoRA.close``).

    An existing group must run the device's backend, with one exception:
    gloo on CUDA tensors for a group of several ranks, which is how
    ranks share one card (NCCL refuses two ranks on one device). So a
    one-rank gloo group left from a CPU run is refused on the card.

    The rank's card is ``device`` (the model's), made the current CUDA
    device before the mesh: it never comes from the rank number, so
    several ranks may share one card."""
    dev = resolve_device(device)
    _process_group(dev)
    return DeviceMesh(dev.type, list(range(dist.get_world_size())),
                      mesh_dim_names=(AXIS,))


def make_host_mesh(model_axis: int = 1, *, device=None) -> DeviceMesh:
    """The 2-D ``("data", "model")`` mesh over every rank of the process
    group (the reference's ``make_host_mesh``): ``world // model_axis``
    rows of ``model_axis`` ranks, rank r at row ``r // model_axis``. The
    expert-parallel MoE shards its experts over ``"model"``. The group is
    made or checked as ``make_fl_mesh`` does (a one-rank group over a
    local store if there is none; whoever made it destroys it)."""
    dev = resolve_device(device)
    _process_group(dev)
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"{world} ranks do not split into a model axis "
                         f"of {model_axis}")
    ranks = torch.arange(world).reshape(world // model_axis, model_axis)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=(AXIS, "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int,
               backend: str, out: str, args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args,
                backend: str = "gloo") -> List[object]:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes joined in
    one ``backend`` process group on this host; returns each rank's
    result (picklable, off the card), in rank order. A rank that fails
    stops the others and raises here; every process has ended when this
    returns."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as out:
        mp.spawn(_rank_main, args=(fn, world, _free_port(), backend, out,
                                   args), nprocs=world, join=True)
        results = []
        for rank in range(world):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
