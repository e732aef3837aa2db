"""Device meshes over the ranks of this job, and where the sharded scan
engine's shard lanes run. Functions, not module constants: importing this
module touches no CUDA state and starts no process group.

``make_mesh_compat(shape, axes)`` is ``init_device_mesh`` over the
default process group. A process started without ``torchrun`` (no
``WORLD_SIZE`` in its environment) gets a world of 1, in a store of its
own (``dist.HashStore``): NCCL on the card, gloo on the CPU. Every mesh
builder runs on the card unless the caller asks for the CPU, and raises
without a card.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.devsim import forced_lanes


def init_world(device=None) -> int:
    """The default process group, initialized if it is not yet: from the
    environment under ``torchrun`` (``WORLD_SIZE`` set), else a world of
    1. Returns the world size."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return dist.get_world_size()


def make_mesh_compat(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    job (their count must be the shape's product)."""
    dev = resolve_device(device)
    world = init_world(dev)
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the job has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data 16, model 16), or (pod 2, data 16, model 16): 256 or 512
    ranks, or it raises. ``sharding.policy.MeshShape`` computes these
    meshes' specs without the ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, device)


def make_host_mesh(model_axis: int = 1, data_axis: int | None = None,
                   device=None):
    """(data, model) mesh over the ranks present (one card, or the
    processes of a ``torchrun`` job)."""
    n = init_world(device)
    data_axis = data_axis or (n // model_axis)
    return make_mesh_compat((data_axis, model_axis), ("data", "model"),
                            device)


# --------------------------------------------------- scan-shard placement --
def host_device_count(device=None) -> int:
    """Devices of ``device``'s type visible to this process (default
    ``cuda``): ``torch.cuda.device_count()`` GPUs, or one CPU. A CUDA
    request without a card raises."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def shard_devices(n_shards: int | None = None, device=None) -> list:
    """Device placement for the sharded scan engine (DESIGN.md §9): one
    device per shard, round-robin over the visible GPUs when shards
    outnumber them (on the CPU, every shard on the one CPU). Shards that
    share a device run as lanes on CUDA streams of their own
    (engine/sharded.py). ``n_shards`` None: the lane count
    ``launch/devsim.force_host_devices`` set, else one a device."""
    dev = resolve_device(device)
    n = host_device_count(dev)
    if n_shards is None:
        n_shards = forced_lanes() or n
    if dev.type != "cuda":
        return [dev] * n_shards
    return [torch.device("cuda", i % n) for i in range(n_shards)]
