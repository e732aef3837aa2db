"""Where the sharded scan engine's shard lanes run. Functions, not module
constants: importing this module touches no CUDA state.

The reference's mesh builders (``make_mesh_compat`` and the production
meshes) belong to the training and launch substrate and are not here.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


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
    (engine/sharded.py)."""
    dev = resolve_device(device)
    n = host_device_count(dev)
    if n_shards is None:
        n_shards = n
    if dev.type != "cuda":
        return [dev] * n_shards
    return [torch.device("cuda", i % n) for i in range(n_shards)]
