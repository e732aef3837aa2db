"""Lane-count bootstrap for the sharded paths, the port's counterpart of
the reference's simulated multi-device host (DESIGN.md §9).

The reference forces the XLA host platform to show N devices, so that
its sharded engines default to N shards. The port's shards are lanes on
CUDA streams, round robin over the visible cards
(``launch/mesh.shard_devices``, ``engine/sharded``), so its counterpart
sets the lane count ``mesh.shard_devices(None)`` gives when the caller
names none. The setting is process-wide, as the reference's device count
is: call ``force_host_devices`` at the top of an entry point. This module
imports nothing heavy, and no environment variable is read or written.
"""
from __future__ import annotations

import sys

_lanes: int | None = None


def force_host_devices(n: int = 8, *, when_flag: str | None = None) -> None:
    """Idempotently make ``mesh.shard_devices(None)`` give ``n`` lanes.

    The first setting wins: a later call is a no-op. ``when_flag``
    restricts the bootstrap to invocations carrying that CLI flag, in
    either the ``--flag value`` or ``--flag=value`` spelling."""
    global _lanes
    if when_flag is not None and not any(
            a == when_flag or a.startswith(when_flag + "=")
            for a in sys.argv):
        return
    if _lanes is not None:
        return
    if n < 1:
        raise ValueError(f"lane count {n} < 1")
    _lanes = int(n)


def forced_lanes() -> int | None:
    """The lane count ``force_host_devices`` set, or None."""
    return _lanes
