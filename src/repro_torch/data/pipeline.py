"""Host data pipeline: sharding-aware batching + background prefetch
(compute/IO overlap — DESIGN.md §6), the port of the reference's
``data/pipeline.py``."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch


class Prefetcher:
    """Runs the producer iterator on a background thread with a bounded
    buffer, overlapping host batch preparation with device compute."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.err = None

        def worker():
            try:
                for item in it:
                    self.q.put(item)
            except BaseException as e:  # propagate to consumer
                self.err = e
            finally:
                self.q.put(self.done)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self.done:
                if self.err:
                    raise self.err
                return
            yield item


def dp_rank(mesh) -> tuple[int, int]:
    """(this rank's index among the data-parallel ranks, their count):
    the mesh coordinate over ('pod', 'data'), pod major."""
    from repro_torch.sharding.policy import dp_axes, mesh_axes
    sizes = mesh_axes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    r, n = 0, 1
    for a in dp_axes(mesh):
        r = r * sizes[a] + coord[a]
        n *= sizes[a]
    return r, n


def rank_rows(n_rows: int, n_micro: int, rank: int, n_ranks: int):
    """The global rows a data-parallel rank computes when a batch of
    ``n_rows`` is cut into ``n_micro`` contiguous micro-batches and each
    micro-batch over the ranks (the reference's SPMD step: micro-batch i
    is rows [i*mb, (i+1)*mb), rank r holds its r-th slice), micro-batch
    after micro-batch."""
    if n_rows % n_micro or (n_rows // n_micro) % n_ranks:
        raise ValueError(f"{n_rows} rows do not split into {n_micro} "
                         f"micro-batches of {n_ranks} equal slices")
    mb = n_rows // n_micro
    per = mb // n_ranks
    return np.concatenate([np.arange(i * mb + rank * per,
                                     i * mb + (rank + 1) * per)
                           for i in range(n_micro)])


def shard_batch(batch: dict, mesh, *, n_micro: int = 1,
                batch_axes: dict | None = None) -> dict:
    """This rank's rows of a host batch (numpy arrays or CPU tensors, the
    whole batch on every rank), on the mesh's device: with ``n_micro``
    1 its contiguous block under ``policy.batch_spec``, else its slice of
    each micro-batch (``rank_rows``). ``batch_axes`` names a leaf's batch
    axis where it is not 0 (``mrope_positions``: 1). On the card the rows
    go through pinned host memory, copied with ``non_blocking=True``."""
    batch_axes = batch_axes or {}
    r, n = dp_rank(mesh)
    dev = torch.device(mesh.device_type)
    out = {}
    for k, v in batch.items():
        ax = batch_axes.get(k, 0)
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if n > 1:
            t = t.index_select(ax, torch.from_numpy(
                rank_rows(t.shape[ax], n_micro, r, n)))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def batched(x, y, batch: int, *, seed: int = 0, epochs: int | None = None):
    """Shuffled epoch iterator over (x, y) host arrays."""
    rng = np.random.default_rng(seed)
    n = len(x)
    e = 0
    while epochs is None or e < epochs:
        idx = rng.permutation(n)
        for lo in range(0, n - batch + 1, batch):
            sel = idx[lo:lo + batch]
            yield {"images": x[sel], "labels": y[sel]}
        e += 1
