"""Elastic checkpointing (fault tolerance substrate; DESIGN.md §8), the
port of the reference's ``train/checkpoint.py``, in its on-disk format.

Layout: <dir>/step_<n>/manifest.json + one .npy per tree leaf, the leaves
in JAX's flatten order (dict keys sorted, list indices:
``train/optimizer.tree_leaves``), keyed by their "/"-joined paths. The
manifest records the keys, dtypes, shapes, step, and the mesh shape at
save time; bfloat16 (and fp8) leaves are stored as a 16-bit (8-bit)
unsigned integer view and re-viewed on load from the manifest's dtype
string, as the reference does. Tensors cross to numpy through
``Tensor.view`` of the same width: nothing here needs ``ml_dtypes``. A
checkpoint written by either package restores in the other.

``restore`` places every leaf on the CURRENT mesh under the sharding
policy's placements (``sharding.policy.param_shardings``) — so a
checkpoint taken on one mesh restores onto a different mesh (elastic
scale up/down) — or, with no mesh, on ``device`` (the card unless the
caller asks for the CPU). A 0-d leaf (an optimizer's step count) is put
on the host, where the port's optimizers keep it.

Writes are atomic (tmp dir + rename) so a failure mid-save never corrupts
the latest complete checkpoint. In a job of several ranks every rank
gathers the sharded leaves (a collective), rank 0 writes, and all wait
for the write.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding.policy import Placements, param_shardings
from repro_torch.train.optimizer import (tree_leaves, tree_leaves_with_path,
                                         tree_unflatten)

# numpy has no bfloat16 or fp8: such leaves go to disk as unsigned
# integers of the same width, viewed back on load.
_VIEW_AS = {"bfloat16": (torch.int16, np.uint16),
            "float8_e4m3fn": (torch.uint8, np.uint8),
            "float8_e5m2": (torch.uint8, np.uint8)}
_SIGNED = {np.uint16: np.int16, np.uint8: np.uint8}


def _flatten_with_paths(tree):
    """[(key, leaf)] in ``tree_leaves`` order, the key the "/"-joined
    path."""
    return [("/".join(map(str, path)), x)
            for path, x in tree_leaves_with_path(tree)]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_copy(leaf):
    """(numpy array, dtype name) of a leaf: a fresh host copy, since the
    caller may change the tensor next; bfloat16 as its uint16 view.
    DTensors are gathered first, a collective every rank joins."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    src = torch.as_tensor(leaf).detach()
    # a card's tensor lands in pinned memory (a copy at the bus's rate;
    # PyTorch keeps the pinned blocks for the next save)
    t = torch.empty(src.shape, dtype=src.dtype,
                    pin_memory=src.device.type == "cuda")
    t.copy_(src)
    name = str(t.dtype).removeprefix("torch.")
    if name in _VIEW_AS:
        tview, nview = _VIEW_AS[name]
        return t.view(tview).numpy().view(nview), name
    return t.numpy(), name


def _mesh_shape(mesh):
    return list(tuple(mesh.shape)) if mesh is not None else None


def save(ckpt_dir, step: int, tree, *, mesh=None, keep: int = 3):
    leaves = [(k, _host_copy(x)) for k, x in _flatten_with_paths(tree)]
    final = Path(ckpt_dir) / f"step_{step}"
    if _rank() == 0:
        _write(Path(ckpt_dir), step, leaves, _mesh_shape(mesh), keep)
    _barrier()
    return final


def _write(ckpt_dir: Path, step: int, leaves, mesh_shape, keep: int):
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "mesh_shape": mesh_shape}
    for i, (key, (arr, dtype)) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "dtype": dtype,
             "shape": list(arr.shape)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]), p)
                   for p in ckpt_dir.glob("step_*"))
    for _, p in steps[:-keep]:
        shutil.rmtree(p)


class AsyncSaver:
    """Overlap checkpoint IO with training: the host copy happens on the
    caller (a CUDA tensor's copy to the host is finished before ``save``
    returns, so the next step's kernels may write the tensor; a CPU
    tensor is copied, not shared), serialization runs on a background
    thread. ``wait()`` joins the in-flight save; a new save waits for the
    previous one (at most one in flight)."""

    def __init__(self):
        self._thread = None

    def save(self, ckpt_dir, step: int, tree, *, mesh=None, keep: int = 3):
        self.wait()
        leaves = [(k, _host_copy(x)) for k, x in _flatten_with_paths(tree)]
        if _rank() != 0:
            return
        self._thread = threading.Thread(
            target=_write, args=(Path(ckpt_dir), step, leaves,
                                 _mesh_shape(mesh), keep), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def _load(path: Path, meta) -> torch.Tensor:
    arr = np.load(path / meta["file"])
    if meta["dtype"] in _VIEW_AS:
        tview, nview = _VIEW_AS[meta["dtype"]]
        return torch.from_numpy(arr.view(_SIGNED[nview])).view(
            getattr(torch, meta["dtype"]))
    return torch.from_numpy(arr)


def restore(ckpt_dir, step: int, tree_like, *, mesh=None, sharding_fn=None,
            device=None):
    """tree_like: a tree (tensors or meta tensors) giving the target
    structure. sharding_fn(tree_like, mesh) -> placements tree; defaults
    to the sharding policy's. With a mesh the leaves become DTensors on
    the CURRENT mesh (elastic restore); without one they go to ``device``
    (default: the card)."""
    path = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    flat = tree_leaves(tree_like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: {len(flat)} vs "
                         f"{len(manifest['leaves'])}")
    shardings = None
    if mesh is not None:
        placed = (sharding_fn or param_shardings)(tree_like, mesh)
        shardings = tree_leaves(placed, lambda x: isinstance(x, Placements))
        dev = resolve_device(mesh.device_type)
    else:
        dev = resolve_device(device)
    out = []
    for i, meta in enumerate(manifest["leaves"]):
        t = _load(path, meta)
        if t.dim() == 0:
            out.append(t)
        elif shardings is not None:
            from torch.distributed.tensor import distribute_tensor
            out.append(distribute_tensor(t.to(dev), mesh, shardings[i],
                                         src_data_rank=None))
        else:
            out.append(t.to(dev))
    return tree_unflatten(tree_like, out)
