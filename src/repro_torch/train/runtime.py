"""Fault-tolerant training runtime (DESIGN.md §6/§8), the port of the
reference's ``train/runtime.py``.

The loop treats the step as a pure function of (params, opt_state,
batch) — the port's step builders never write their inputs — which makes
recovery trivial: on ANY step failure we restore the last complete
checkpoint and replay from its step. Features:

* periodic atomic checkpoints (train/checkpoint.py), elastic on restore;
* retry-with-restore on step failure (bounded retries);
* failure injection (``inject_failure_at``) for tests/drills;
* straggler detection: per-step wall-time EMA + z-score; flagged steps are
  logged and counted;
* pluggable gradient-compression (wired inside the step builder).

A step's wall time includes the device's work: the runtime waits for the
step's metrics (``block_until_ready``) before it reads the clock, as the
reference waits with ``jax.block_until_ready``; without that wait the
detector would time kernel launches only.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt


def block_until_ready(tree) -> None:
    """Wait for the devices that hold the tensors of ``tree`` (a dict,
    list or tensor) to finish their queued work."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            block_until_ready(v)
    elif torch.is_tensor(tree) and tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)


@dataclass
class StragglerDetector:
    alpha: float = 0.2
    z_thresh: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= self.warmup:
            # prime the EMA
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        std = max(np.sqrt(self.var), 1e-9)
        z = (dt - self.mean) / std
        slow = z > self.z_thresh
        if slow:
            self.flagged.append((step, dt, float(z)))
        else:  # don't let stragglers poison the baseline
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var \
                + self.alpha * (dt - self.mean) ** 2
        return slow


@dataclass
class RuntimeConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    max_retries: int = 3
    keep: int = 3
    async_save: bool = False   # overlap checkpoint IO with training


class TrainRuntime:
    """``mesh``: the mesh the state lives on (restores place leaves on
    it); without one, restores go to ``device`` (default: the card)."""

    def __init__(self, step_fn: Callable, cfg: RuntimeConfig, *,
                 mesh=None, device=None, log: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.cfg = cfg
        self.mesh = mesh
        self.device = (resolve_device(mesh.device_type) if mesh is not None
                       else resolve_device(device))
        self.log = log
        self.straggler = StragglerDetector()
        self.inject_failure_at: set[int] = set()
        self._injected: set[int] = set()
        self.recoveries = 0
        self.saves: list[tuple[int, float]] = []   # (step, seconds)
        self._saver = ckpt.AsyncSaver() if cfg.async_save else None

    def _save(self, step, state, *, final=False):
        """A checkpoint of ``state``; its seconds on the caller (the host
        copy, and the write unless it is asynchronous) go to ``saves``."""
        t0 = time.perf_counter()
        if self._saver is not None and not final:
            self._saver.save(self.cfg.ckpt_dir, step, state,
                             mesh=self.mesh, keep=self.cfg.keep)
        else:
            ckpt.save(self.cfg.ckpt_dir, step, state, mesh=self.mesh,
                      keep=self.cfg.keep)
        self.saves.append((step, time.perf_counter() - t0))

    def _restore(self, step, state):
        return ckpt.restore(self.cfg.ckpt_dir, step, state, mesh=self.mesh,
                            device=self.device)

    def _maybe_fail(self, step: int):
        if step in self.inject_failure_at and step not in self._injected:
            self._injected.add(step)
            raise RuntimeError(f"injected failure at step {step}")

    def run(self, params, opt_state, batches: Callable[[int], dict],
            *, start_step: int = 0, num_steps: int = 100):
        """batches(step) -> batch dict. Returns (params, opt_state,
        history)."""
        state = (params, opt_state)
        step = start_step
        # resume from the newest checkpoint if one exists
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is not None and last > step:
            state = self._restore(last, state)
            step = last
            self.log(f"resumed from checkpoint step {last}")
        history = []
        retries = 0
        while step < num_steps:
            try:
                self._maybe_fail(step)
                t0 = time.perf_counter()
                p, o, metrics = self.step_fn(state[0], state[1],
                                             batches(step))
                block_until_ready(metrics)
                dt = time.perf_counter() - t0
                slow = self.straggler.observe(step, dt)
                if slow:
                    self.log(f"straggler: step {step} took {dt:.3f}s")
                state = (p, o)
                history.append({"step": step, "dt": dt,
                                **{k: float(v) for k, v in
                                   metrics.items() if v is not None}})
                step += 1
                retries = 0
                if step % self.cfg.ckpt_every == 0:
                    self._save(step, state)
            except Exception as e:  # noqa: BLE001 — recovery is the point
                retries += 1
                self.recoveries += 1
                self.log(f"step {step} failed ({e}); "
                         f"recovery {retries}/{self.cfg.max_retries}")
                if retries > self.cfg.max_retries:
                    raise
                if self._saver is not None:
                    self._saver.wait()   # don't restore past an in-flight save
                last = ckpt.latest_step(self.cfg.ckpt_dir)
                if last is not None:
                    state = self._restore(last, state)
                    step = last
        if self._saver is not None:
            self._saver.wait()
        self._save(step, state, final=True)
        return state[0], state[1], history
