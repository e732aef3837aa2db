"""Continuous (slot-based) batching for decode serving, ported from the
reference's ``serve/continuous_batching.py``.

The decode step always runs at a FIXED batch of ``n_slots``. Requests
stream in with different prompt lengths and generation budgets; finished
slots are refilled from the queue at once instead of waiting for the
whole batch to drain (vLLM-style, without paging: the KV capacity is the
per-slot max length).

The engine drives the public Model API through a prefill-one /
decode-batch pair. A request's single-row prefill cache is spliced into
the batched cache in place, on the cache's device: its row of every
sequence leaf takes the prefill's entries and zeros after them, as the
reference pads and sets. The host sees only the (n_slots,) next tokens of
each step.

Unlike the reference, where a write past the cache's end is dropped, a
slot that holds no request has its position set back to 0 after each
step: the decode step still runs on it (the batch is fixed) and would
otherwise write past ``capacity`` once it had idled long enough. Its
outputs are never read, and a refill overwrites its row.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.device import params_device


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False
    t_enqueued: float = 0.0
    t_done: float = 0.0


@dataclass
class EngineStats:
    steps: int = 0
    slot_occupancy: list = field(default_factory=list)
    finished: int = 0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.slot_occupancy)) if self.slot_occupancy \
            else 0.0


def _splice(big, small, slot: int) -> None:
    """Write the single-row cache tree ``small`` into row ``slot`` of the
    batched tree ``big``, in place: (L, 1, T1, ...) leaves into (L, n, T,
    ...) with zeros past T1, the (1,) position into (n,)."""
    for name, b in big.items():
        s = small[name]
        if isinstance(b, dict):
            _splice(b, s, slot)
        elif b.dim() == 1:                          # pos (B,)
            b[slot] = s[0]
        else:
            t1 = s.shape[2]
            b[:, slot, :t1] = s[:, 0].to(b.dtype)
            b[:, slot, t1:] = 0


class ContinuousBatcher:
    """model: factory Model; capacity: per-slot KV capacity (max prompt +
    max_new must fit). Runs where ``params`` lie: on the card unless the
    caller passes ``device="cpu"``."""

    def __init__(self, model, params, n_slots: int, capacity: int,
                 kv_dtype: str = "bfloat16", eos_token: int | None = None,
                 *, device=None):
        self.dev = params_device(params, device)
        self.model = model
        self.params = params
        self.n = n_slots
        self.cap = capacity
        self.eos = eos_token
        self.queue: list[GenRequest] = []
        self.slots: list[Optional[GenRequest]] = [None] * n_slots
        self.cache = model.init_cache(n_slots, capacity, kv_dtype,
                                      device=self.dev)
        self.last_tok = torch.zeros((n_slots, 1), dtype=torch.int64,
                                    device=self.dev)
        self.active = np.zeros(n_slots, bool)
        self.stats = EngineStats()

    def submit(self, req: GenRequest):
        self.queue.append(req)

    # ---- slot management -------------------------------------------------
    def _prefill_into_slot(self, slot: int, req: GenRequest):
        """Run a single-sequence prefill and splice its cache into the
        batched cache at ``slot``."""
        tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.int64,
                                 device=self.dev)[None]
        logits, cache1 = self.model.prefill(self.params, {"tokens": tokens})
        _splice(self.cache, cache1, slot)
        self.last_tok[slot, 0] = torch.argmax(logits[0])
        self.slots[slot] = req
        self.active[slot] = True

    def _refill(self):
        for s in range(self.n):
            if not self.active[s] and self.queue:
                self._prefill_into_slot(s, self.queue.pop(0))

    # ---- main loop --------------------------------------------------------
    @torch.no_grad()
    def step(self):
        """One decode step for all active slots."""
        self._refill()
        if not self.active.any():
            return False
        self.stats.slot_occupancy.append(self.active.mean())
        toks = self.last_tok[:, 0].tolist()
        logits, self.cache = self.model.decode(self.params, self.cache,
                                               {"tokens": self.last_tok})
        nxt = torch.argmax(logits, -1)
        pos = self.cache["pos"].tolist()
        for s in range(self.n):
            req = self.slots[s]
            if req is None:
                continue
            tok = toks[s]
            req.out.append(tok)
            finished = len(req.out) >= req.max_new or \
                (self.eos is not None and tok == self.eos) or \
                pos[s] >= self.cap
            if finished:
                req.done = True
                self.slots[s] = None
                self.active[s] = False
                self.stats.finished += 1
        idle = np.flatnonzero(~self.active)
        if len(idle):
            self.cache["pos"][torch.as_tensor(idle, device=self.dev)] = 0
        self.last_tok = nxt[:, None]
        self.stats.steps += 1
        return True

    def run_to_completion(self, max_steps: int = 10_000):
        while (self.queue or self.active.any()) and \
                self.stats.steps < max_steps:
            if not self.step():
                break
        return self.stats
