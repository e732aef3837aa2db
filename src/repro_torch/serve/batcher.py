"""Request batching for serving (paper-kind: inference over a corpus /
request stream). Size-or-deadline batching with one fixed batch width
(pad-to-capacity), plus simple latency accounting for tests and the
serve_cascade example. ``CascadeService`` stacks one Batcher per
predicate so a mixed request stream ("does this frame contain a?" /
"...contain b?") is routed into per-cascade batches — the online face of
the query engine (engine/scan.make_batch_runner builds the runners)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping


@dataclass
class Request:
    rid: int
    payload: Any
    t_arrival: float = 0.0
    result: Any = None
    t_done: float = 0.0


@dataclass
class BatcherStats:
    batches: int = 0
    padded_slots: int = 0
    latencies: list = field(default_factory=list)


class Batcher:
    """Collects requests; flushes when ``batch_size`` are waiting or the
    oldest request exceeds ``max_wait_s`` (checked on submit/flush)."""

    def __init__(self, run_batch: Callable[[list], list], batch_size: int,
                 max_wait_s: float = 0.01, clock=time.perf_counter):
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.max_wait_s = max_wait_s
        self.clock = clock
        self.pending: list[Request] = []
        self.stats = BatcherStats()

    def submit(self, req: Request):
        req.t_arrival = self.clock()
        self.pending.append(req)
        if len(self.pending) >= self.batch_size:
            self._flush()

    def poll(self):
        if self.pending and \
                self.clock() - self.pending[0].t_arrival >= self.max_wait_s:
            self._flush()

    def drain(self):
        while self.pending:
            self._flush()

    def _flush(self):
        batch = self.pending[: self.batch_size]
        self.pending = self.pending[self.batch_size:]
        pad = self.batch_size - len(batch)
        payloads = [r.payload for r in batch] + [batch[-1].payload] * pad
        results = self.run_batch(payloads)
        now = self.clock()
        for r, res in zip(batch, results):
            r.result = res
            r.t_done = now
            self.stats.latencies.append(now - r.t_arrival)
        self.stats.batches += 1
        self.stats.padded_slots += pad


class CascadeService:
    """Multi-predicate serving front: one Batcher per predicate, all
    sharing the caller's runner table ({concept -> run_batch}, e.g.
    cascade executors from engine/scan.make_batch_runner).
    ``submit`` routes a request to its predicate's batch; poll/drain fan
    out to every batcher so deadlines hold across concepts.

    Batchers are keyed END-TO-END by ``(concept, cascade-id)``, never by
    cascade id alone: physical cascade ids (the planner's grid
    coordinates, pipeline.compiled_cascade) are concept-independent, so
    two predicates routinely select the SAME id. A cascade-id-keyed
    dedupe would merge both concepts into one batch queue, interleaving
    their results and dropping per-request arrival order per concept —
    ``from_cascades`` instead dedupes only the COMPILED RUNNER, and only
    for a genuinely shared CompiledCascade object, while keeping queues,
    order, and stats per (concept, cascade-id)
    (tests/test_serve_async.py regression)."""

    def __init__(self, runners: Mapping[str, Callable[[list], list]],
                 batch_size: int, max_wait_s: float = 0.01,
                 clock=time.perf_counter,
                 cascade_ids: Mapping[str, tuple] | None = None):
        self._key_of = {c: (c, tuple((cascade_ids or {}).get(c, ())))
                        for c in runners}
        self.batchers = {self._key_of[c]: Batcher(fn, batch_size,
                                                  max_wait_s, clock)
                         for c, fn in runners.items()}

    @classmethod
    def from_cascades(cls, cascades: Mapping[str, "object"],
                      batch_size: int, max_wait_s: float = 0.01,
                      clock=time.perf_counter, device=None):
        """Build from {concept -> CompiledCascade}: one batcher per
        (concept, cascade-id). The compiled runner is shared only when
        two concepts hand in the SAME CompiledCascade object — a bare
        cascade-id match is NOT sufficient to share models (grid
        coordinates repeat across concepts with different params).
        ``device`` (default ``cuda``) is where the runners stack and run
        their batches."""
        from repro_torch.engine.scan import make_batch_runner

        compiled: dict[int, Callable] = {}
        runners, ids = {}, {}
        for concept, casc in cascades.items():
            if id(casc) not in compiled:
                compiled[id(casc)] = make_batch_runner(casc, batch_size,
                                                       device=device)
            runners[concept] = compiled[id(casc)]
            ids[concept] = tuple(casc.cascade_id)
        return cls(runners, batch_size, max_wait_s, clock,
                   cascade_ids=ids)

    @property
    def concepts(self):
        return list(self._key_of)

    def submit(self, concept: str, req: Request):
        self.batchers[self._key_of[concept]].submit(req)

    def poll(self):
        for b in self.batchers.values():
            b.poll()

    def drain(self):
        for b in self.batchers.values():
            b.drain()

    @property
    def stats(self) -> dict[str, BatcherStats]:
        return {c: self.batchers[k].stats
                for c, k in self._key_of.items()}

    def latencies(self) -> list:
        out = []
        for b in self.batchers.values():
            out.extend(b.stats.latencies)
        return out
