"""Shard-aware async cascade serving (DESIGN.md §10, hardening §12) on
shard lanes of a torch device.

``AsyncCascadeService`` replaces the synchronous-polling
``CascadeService`` (serve/batcher.py) for request streams over a corpus
resident on the device ("does frame ROW contain CONCEPT?"):

* **shard routing** — requests are routed by the ShardPlan's stationary
  hash partitioning (`sharding/policy.shard_route`) to one queue PER
  SHARD. A row's shard owns its virtual columns (the same ownership the
  sharded scan engine uses), so the store lookup on submit is a
  shard-local read.
* **lanes** — each shard dispatches on its *lane*
  (`engine/sharded._Lane`): a device (`launch/mesh.shard_devices`,
  round-robin over the GPUs) and, on a card, a CUDA stream of its own
  there, so the 8 shards of one H100 are 8 lanes, not one device. The
  lane is the unit of everything the reference keys by device: one
  in-flight batch, health (``failed_devices`` lists lane indices) and the
  fault plan's index. On the CPU every lane is its own slot without a
  stream.
* **deadline scheduling** — a deadline wheel (serve/scheduler.py) holds
  one entry per non-empty (shard, concept) queue group; a group flushes
  when ``batch_size`` requests are waiting OR when its oldest request's
  deadline (``arrival + max_wait_s``) comes due on ``poll()``. Flushed
  batches are assembled at the lockstep's bucketed power-of-2 slab
  widths (`engine/sharded.slab_width`/`pad_rows`). ``poll()`` only runs
  when a caller ticks it — the wall-clock event host (serve/host.py)
  drives it autonomously.
* **dispatch-ahead** — a flush gathers its base rows from the resident
  corpus on its lane (index copies from pinned memory on the lane's
  stream; no host copy of the images), runs, and sends its labels to a
  pinned host buffer on the lane's stream with a CUDA event recorded
  after them (``PendingLabels``). ``poll()`` delivers a batch once its
  event has fired; ``np.asarray`` at delivery is the one wait, so
  host-side routing and gather of the next batch overlap the device
  compute of the previous one. Per-lane delivery is FIFO (a lane's
  in-flight batch is delivered before it accepts the next), so evaluated
  results are delivered in submission order per queue.
* **post-flush commit** — labels are recorded into the shard-local
  store and committed corpus-wide via
  ``VirtualColumnStore.merge_rows_from`` (computed labels never
  overwritten). A re-submitted decided row is answered on submit with
  ZERO model invocations.
* **representation reuse** — an optional cross-query
  ``RepresentationCache`` (serve/repcache.py) backs batch assembly:
  when every row of a flush already has every non-base pooled level
  cached, the batch runs the from-pyramid variant (no re-pooling);
  otherwise the from-base variant runs — on a card with stage-0 params,
  ``fused_pyramid_stage0`` — and its freshly pooled levels stay on the
  lane's device until delivery, when they go into the cache's slabs
  there. The same cache object can back a ``ScanEngine``, so offline
  scans warm the online path.

Overload/fault hardening (all OFF by default — the default-parameter
service is request-for-request identical to the unhardened one):
admission control (``queue_limit``, typed ``Shed`` results), the Pareto
degradation ladder (``ladders``, ``degrade``; degraded labels commit
under the degraded cascade's OWN ``casc.key``), and fault recovery
(``batch_timeout_s``, ``request_deadline_s``, ``dispatch_retries``,
``faults``). Only the injector's ``DeviceError`` and
``TransientComputeError`` are caught: they re-route a batch to another
LANE, never to the CPU or to a plain version. A CUDA error, a kernel
build failure or a launch failure propagates.

Exactness: batches run full-width cascade levels
(``caps = [width] * (L-1)``), ignoring ``CompiledCascade.capacities``
like the scan paths — labels are per-row independent of batch packing,
so they equal ``ScanEngine``/``naive_scan``'s, up to the card's
width-dependent cuDNN sums of the later levels (ROADMAP Queue 3: a row
within ~1e-6 of a threshold).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.scan import (CompiledCascade, VirtualColumnStore,
                                     _corpus)
from repro_torch.engine.sharded import (_cascade_on, _indexed, _Lane,
                                        pad_rows, slab_width)
from repro_torch.launch.mesh import shard_devices
from repro_torch.serve.batcher import Request
from repro_torch.serve.faults import (DeviceError, Shed, TimedOut,
                                      TransientComputeError)
from repro_torch.serve.scheduler import DeadlineWheel
from repro_torch.sharding.policy import shard_route


@dataclass
class ServiceStats:
    """Per-concept serving counters."""
    requests: int = 0
    store_hits: int = 0        # answered on submit, zero invocations
    rep_hit_rows: int = 0      # rows assembled from the repcache
    rows_evaluated: int = 0
    batches: int = 0
    padded_slots: int = 0
    size_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    # hardening counters (all stay 0 on the default-parameter service)
    shed: int = 0              # admission-rejected (typed Shed result)
    expired: int = 0           # in-queue request deadline expiries
    timeouts: int = 0          # batch-timeout completions (TimedOut)
    retries: int = 0           # batch re-dispatches (fault/timeout)
    degraded_rows: int = 0     # rows answered by a non-primary rung
    degraded_batches: int = 0
    degrade_steps: int = 0     # ladder step-downs
    recover_steps: int = 0     # ladder step-ups
    depth_max: int = 0         # max queued (all shards) for this concept
    # bounded window so a resident service can't grow a float per
    # request forever
    latencies: deque = field(
        default_factory=lambda: deque(maxlen=65536))


@dataclass
class DegradeConfig:
    """Load-controller thresholds for the degradation ladder: step DOWN
    one rung when a concept's total queued depth reaches ``high_depth``
    (or a delivered flush took ``high_latency_s``+); step back UP after
    ``recover_after`` consecutive flushes observed at ``low_depth`` or
    less. Observations happen at flush time, so recovery needs traffic
    — which is exactly when the rung matters."""
    high_depth: int = 64
    low_depth: int = 4
    high_latency_s: float | None = None
    recover_after: int = 4


class _LoadController:
    """Per-concept hysteresis controller over ladder rung indices
    (0 = primary). One step per observation, calm-streak recovery."""

    def __init__(self, cfg: DegradeConfig, n_levels: int):
        self.cfg = cfg
        self.n_levels = n_levels
        self.level = 0
        self._calm = 0

    def force_down(self) -> bool:
        """Immediate step-down (admission pressure). True if it moved."""
        self._calm = 0
        if self.level < self.n_levels - 1:
            self.level += 1
            return True
        return False

    def observe(self, depth: int, latency_s: float | None = None) -> int:
        cfg = self.cfg
        hot = depth >= cfg.high_depth or (
            cfg.high_latency_s is not None and latency_s is not None
            and latency_s >= cfg.high_latency_s)
        if hot:
            self.force_down()
        elif depth <= cfg.low_depth:
            self._calm += 1
            if self._calm >= cfg.recover_after and self.level > 0:
                self.level -= 1
                self._calm = 0
        else:
            self._calm = 0
        return self.level


class PendingLabels:
    """A copy on its way to the host: the pinned buffer a lane's stream
    fills and the CUDA event recorded after it (``_Lane.fetch``).
    ``is_ready()`` asks the event without waiting; ``np.asarray`` waits
    for it — the service's one wait per batch, at delivery. On the CPU
    both are immediate."""

    def __init__(self, fetched):
        self._fetched = fetched

    def is_ready(self) -> bool:
        done = self._fetched[1]
        return done is None or done.query()

    def __array__(self, dtype=None, copy=None):
        a = _Lane.ready(self._fetched)
        return a if dtype is None else a.astype(dtype)


@dataclass
class _InFlight:
    """A dispatched, not-yet-delivered batch parked on its lane."""
    shard: int
    concept: str
    casc: CompiledCascade      # the rung that ran (commit under ITS key)
    take: list                 # the batch's Requests (arrival order)
    rows: np.ndarray           # their row ids (unpadded)
    labels: object             # PendingLabels (or a fault proxy)
    levels: dict | None        # {res: pooled level} for the repcache
    t_dispatch: float = 0.0    # clock() at dispatch (batch timeout base)
    retries: int = 0           # re-dispatches already burned


class AsyncCascadeService:
    """Deadline-scheduled, shard-routed serving over a corpus resident on
    ``device`` (default ``cuda``; a CUDA request without a card raises).

    ``submit(concept, Request(rid, row_id))`` answers immediately from
    the row's shard-local virtual columns when the label is known;
    otherwise the request joins its (shard, concept) queue. ``poll()``
    fires due deadlines, expires over-deadline work, recovers timed-out
    batches, and harvests finished batches; ``drain()`` flushes and
    delivers everything. Results land on ``Request.result`` — a 0/1
    label, or a typed ``Shed``/``TimedOut`` when hardening knobs
    reject/expire the request. ``devices`` (default
    ``launch/mesh.shard_devices``) places shard i's lane on
    ``devices[i]``."""

    def __init__(self, images, cascades: Mapping[str, CompiledCascade],
                 *, shards: int | None = None, batch_size: int = 32,
                 max_wait_s: float = 0.005, clock=time.perf_counter,
                 repcache=None, store: VirtualColumnStore | None = None,
                 device=None, devices: Sequence | None = None,
                 queue_limit: int | None = None, overload: str = "shed",
                 ladders: Mapping[str, Sequence[CompiledCascade]]
                 | None = None,
                 degrade: DegradeConfig | None = None,
                 batch_timeout_s: float | None = None,
                 request_deadline_s: float | None = None,
                 dispatch_retries: int = 2, faults=None,
                 ingest_index=None, ingest_exact: bool = True):
        self.images = _corpus(images, resolve_device(device))
        self.n_rows = int(self.images.shape[0])
        self.cascades = dict(cascades)
        self.devices = ([_indexed(d) for d in devices]
                        if devices is not None
                        else shard_devices(shards, device=self.images.device))
        self.n_shards = int(shards) if shards is not None \
            else len(self.devices)
        if self.n_shards < 1:
            raise ValueError("need at least one shard")
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self.repcache = repcache
        if repcache is not None:
            from repro_torch.serve.repcache import corpus_token
            repcache.bind_corpus(corpus_token(self.images),
                                 self.images.device)
        self.wheel = DeadlineWheel(granularity=max(self.max_wait_s / 4,
                                                   1e-6))
        # one lane per shard; a CUDA lane's stream first waits for its
        # device's current stream, where the corpus and weights were made
        self._lanes = []
        for s in range(self.n_shards):
            dev = self.devices[s]
            stream = None
            if dev.type == "cuda":
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
            self._lanes.append(_Lane(dev, stream))

        # ------------------------------------------ hardening knobs --
        if overload not in ("shed", "degrade"):
            raise ValueError(f"unknown overload policy {overload!r}")
        self.queue_limit = None if queue_limit is None \
            else max(1, int(queue_limit))
        self.overload = overload
        self.batch_timeout_s = batch_timeout_s
        self.request_deadline_s = request_deadline_s
        self.dispatch_retries = int(dispatch_retries)
        self.faults = faults
        # ladder[0] is always the primary cascade; load controllers
        # exist only when there is anything to step down to
        self._ladder: dict[str, list[CompiledCascade]] = {
            c: [casc, *((ladders or {}).get(c, ()))]
            for c, casc in self.cascades.items()}
        self._ctl: dict[str, _LoadController | None] = {
            c: (_LoadController(degrade or DegradeConfig(), len(rungs))
                if len(rungs) > 1 else None)
            for c, rungs in self._ladder.items()}
        self._last_flush_lat: dict[str, float] = {}
        # lane health: a failed lane is never dispatched to again
        self._failed: set[int] = set()
        self._inflight_max = 0

        # corpus-wide store (shared with the caller when given, so a
        # scan engine's virtual columns serve requests directly) plus
        # shard-local stores seeded with each shard's own partition
        self.store = store if store is not None \
            else VirtualColumnStore(self.n_rows)
        # ingest-time label index (engine/ingest.CandidateIndex): stage-0
        # decisions made at ingest seed the corpus-wide store BEFORE the
        # shard seeds are sliced, so indexed rows are answered at submit
        # with zero model invocations (store_hits). ingest_exact=True
        # seeds only own-pixel decided labels; False additionally
        # propagates skip-alias labels (approx).
        if ingest_index is not None:
            ingest_index.seed_store(self.store, exact=ingest_exact)
        self._row_shard = shard_route(np.arange(self.n_rows), self.n_shards)
        self._shard_stores = []
        for s in range(self.n_shards):
            st = VirtualColumnStore(self.n_rows)
            st.seed_from(self.store, np.where(self._row_shard == s)[0])
            self._shard_stores.append(st)

        self._queues: list[dict[str, list]] = [
            {} for _ in range(self.n_shards)]
        self._inflight: dict = {}          # lane index -> _InFlight
        self._fns: dict = {}   # (cascade key, width, variant[, device])
        self._moved: dict = {}             # (casc.key, device) -> cascade
        # "base" executions of cascades with stage-0 params (flushes,
        # re-dispatches and warmup): on a card, fused_pyramid_stage0
        # launches
        self.stage0_runs = 0
        self.stats = {c: ServiceStats() for c in self.cascades}
        # rids in delivery order — an observability window (FIFO tests,
        # debugging), bounded so a long-lived service can't leak
        self.delivered: deque = deque(maxlen=65536)

    # ---------------------------------------------------------- plumbing --
    @property
    def concepts(self) -> list[str]:
        return list(self.cascades)

    def shard_of(self, row: int) -> int:
        return int(self._row_shard[int(row)])

    def active_level(self, concept: str) -> int:
        ctl = self._ctl[concept]
        return ctl.level if ctl is not None else 0

    def _active_cascade(self, concept: str) -> CompiledCascade:
        return self._ladder[concept][self.active_level(concept)]

    def _all_cascades(self) -> dict:
        """Every distinct ladder rung across concepts, keyed by
        casc.key (warmup target)."""
        out = {}
        for rungs in self._ladder.values():
            for casc in rungs:
                out[casc.key] = casc
        return out

    def _lane_for(self, shard: int) -> int | None:
        """The shard's lane, re-routed past failed lanes: the first
        healthy lane by a shard-stable rotation, or None when every lane
        has failed."""
        if shard not in self._failed:
            return shard
        healthy = [i for i in range(len(self._lanes))
                   if i not in self._failed]
        if not healthy:
            return None
        return healthy[shard % len(healthy)]

    def _remote(self, lane: _Lane) -> bool:
        return lane.device != self.images.device

    def _fn(self, casc: CompiledCascade, width: int, variant: str,
            lane: _Lane):
        """Batch runner, cached per (cascade key, slab width, variant) and
        per device for a lane on another GPU than the corpus's (the
        cascade's weights copied there once).
        'base': raw rows in, labels + freshly pooled non-base levels out
        (core/executor.make_fused_ingest: ``fused_pyramid_stage0`` on a
        card with stage-0 params). 'pyr': cached pooled levels in,
        labels out."""
        remote = self._remote(lane)
        key = (casc.key, width, variant) + ((lane.device,) if remote else ())
        if key not in self._fns:
            from repro_torch.core.executor import (make_fused_ingest,
                                                   run_cascade_on_pyramid)
            if remote:
                mk = (casc.key, lane.device)
                if mk not in self._moved:
                    self._moved[mk] = _cascade_on(casc, lane.device)
                casc = self._moved[mk]
            base_hw = int(self.images.shape[1])
            small = tuple(r for r in casc.resolutions if r != base_hw)
            caps = [width] * (len(casc.model_fns) - 1)
            if variant == "base":
                fn = make_fused_ingest(casc.model_fns, casc.thresholds,
                                       casc.reps, caps, small,
                                       stage0=casc.stage0)
            else:
                def fn(pyr, casc=casc, caps=caps):
                    return run_cascade_on_pyramid(
                        pyr, casc.model_fns, casc.thresholds, casc.reps,
                        caps)[0]
            self._fns[key] = fn
        return self._fns[key]

    def _gather(self, lane: _Lane, rows: np.ndarray) -> torch.Tensor:
        """The base images of ``rows`` on the lane (the caller holds the
        lane): gathered from the resident corpus; a lane on another GPU
        gets the gathered rows copied over."""
        if not self._remote(lane):
            return self.images[lane.put(rows)]
        # a copy between devices waits for both devices' current streams,
        # the lane's among them, and makes the lane's wait for it
        home = self.images.device
        return self.images[torch.from_numpy(rows).to(home)].to(lane.device)

    @staticmethod
    def _onto(lane: _Lane, block: torch.Tensor, made_on) -> torch.Tensor:
        """A block made on the stream ``made_on`` (a repcache lookup, on
        the dispatching thread's stream; None off a card) for use on the
        lane's stream: the lane waits for it, and its memory is kept until
        the lane is done. A lane on another GPU gets it copied over."""
        if block.device != lane.device:
            return block.to(lane.device)
        if lane.stream is not None:
            lane.stream.wait_stream(made_on)
            block.record_stream(lane.stream)
        return block

    @torch.no_grad()
    def _run(self, li: int, casc: CompiledCascade, width: int,
             rows_p: np.ndarray, nv: int, pyr: dict | None):
        """One batch on lane ``li``, issued under the lane's device and
        stream: 'pyr' from the pooled blocks ``pyr`` (padded to ``width``,
        on the corpus's device), else 'base' from the corpus rows
        ``rows_p``. -> (PendingLabels of the ``nv`` valid rows, {res:
        freshly pooled level of the valid rows, on the lane} for the
        repcache, or None)."""
        lane = self._lanes[li]
        base_hw = int(self.images.shape[1])
        made_on = None
        if pyr and lane.stream is not None:
            made_on = torch.cuda.current_stream(
                next(iter(pyr.values())).device)
        with lane:
            if pyr is not None:
                inp = {r: self._onto(lane, v, made_on)
                       for r, v in pyr.items()}
                if base_hw in casc.resolutions:
                    inp[base_hw] = self._gather(lane, rows_p)
                labels = self._fn(casc, width, "pyr", lane)(inp)
                levels = None
            else:
                labels, lv = self._fn(casc, width, "base", lane)(
                    self._gather(lane, rows_p))
                if casc.stage0 is not None:
                    self.stage0_runs += 1
                levels = ({r: v[:nv] for r, v in lv.items()}
                          if self.repcache is not None else None)
            return PendingLabels(lane.fetch(labels[:nv])), levels

    def warmup(self, widths: Sequence[int] | None = None) -> int:
        """Execute one dummy batch per (lane, cascade rung, slab width,
        variant) so live traffic never pays a first-call set-up (the
        kernels' launch set-ups, each stream's library workspaces) —
        degradation rungs included (stepping down must not stall exactly
        when the service is overloaded). Default widths: every bucket
        ``slab_width`` can emit for this batch_size. Dummy batches never
        touch the stores or the repcache. Returns the number of
        executions."""
        if widths is None:
            widths = sorted({slab_width(n, self.batch_size)
                             for n in range(1, self.batch_size + 1)})
        base_hw = int(self.images.shape[1])
        rows = np.zeros(max(widths), np.int64)
        n = 0
        for casc in self._all_cascades().values():
            small = [r for r in casc.resolutions if r != base_hw]
            for width in widths:
                for li in range(len(self._lanes)):
                    np.asarray(self._run(li, casc, width, rows[:width],
                                         width, None)[0])
                    n += 1
                    if not small:
                        continue
                    pyr = {r: torch.zeros((width, r, r, 3),
                                          device=self.images.device)
                           for r in small}
                    np.asarray(self._run(li, casc, width, rows[:width],
                                         width, pyr)[0])
                    n += 1
        return n

    # ------------------------------------------------------ request path --
    def submit(self, concept: str, req: Request) -> None:
        req.t_arrival = self.clock()
        st = self.stats[concept]
        st.requests += 1
        row = int(req.payload)
        s = self.shard_of(row)
        # answer from the most accurate decided rung: primary first,
        # then any active degraded rung (a degraded label is still a
        # valid answer for a degraded-mode service, and it lives under
        # its own key, so the primary column is never consulted wrongly)
        rungs = self._ladder[concept][: self.active_level(concept) + 1]
        for casc in rungs:
            cached = int(self._shard_stores[s].column(casc.key)[row])
            if cached < 0:
                # the shard seed is a snapshot: a co-owning scan engine
                # may have decided this row in the SHARED store after
                # service construction — adopt the late write into the
                # shard's own columns so the next lookup is local again
                cached = int(self.store.column(casc.key)[row])
                if cached >= 0:
                    self._shard_stores[s].record(
                        casc.key, np.array([row]), [cached])
            if cached >= 0:                # shard-owned read, no model
                req.result = cached
                req.t_done = req.t_arrival
                st.store_hits += 1
                st.latencies.append(0.0)
                self.delivered.append(req.rid)
                return
        q = self._queues[s].setdefault(concept, [])
        if self.queue_limit is not None and len(q) >= self.queue_limit:
            # admission control: the queue is bounded — shed with a
            # typed result; under the 'degrade' policy, also step the
            # ladder down so FUTURE flushes get cheaper
            if self.overload == "degrade":
                ctl = self._ctl[concept]
                if ctl is not None and ctl.force_down():
                    st.degrade_steps += 1
            self._finish_rejected([req], concept, Shed("queue-full"))
            return
        q.append(req)
        depth = self._concept_depth(concept)
        if depth > st.depth_max:
            st.depth_max = depth
        if len(q) == 1:
            self.wheel.schedule((s, concept),
                                req.t_arrival + self.max_wait_s)
        if len(q) >= self.batch_size:
            self._flush(s, concept, "size")

    def poll(self) -> None:
        """Expire over-deadline queued requests, fire due flush
        deadlines, recover timed-out batches, then harvest any finished
        batches without blocking on in-flight device compute."""
        now = self.clock()
        self._expire_requests(now)
        for s, concept in self.wheel.pop_due(now):
            if self._queues[s].get(concept):
                self._flush(s, concept, "deadline")
        self._check_batch_timeouts(now)
        self.deliver_ready()

    def drain(self) -> None:
        """Flush every queue and deliver every in-flight batch. With a
        ``batch_timeout_s`` configured, an expired in-flight batch is
        recovered (retry on a healthy lane, else TimedOut) instead of
        blocked on — a dead lane can no longer hang drain()."""
        for s in range(self.n_shards):
            for concept in list(self._queues[s]):
                while self._queues[s][concept]:
                    self._flush(s, concept, "drain")
        while self._inflight:
            for li in list(self._inflight):
                inf = self._inflight.get(li)
                if inf is None:
                    continue
                if self._batch_timed_out(inf):
                    self._recover_batch(li)
                else:
                    # blocks until the lane finishes; a NeverReady label
                    # without a configured timeout raises loudly instead
                    # of hanging
                    self._deliver(li)

    # ----------------------------------------------------- flush/deliver --
    def _concept_depth(self, concept: str) -> int:
        return sum(len(self._queues[s].get(concept, ()))
                   for s in range(self.n_shards))

    def _queued_total(self) -> int:
        return sum(len(q) for qs in self._queues for q in qs.values())

    def _expire_requests(self, now: float) -> None:
        if self.request_deadline_s is None:
            return
        for s in range(self.n_shards):
            for concept, q in self._queues[s].items():
                expired = []
                while q and now - q[0].t_arrival > self.request_deadline_s:
                    expired.append(q.pop(0))
                if not expired:
                    continue
                self._finish_rejected(expired, concept,
                                      TimedOut("request-deadline"))
                key = (s, concept)
                self.wheel.cancel(key)
                if q:                     # new head keeps its deadline
                    self.wheel.schedule(key,
                                        q[0].t_arrival + self.max_wait_s)

    def _finish_rejected(self, reqs: list, concept: str, result) -> None:
        """Complete requests with a typed non-label result — the only
        exits besides a real label; nothing is left pending forever."""
        st = self.stats[concept]
        now = self.clock()
        for req in reqs:
            req.result = result
            req.t_done = now
            self.delivered.append(req.rid)
        if isinstance(result, Shed):
            st.shed += len(reqs)
        elif result.reason == "request-deadline":
            st.expired += len(reqs)
        else:
            st.timeouts += len(reqs)

    def _flush(self, s: int, concept: str, reason: str) -> None:
        st = self.stats[concept]
        ctl = self._ctl[concept]
        if ctl is not None:
            # load control observes at flush time: backlog across the
            # concept's shards + the latency of the last delivered flush
            before = ctl.level
            level = ctl.observe(self._concept_depth(concept),
                                self._last_flush_lat.get(concept))
            if level > before:
                st.degrade_steps += 1
            elif level < before:
                st.recover_steps += 1
        q = self._queues[s][concept]
        take, self._queues[s][concept] = \
            q[:self.batch_size], q[self.batch_size:]
        key = (s, concept)
        self.wheel.cancel(key)
        rest = self._queues[s][concept]
        if rest:                           # new head keeps its deadline
            self.wheel.schedule(key, rest[0].t_arrival + self.max_wait_s)
        setattr(st, f"{reason}_flushes",
                getattr(st, f"{reason}_flushes") + 1)
        self._dispatch(s, concept, take)

    def _dispatch(self, s: int, concept: str, take: list,
                  casc: CompiledCascade | None = None,
                  retries: int = 0, count_rows: bool = True) -> None:
        casc = casc if casc is not None else self._active_cascade(concept)
        st = self.stats[concept]
        nv = len(take)
        width = slab_width(nv, self.batch_size)
        rows = np.array([int(r.payload) for r in take], np.int64)
        rows_p = pad_rows(rows, width)

        base_hw = int(self.images.shape[1])
        small = [r for r in casc.resolutions if r != base_hw]
        # probe the cache with the VALID rows only (the pad repeats the
        # last row — probing it would double-count its entries), then
        # pad the gathered blocks to slab width
        cached = (self.repcache.lookup_rows(rows, small)
                  if self.repcache is not None and small else None)
        pyr = None if cached is None else {
            r: (torch.cat([v, v[-1:].expand(width - nv, *v.shape[1:])])
                if width > nv else v)
            for r, v in cached.items()}

        attempts = 0
        while True:
            li = self._lane_for(s)
            if li is None:                 # every lane failed
                self._finish_rejected(take, concept,
                                      Shed("no-healthy-device"))
                return
            if li in self._inflight:       # one in-flight batch per lane
                if self._batch_timed_out(self._inflight[li]):
                    self._recover_batch(li)
                    if li in self._failed:
                        continue           # recovery failed it: re-pick
                else:
                    self._deliver(li)
            try:
                if self.faults is not None:
                    self.faults.on_dispatch(li)
            except (DeviceError, TransientComputeError) as e:
                attempts += 1
                st.retries += 1
                if isinstance(e, DeviceError):
                    # dispatch-time lane failure: fail the lane so every
                    # future dispatch re-routes around it
                    self._failed.add(li)
                if attempts > self.dispatch_retries:
                    self._finish_rejected(take, concept,
                                          Shed("dispatch-failed"))
                    return
                continue
            labels, levels = self._run(li, casc, width, rows_p, nv, pyr)
            break

        if self.faults is not None:
            labels = self.faults.wrap_labels(labels, li)
        st.batches += 1
        if count_rows:
            st.rows_evaluated += nv
            st.padded_slots += width - nv
            if cached is not None:
                st.rep_hit_rows += nv
        self._inflight[li] = _InFlight(s, concept, casc, take, rows,
                                       labels, levels,
                                       t_dispatch=self.clock(),
                                       retries=retries)
        if len(self._inflight) > self._inflight_max:
            self._inflight_max = len(self._inflight)

    def _ready(self, labels) -> bool:
        return not hasattr(labels, "is_ready") or labels.is_ready()

    def _batch_timed_out(self, inf: _InFlight) -> bool:
        return (self.batch_timeout_s is not None
                and not self._ready(inf.labels)
                and self.clock() - inf.t_dispatch > self.batch_timeout_s)

    def _check_batch_timeouts(self, now: float) -> None:
        if self.batch_timeout_s is None:
            return
        for li in list(self._inflight):
            inf = self._inflight.get(li)
            if inf is not None and self._batch_timed_out(inf):
                self._recover_batch(li)

    def _recover_batch(self, li: int) -> None:
        """A timed-out in-flight batch: fail its lane, then re-route to a
        healthy one (bounded by ``dispatch_retries``) or complete its
        requests with a typed ``TimedOut``. Re-dispatch re-runs the SAME
        rung, so labels stay identical to an un-faulted run."""
        inf = self._inflight.pop(li)
        self._failed.add(li)
        st = self.stats[inf.concept]
        if (inf.retries < self.dispatch_retries
                and self._lane_for(inf.shard) is not None):
            st.retries += 1
            self._dispatch(inf.shard, inf.concept, inf.take,
                           casc=inf.casc, retries=inf.retries + 1,
                           count_rows=False)
        else:
            self._finish_rejected(inf.take, inf.concept,
                                  TimedOut("batch-timeout"))

    def deliver_ready(self) -> None:
        """Deliver finished in-flight batches; leave running ones in
        flight (the dispatch-ahead overlap window)."""
        for li in list(self._inflight):
            if self._ready(self._inflight[li].labels):
                self._deliver(li)

    def _deliver(self, li: int) -> None:
        inf = self._inflight.pop(li, None)
        if inf is None:
            return
        casc = inf.casc
        nv = len(inf.take)
        labels = np.asarray(inf.labels)[:nv]    # the one wait happens here
        sstore = self._shard_stores[inf.shard]
        sstore.record(casc.key, inf.rows, labels)
        # post-flush commit: shard-store merge semantics restricted to
        # the delivered rows (O(batch), not O(corpus), per delivery) —
        # a degraded rung commits under its OWN casc.key, so degraded
        # labels can never poison the primary's virtual column
        self.store.merge_rows_from(sstore, inf.rows)
        if inf.levels is not None and self.repcache is not None:
            # under the lane that made the levels: the cache orders its
            # slab copies after the lane's stream and keeps their memory
            with self._lanes[li]:
                for r, v in inf.levels.items():
                    self.repcache.put_rows(inf.rows, r, v)
        now = self.clock()
        st = self.stats[inf.concept]
        if casc is not self._ladder[inf.concept][0]:
            st.degraded_rows += nv
            st.degraded_batches += 1
        self._last_flush_lat[inf.concept] = now - inf.t_dispatch
        for req, lab in zip(inf.take, labels):
            req.result = int(lab)
            req.t_done = now
            st.latencies.append(now - req.t_arrival)
            self.delivered.append(req.rid)

    # --------------------------------------------------- host interface --
    def next_event_time(self) -> float | None:
        """Earliest instant at which time-driven work comes due: a flush
        deadline, a batch timeout, or a request deadline. None when no
        timed work is pending — the event host (serve/host.py) sleeps
        exactly until this."""
        cands = []
        nd = self.wheel.next_deadline()
        if nd is not None:
            cands.append(nd)
        if self.batch_timeout_s is not None:
            cands.extend(inf.t_dispatch + self.batch_timeout_s
                         for inf in self._inflight.values())
        if self.request_deadline_s is not None:
            cands.extend(q[0].t_arrival + self.request_deadline_s
                         for qs in self._queues
                         for q in qs.values() if q)
        return min(cands, default=None)

    def busy(self) -> bool:
        """True while any request is queued or any batch is in flight."""
        return bool(self._inflight) or any(
            q for qs in self._queues for q in qs.values())

    # ------------------------------------------------------------- stats --
    def latencies(self) -> list:
        out = []
        for st in self.stats.values():
            out.extend(st.latencies)
        return out

    def summary(self) -> dict:
        """Aggregate counters and gauges. ``devices`` counts the distinct
        devices the lanes use (GPUs, or the one CPU), ``lanes`` the
        dispatch slots (one per shard); ``failed_devices`` lists failed
        lane indices, the fault plan's keys."""
        agg = {k: sum(getattr(st, k) for st in self.stats.values())
               for k in ("requests", "store_hits", "rep_hit_rows",
                         "rows_evaluated", "batches", "padded_slots",
                         "size_flushes", "deadline_flushes",
                         "drain_flushes", "shed", "expired", "timeouts",
                         "retries", "degraded_rows", "degraded_batches",
                         "degrade_steps", "recover_steps")}
        agg["shards"] = self.n_shards
        agg["devices"] = len(set(self.devices))
        agg["lanes"] = len(self._lanes)
        agg["store_hit_rate"] = (agg["store_hits"] / agg["requests"]
                                 if agg["requests"] else 0.0)
        agg["goodput_requests"] = (agg["requests"] - agg["shed"]
                                   - agg["expired"] - agg["timeouts"])
        agg["degraded_fraction"] = (agg["degraded_rows"] / agg["requests"]
                                    if agg["requests"] else 0.0)
        # gauges (current + high-water): queue depth, in-flight batches
        agg["queue_depth"] = {
            "current": self._queued_total(),
            "max": max((st.depth_max for st in self.stats.values()),
                       default=0)}
        agg["in_flight"] = {"current": len(self._inflight),
                            "max": self._inflight_max}
        agg["failed_devices"] = sorted(self._failed)
        agg["active_levels"] = {c: self.active_level(c)
                                for c in self.cascades}
        lat = self.latencies()
        if lat:
            ms = np.asarray(lat, np.float64) * 1e3
            agg["latency_ms"] = {
                "p50": round(float(np.percentile(ms, 50)), 3),
                "p95": round(float(np.percentile(ms, 95)), 3),
                "p99": round(float(np.percentile(ms, 99)), 3)}
        else:
            agg["latency_ms"] = None
        if self.repcache is not None:
            agg["repcache"] = self.repcache.stats()
        if self.faults is not None:
            agg["faults_injected"] = dict(self.faults.injected)
        return agg
