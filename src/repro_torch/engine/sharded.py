"""Sharded scan engine (DESIGN.md §9) on shard lanes of torch devices.

Partitions the metadata-survivor row set across N shards
(`sharding/policy.plan_shards`: range or hash partitioning, skew-aware
when the planner's per-row cost estimates are available) and runs the
chunk/stage pipeline per shard. Two execution backends:

* **lockstep (default)** — shards advance through the scan in
  synchronized supersteps. A shard runs on a *lane*: a device
  (`launch/mesh.shard_devices`, round-robin over the GPUs) and, on a
  card, a CUDA stream of its own there, so the N lanes of one H100 run
  side by side. A superstep issues, lane after lane, the gather of one
  bucketed index slab from the corpus and either the fused pyramid +
  stage-0 ingest (core/executor.make_fused_ingest: the hand-written
  ``fused_pyramid_stage0`` kernel on a card) or a stage's flush
  (core/executor.run_cascade_on_pyramid), each under its lane's stream;
  labels come back through pinned host memory and the host waits once
  for the superstep. Carried pyramid levels stay on the lane's device;
  the base level is gathered again from the corpus at flush time. Lanes
  on the corpus's device gather from the corpus itself; a lane on another
  GPU gets its partition (and a copy of the cascades' weights) once per
  scan. Row routing between stages stays host-side numpy, exactly the
  serial engine's cache-aware walk.
* **serial** (``parallel=False``) — one ``ScanEngine.scan_rows`` call
  per shard, on the engine's own stream. Same row sets, no concurrency;
  the reference path the differential tests pit the lockstep against.

Each shard scans against a shard-local `VirtualColumnStore` seeded from
the corpus-wide store, and the shard stores are merged back
(`VirtualColumnStore.merge_from`: union of computed entries, a computed
label is never overwritten) so re-planned queries reuse every partial
column regardless of which shard computed it.

Exactness: the ShardPlan assigns every surviving row to exactly one
shard, and a row's labels depend only on its own pooled pyramid rows, so
the merged row set equals the single-shard `ScanEngine`'s and
`naive_scan`'s for any shard count, partitioning strategy or backend
(tests/test_torch_sharded.py). The lockstep runs its slabs at
power-of-two widths (``slab_width``), the serial engine at its chunk:
the stage-0 kernel's scores do not depend on the launch width
(kernels/bindings.ps0_dense_plan); the later levels' ``F.conv2d`` may
pick another cuDNN algorithm at another batch size. The planner's
mid-scan re-order hook is a serial-engine feature; the sharded backends
run the plan's order unchanged and only feed the monitor.

Streams: every lane first waits for its device's current stream (the
corpus and the staged partitions are written there), allocates what it
reads and writes under its own stream (the caching allocator then hands
a freed block back to that stream only), and the device's current stream
waits for every lane before the scan returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass, field
from functools import partial
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.executor import Stage0
from repro_torch.core.transforms import resize_area
from repro_torch.engine.scan import (CompiledCascade, ScanEngine, ScanStats,
                                     StageStats, VirtualColumnStore,
                                     level_schedule, stage_needs)
from repro_torch.launch.mesh import shard_devices
from repro_torch.sharding.policy import ShardPlan, plan_shards


# ---------------------------------------------------------- slab builder --
SLAB_FLOOR = 16


def slab_width(n_valid: int, cap: int, floor: int = SLAB_FLOOR) -> int:
    """Bucketed slab width: smallest power-of-two >= ``n_valid``,
    floored at ``floor`` and capped at ``cap``. Keeps sparse batches
    (late-stage lockstep slabs, deadline-triggered partial serving
    flushes) from paying full-width padding compute while bounding the
    number of distinct launch shapes to O(log cap). Shared by the
    lockstep supersteps here and the serving path's batch assembler."""
    b = floor
    while b < n_valid:
        b *= 2
    return min(b, cap)


def pad_rows(ids: np.ndarray, width: int) -> np.ndarray:
    """Pad a valid id prefix to the slab width by repeating the last id
    (the lockstep/serving padding policy: stale duplicate rows are
    computed and discarded, never recorded). Requires 0 < len <= width."""
    ids = np.asarray(ids, np.int64)
    return np.concatenate([ids, np.full(width - len(ids), ids[-1],
                                        np.int64)])


@dataclass
class ShardedScanStats:
    plan: ShardPlan
    backend: str                       # 'lockstep' | 'serial'
    n_devices: int = 1                 # distinct devices the shards use
    lanes: int = 1                     # shards run side by side
    supersteps: int = 0                # lockstep group dispatches issued
    shards: list = field(default_factory=list)   # ScanStats per shard
    # lockstep lane slabs run: (stage, slab width) -> count; stage 0's are
    # the fused ingest's launches
    slabs: dict = field(default_factory=dict)

    @property
    def rows_scanned(self) -> int:
        return sum(s.rows_scanned for s in self.shards)

    @property
    def rows_evaluated(self) -> int:
        return sum(s.rows_evaluated for s in self.shards)

    @property
    def level_rows(self) -> dict:
        """Per-level materialization counters summed across shards
        (same shape as ScanStats.level_rows)."""
        out: dict = {}
        for sh in self.shards:
            for r, n in sh.level_rows.items():
                out[r] = out.get(r, 0) + n
        return out

    @property
    def stages(self) -> list:
        """Per-predicate StageStats summed across shards (same shape the
        single-shard ScanStats exposes)."""
        if not self.shards or not self.shards[0].stages:
            return []
        out = []
        for i, st0 in enumerate(self.shards[0].stages):
            agg = StageStats(st0.concept)
            for sh in self.shards:
                st = sh.stages[i]
                agg.rows_in += st.rows_in
                agg.rows_cached += st.rows_cached
                agg.rows_evaluated += st.rows_evaluated
                agg.batches += st.batches
            out.append(agg)
        return out


@dataclass
class ShardedScanResult:
    indices: np.ndarray
    stats: ShardedScanStats


class _ObserveOnly:
    """Monitor wrapper for the serial shard loop: forwards observed
    labels (so re-plans see measured selectivities) but suppresses
    re-order proposals — a per-shard re-order would desync the shards'
    stage aggregation for zero dispatch savings."""

    def __init__(self, monitor):
        self._monitor = monitor

    def observe(self, key, labels, *, marginal: bool = False) -> None:
        self._monitor.observe(key, labels, marginal=marginal)

    def propose(self, cascades):
        return None


def _cascade_on(casc: CompiledCascade, dev) -> CompiledCascade:
    """``casc`` with its weights copied to ``dev``, for a lane on another
    GPU than the corpus's. Its models must be ``partial(cnn_predict_proba,
    params)``, as core/pipeline compiles them."""
    from repro_torch.models.cnn import cnn_predict_proba

    def move(tree):
        if isinstance(tree, dict):
            return {k: move(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v) for v in tree]
        return tree.to(dev) if torch.is_tensor(tree) else tree

    fns = []
    for fn in casc.model_fns:
        if not (isinstance(fn, partial) and fn.func is cnn_predict_proba):
            raise ValueError(f"{casc.concept}: a lane on {dev} copies the "
                             f"cascade's weights, which needs its models "
                             f"as partial(cnn_predict_proba, params)")
        fns.append(partial(cnn_predict_proba, move(fn.args[0])))
    s0 = casc.stage0
    if s0 is not None:
        s0 = Stage0(move(s0.params), s0.rep, move(s0.qparams))
    return dataclasses.replace(casc, model_fns=fns, stage0=s0)


def _indexed(dev) -> torch.device:
    """``dev`` with its index (a bare ``cuda`` names the current GPU), so
    that a lane's device compares equal to the corpus tensor's."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _Lane:
    """One shard's lane: its device and stream (None on the CPU) and, for
    a scan, the tensor its rows are gathered from with each row's position
    there, the cascades as its device holds them, and the engine whose
    ingest and flush programs it runs. The serving path
    (serve/service.py) keeps one lane per shard for a service's life and
    uses its device, stream and copies."""

    def __init__(self, device, stream, src=None, pos=None, cascades=None,
                 programs=None):
        self.device, self.stream = device, stream
        self.src, self.pos = src, pos
        self.cascades, self.programs = cascades, programs

    def __enter__(self):
        # the lane's device AND stream, both entered: CUDA's current
        # device and stream are per thread, and the serving event host
        # dispatches from a thread of its own
        self._ctx = contextlib.ExitStack()
        if self.stream is not None:
            self._ctx.enter_context(torch.cuda.device(self.device))
            self._ctx.enter_context(torch.cuda.stream(self.stream))
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def put(self, ids: np.ndarray) -> torch.Tensor:
        """int64 ids on the lane's device, copied on its stream from
        pinned memory (a pageable copy would wait for the stream)."""
        t = torch.from_numpy(np.asarray(ids, np.int64))
        if self.stream is None:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def take(self, v: torch.Tensor, keep: np.ndarray) -> torch.Tensor:
        """The rows of ``v`` where ``keep`` (host bool) is set; an index
        gather, so the host does not wait for a boolean mask's count."""
        return v if keep.all() else v[self.put(np.flatnonzero(keep))]

    def fetch(self, t: torch.Tensor):
        """Start ``t``'s copy to the host; ``ready`` returns it."""
        if self.stream is None:
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.stream)
        return host, done

    @staticmethod
    def ready(fetched) -> np.ndarray:
        host, done = fetched
        if done is not None:
            done.synchronize()
        return host.numpy()


class ShardedScanEngine:
    """Corpus-wide scan over N shards with one merged virtual-column
    store. Wraps a single-device ScanEngine for the shared pieces (the
    corpus on ``device``, metadata masking, the serial shard unit, the
    corpus-wide store, the ingest and flush programs); owns the shard
    planning and the lockstep lanes. ``devices`` (default
    ``launch/mesh.shard_devices``) places shard i on ``devices[i]``."""

    def __init__(self, images, metadata: Mapping[str, np.ndarray]
                 | None = None, *, shards: int | None = None,
                 chunk: int = 64, strategy: str = "range",
                 devices: Sequence | None = None, fused: bool = True,
                 lazy: bool = True, int8: bool = False,
                 use_kernel: bool | None = None, device=None):
        self.local = ScanEngine(images, metadata, chunk=chunk, fused=fused,
                                lazy=lazy, int8=int8, use_kernel=use_kernel,
                                device=device)
        self.devices = ([_indexed(d) for d in devices]
                        if devices is not None
                        else shard_devices(shards, device=self.local.device))
        self.n_shards = int(shards) if shards is not None \
            else len(self.devices)
        if self.n_shards < 1:
            raise ValueError("need at least one shard")
        self.chunk = int(chunk)
        self.strategy = strategy
        self._streams: dict = {}    # lane index -> its CUDA stream
        self._remote: dict = {}     # other device -> (programs, cascades)

    # ------------------------------------------------------- delegation --
    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def images(self) -> torch.Tensor:
        return self.local.images

    @property
    def metadata(self) -> Mapping[str, np.ndarray]:
        """The corpus metadata columns (the algebra layer's temporal
        join reads its timestamp column engine-agnostically —
        engine/algebra.execute_join)."""
        return self.local.metadata

    @property
    def store(self) -> VirtualColumnStore:
        """The corpus-wide merged store (shared with the wrapped serial
        engine, so mixed sharded/unsharded sessions see one cache)."""
        return self.local.store

    def reset_cache(self) -> None:
        self.local.reset_cache()

    def metadata_mask(self, metadata_eq: Mapping | None) -> np.ndarray:
        return self.local.metadata_mask(metadata_eq)

    # ---------------------------------------------------- shard planning --
    def row_weights(self, cascades: Sequence[CompiledCascade],
                    ids: np.ndarray, *, monitor=None) -> np.ndarray:
        """Expected evaluation seconds per row under the planner's
        cost/selectivity estimates, refined by the store: a cached label
        costs nothing and collapses the row's survival to 0/1. This is
        the skew-aware signal range partitioning balances on. ``monitor``
        (engine/planner.OnlineReorderer) swaps the static plan-time
        selectivities for the selectivities OBSERVED in earlier flushes
        (``monitor.refined``)."""
        ids = np.asarray(ids, np.int64)
        w = np.zeros(len(ids))
        alive = np.ones(len(ids))
        for casc in cascades:
            sel = (monitor.refined(casc.key) if monitor is not None
                   else casc.selectivity)
            cached = self.store.lookup(casc.key, ids)
            w += alive * np.where(cached < 0, max(casc.cost_s, 1e-12), 0.0)
            alive *= np.where(cached == 0, 0.0,
                              np.where(cached == 1, 1.0,
                                       np.clip(sel, 0.0, 1.0)))
        return w

    def plan_for(self, cascades: Sequence[CompiledCascade],
                 metadata_eq: Mapping | None = None, *,
                 ids: np.ndarray | None = None, monitor=None) -> ShardPlan:
        """The ShardPlan execute() would use: survivor ids partitioned
        under this engine's strategy with skew-aware weights (observed-
        selectivity-refined when a ``monitor`` is given)."""
        if ids is None:
            ids = np.where(self.metadata_mask(metadata_eq))[0]
        weights = (self.row_weights(cascades, ids, monitor=monitor)
                   if cascades else None)
        return plan_shards(ids, self.n_shards, strategy=self.strategy,
                           weights=weights)

    # --------------------------------------------------------- execution --
    def execute(self, cascades: Sequence[CompiledCascade],
                metadata_eq: Mapping | None = None, *,
                shard_plan: ShardPlan | None = None,
                parallel: bool = True,
                survivors: np.ndarray | None = None,
                monitor: object | None = None) -> ShardedScanResult:
        """SELECT row ids WHERE metadata_eq AND every cascade labels 1,
        sharded. ``shard_plan`` overrides the engine's own planning (it
        must partition exactly the metadata survivors). ``survivors``
        is an index-pruned survivor set (engine/ingest.CandidateIndex
        via PhysicalPlan.index_prefilter): only metadata survivors ALSO
        in it are partitioned and scanned. ``monitor``
        (engine/planner.OnlineReorderer) is OBSERVE-ONLY here: every
        evaluation flush feeds it measured labels — so the NEXT
        ``plan_for`` partitions on observed selectivities — but its
        re-order proposals are never applied mid-scan."""
        cascades = list(cascades)
        ids_all = np.where(self.metadata_mask(metadata_eq))[0]
        if survivors is not None:
            ids_all = np.intersect1d(ids_all,
                                     np.asarray(survivors, np.int64))
        if shard_plan is None:
            shard_plan = self.plan_for(cascades, ids=ids_all,
                                       monitor=monitor)
        else:
            shard_plan.validate(ids_all)

        backend = "lockstep" if parallel else "serial"
        stats = ShardedScanStats(
            shard_plan, backend,
            n_devices=min(self.n_shards, len(set(self.devices))),
            lanes=shard_plan.n_shards if parallel else 1,
            shards=[ScanStats(stages=[StageStats(c.concept)
                                      for c in cascades])
                    for _ in range(shard_plan.n_shards)])
        for st, part in zip(stats.shards, shard_plan.shards):
            st.rows_scanned = len(part)
        if not cascades:
            return ShardedScanResult(ids_all, stats)

        # shard-local stores seeded from the corpus-wide store (only the
        # shard's own partition rows — all it will ever look up)
        shard_stores = []
        for part in shard_plan.shards:
            st = VirtualColumnStore(self.local.n_rows)
            st.seed_from(self.store, part)
            shard_stores.append(st)
        if parallel:
            accepted = self._lockstep(cascades, shard_plan, shard_stores,
                                      stats, monitor=monitor)
        else:
            proxy = _ObserveOnly(monitor) if monitor is not None else None
            accepted = []
            for si, part in enumerate(shard_plan.shards):
                if not len(part):
                    continue
                r = self.local.scan_rows(cascades, part,
                                         store=shard_stores[si],
                                         monitor=proxy)
                stats.shards[si] = r.stats
                accepted.append(r.indices)

        # merge: union of computed entries, no -1 overwrites
        for st in shard_stores:
            self.store.merge_from(st)

        nonempty = [a for a in accepted if len(a)]
        out = (np.sort(np.concatenate(nonempty)) if nonempty
               else np.empty(0, np.int64))
        return ShardedScanResult(out, stats)

    # ------------------------------------------------- lockstep backend --
    def _slab_width(self, n_valid: int) -> int:
        """Module-level ``slab_width`` bound to this engine's chunk."""
        return slab_width(n_valid, self.chunk)

    def _open_lanes(self, cascades, todo: list) -> list:
        """One lane per shard for this scan; ``todo[j]`` are the rows
        shard j must scan. Lane j runs on ``devices[j]``: on the corpus's
        device it gathers from the corpus, elsewhere from its rows
        copied there."""
        home = self.local.images.device
        lanes = []
        for j, ids in enumerate(todo):
            dev = self.devices[j % len(self.devices)]
            if dev.type != "cuda":
                lanes.append(_Lane(home, None, self.local.images, ids,
                                   cascades, self.local))
                continue
            if j not in self._streams:
                self._streams[j] = torch.cuda.Stream(dev)
            stream = self._streams[j]
            if dev == home:
                src, pos, cascs, programs = (self.local.images, ids,
                                             cascades, self.local)
            else:
                programs, cascs = self._remote_programs(dev, cascades)
                src = self.local.images[torch.from_numpy(ids).to(home)
                                        ].to(dev)
                pos = np.arange(len(ids), dtype=np.int64)
                src.record_stream(stream)
            # the corpus and the staged rows were written on the
            # device's current stream
            stream.wait_stream(torch.cuda.current_stream(dev))
            lanes.append(_Lane(dev, stream, src, pos, cascs, programs))
        return lanes

    def _remote_programs(self, dev, cascades):
        """(engine, cascades) for lanes on ``dev``, another GPU than the
        corpus's: an engine over no rows, whose ingest and flush programs
        the lanes run, and the cascades with their weights copied to
        ``dev`` (kept per cascade key)."""
        if dev not in self._remote:
            loc = self.local
            shell = ScanEngine(
                torch.empty((0, *loc.images.shape[1:]), device=dev),
                chunk=self.chunk, fused=loc.fused, lazy=loc.lazy,
                int8=loc.int8, use_kernel=loc.use_kernel, device=dev)
            self._remote[dev] = (shell, {})
        shell, moved = self._remote[dev]
        for c in cascades:
            if c.key not in moved:
                moved[c.key] = _cascade_on(c, dev)
        return shell, [moved[c.key] for c in cascades]

    @torch.no_grad()
    def _lockstep(self, cascades, plan: ShardPlan, stores, stats,
                  monitor=None):
        """Stage-synchronous shard execution on one lane per shard: every
        superstep issues one bucketed slab per lane that still has rows,
        then waits once for the slabs' labels. Host-side routing walks
        cached labels between stages, exactly like the serial engine —
        including the lazy level schedule (level_schedule): later-stage-
        only levels are first-touch derived inside the stage's flush."""
        base_hw = int(self.images.shape[1])
        needed, union_res = stage_needs(cascades, base_hw)
        for sh in stats.shards:     # the STATIC union level set, same
            sh.pyramid_levels = union_res    # as the serial shard unit
        ingest_set, carry, derive = level_schedule(cascades, base_hw,
                                                   self.local.lazy)
        k = len(cascades)
        chunk = self.chunk
        accepted: list[np.ndarray] = []

        # ---- presplit: rows whose outcome the seeded store already
        # determines (a cached 0, or cached 1s through every stage)
        # never enter the pipeline — a fully-cached re-run issues ZERO
        # supersteps and opens no lane
        todo = []
        for si, ids in enumerate(plan.shards):
            walking = np.ones(len(ids), bool)   # on an all-cached-1 path
            unknown = np.zeros(len(ids), bool)  # hit a -1 while walking
            for casc in cascades:
                c = stores[si].lookup(casc.key, ids)
                unknown |= walking & (c < 0)
                walking &= c == 1
            if walking.any():
                accepted.append(ids[walking])
            todo.append(ids[unknown])
            # cache-determined rows still count as stage traffic (all
            # served from the store), keeping stats comparable with the
            # serial backend, which walks them through route()
            at = ~unknown
            for s, casc in enumerate(cascades):
                if not at.any():
                    break
                st = stats.shards[si].stages[s]
                n = int(at.sum())
                st.rows_in += n
                st.rows_cached += n
                at &= stores[si].lookup(casc.key, ids) == 1
        if not any(len(u) for u in todo):
            return accepted

        lanes = self._open_lanes(cascades, todo)
        # worklists[s][j]: (ids, pos, rows) segments awaiting evaluation
        # at stage s on lane j; pos indexes the lane's source so the base
        # level is gathered again on the device instead of carried
        worklists: list[list[list]] = [[[] for _ in lanes]
                                       for _ in range(k)]

        def count_levels(j, res, n):
            lr = stats.shards[j].level_rows
            for r in res:
                lr[r] = lr.get(r, 0) + n

        def count_slab(stage, b):
            stats.slabs[(stage, b)] = stats.slabs.get((stage, b), 0) + 1

        def route(j, stage, ids, pos, rows):
            """Advance lane j's rows through cached labels; queue them at
            the first stage that needs evaluation (device work on the
            lane's stream: the caller holds it)."""
            lane = lanes[j]
            while len(ids):
                if stage == k:
                    accepted.append(ids)
                    return
                casc = cascades[stage]
                st = stats.shards[j].stages[stage]
                st.rows_in += len(ids)
                cached = stores[j].lookup(casc.key, ids)
                known = cached >= 0
                st.rows_cached += int(known.sum())
                unk = ~known
                if unk.any():
                    sub = {r: lane.take(rows[r], unk) for r in carry[stage]
                           if r in rows}
                    missing = [r for r in carry[stage] if r not in rows]
                    if missing:
                        # cache-skip backfill, exactly the serial
                        # engine's feed(): rows that hopped over earlier
                        # stages on cached labels never saw those
                        # stages' flush-time derivation — pool their
                        # carry levels straight from base
                        imgs = lane.src[lane.put(pos[unk])]
                        for r in missing:
                            sub[r] = resize_area(imgs, r)
                        count_levels(j, missing, int(unk.sum()))
                    worklists[stage][j].append((ids[unk], pos[unk], sub))
                keep = known & (cached == 1)
                ids, pos = ids[keep], pos[keep]
                rows = {r: lane.take(v, keep) for r, v in rows.items()}
                stage += 1

        # ---- ingest: fused pyramid + FULL cascade 0, lockstep ---------
        casc0 = cascades[0]
        out_res = tuple(carry[1]) if k > 1 else ()
        n_steps = max(math.ceil(len(u) / chunk) for u in todo if len(u))
        for t in range(n_steps):
            issued = []
            for j, lane in enumerate(lanes):
                sl = slice(t * chunk, (t + 1) * chunk)
                seg, pos = todo[j][sl], lane.pos[sl]
                if not len(seg):
                    continue
                b = self._slab_width(len(seg))
                ingest = lane.programs._ingest_fn(lane.cascades[0], out_res)
                with lane:
                    labels, levels = ingest(lane.src[lane.put(
                        pad_rows(pos, b))])
                    issued.append((j, seg, pos, levels,
                                   lane.fetch(labels[:len(seg)])))
                count_slab(0, b)
            stats.supersteps += 1
            for j, ids, pos, levels, fetched in issued:
                lab = _Lane.ready(fetched)
                nv = len(ids)
                sh = stats.shards[j]
                sh.chunks += 1
                count_levels(j, ingest_set, nv)
                st = sh.stages[0]
                st.rows_in += nv
                cached = stores[j].lookup(casc0.key, ids)
                known = cached >= 0
                st.rows_cached += int(known.sum())
                unk = ~known
                if unk.any():
                    # the fused ingest scored the whole slab; only the
                    # genuinely-unknown rows count as evaluations, and
                    # cached labels always win for routing
                    stores[j].record(casc0.key, ids[unk], lab[unk])
                    st.rows_evaluated += int(unk.sum())
                    st.batches += 1
                    if monitor is not None:
                        # stage-0 slabs see the unfiltered shard stream
                        monitor.observe(casc0.key, lab[unk], marginal=True)
                keep = np.where(known, cached, lab) == 1
                lane = lanes[j]
                with lane:
                    route(j, 1, ids[keep], pos[keep],
                          {r: lane.take(levels[r][:nv], keep)
                           for r in out_res})

        # ---- stages 1..k-1: flush worklists in lockstep slabs ---------
        for s in range(1, k):
            # host-carried small levels; the flush program first-touch
            # derives derive[s] (and gathers base when the cascade or a
            # derivation reads it) — exactly the serial flush()
            need_base = (base_hw in cascades[s].resolutions
                         or bool(derive[s]))
            in_res = tuple(carry[s]) + ((base_hw,) if need_base else ())
            down_carry = tuple(r for r in carry[s]
                               if s + 1 < k and r in needed[s + 1])
            out_dev = tuple(r for r in derive[s]
                            if s + 1 < k and r in needed[s + 1])
            pend = []
            for j, lane in enumerate(lanes):
                segs = worklists[s][j]
                if not segs:
                    pend.append((np.empty(0, np.int64),
                                 np.empty(0, np.int64), {}))
                    continue
                with lane:
                    rows = {r: torch.cat([rw[r] for _, _, rw in segs])
                            for r in carry[s]}
                pend.append((np.concatenate([a for a, _, _ in segs]),
                             np.concatenate([p for _, p, _ in segs]), rows))
            worklists[s] = None     # the concatenated copies replace them
            n_steps = max(math.ceil(len(p[0]) / chunk) for p in pend)
            for t in range(n_steps):
                lo = t * chunk
                issued = []
                for j, lane in enumerate(lanes):
                    ids, pos, rows = pend[j]
                    sids, spos = ids[lo:lo + chunk], pos[lo:lo + chunk]
                    nv = len(sids)
                    if not nv:
                        continue
                    b = self._slab_width(nv)
                    flush = lane.programs._cascade_fn(lane.cascades[s],
                                                      in_res, out_dev)
                    with lane:
                        at = lane.put(pad_rows(lo + np.arange(nv), b))
                        pyr = {r: rows[r][at] for r in carry[s]}
                        if need_base:
                            pyr[base_hw] = lane.src[lane.put(
                                pad_rows(spos, b))]
                        labels, dev_levels = flush(pyr)
                        issued.append((j, sids, spos, dev_levels,
                                       lane.fetch(labels[:nv])))
                    count_slab(s, b)
                stats.supersteps += 1
                casc = cascades[s]
                for j, sids, spos, dev_levels, fetched in issued:
                    lab = _Lane.ready(fetched)
                    nv = len(sids)
                    st = stats.shards[j].stages[s]
                    stores[j].record(casc.key, sids, lab)
                    st.rows_evaluated += nv
                    st.batches += 1
                    count_levels(j, derive[s], nv)
                    if monitor is not None:
                        monitor.observe(casc.key, lab, marginal=False)
                    keep = lab == 1
                    lane = lanes[j]
                    with lane:
                        down = {r: lane.take(pend[j][2][r][lo:lo + nv], keep)
                                for r in down_carry}
                        for r in out_dev:
                            down[r] = lane.take(dev_levels[r][:nv], keep)
                        route(j, s + 1, sids[keep], spos[keep], down)
        for lane in lanes:
            if lane.stream is not None:
                torch.cuda.current_stream(lane.device).wait_stream(
                    lane.stream)
        return accepted
