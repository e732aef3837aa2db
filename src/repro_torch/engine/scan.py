"""Unified multi-predicate scan engine (DESIGN.md §4.2) on a torch device.

Executes a PhysicalPlan (engine/planner.py) over an image corpus that
lives on the engine's device as ONE tensor:

* the corpus is streamed in fixed-size chunks of the rows that survive
  the metadata predicates, gathered on the device; each chunk
  materializes ONE shared RGB representation pyramid covering the first
  cascade's levels (later-stage-only levels are pooled at first touch by
  survivors — ``level_schedule``). On a card with stage-0 params, the
  chunk's pyramid + the first cascade's level-0 CNN are one hand-written
  kernel launch (kernels/image_transform.fused_pyramid_stage0);
* binary predicates run as a pipeline of mask-compacted stages: rows
  surviving predicate k-1 accumulate (with their already-pooled pyramid
  rows, on the device) in predicate k's fixed-capacity buffer; a full
  buffer flushes through the cascade at ONE static batch width
  (core/executor.run_cascade_on_pyramid). Rows eliminated earlier are
  never evaluated;
* every computed label lands in a VirtualColumnStore keyed by
  (concept, cascade-id), kept PARTIAL so re-planned queries reuse every
  row previously decided by the same physical cascade.

Per-row computations are independent of the surrounding batch at a fixed
width, so the selected row set equals ``naive_scan``'s one-predicate-at-
a-time full scans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.executor import (Stage0, make_fused_ingest,
                                       run_cascade_on_pyramid)
from repro_torch.core.transforms import materialize_pyramid, resize_area
from repro_torch.device import resolve_device


@dataclass
class CompiledCascade:
    """A physically-selected cascade, ready to execute: the planner's
    output unit and the scan engine's unit of work. ``cascade_id`` must
    identify the physical cascade (models + thresholds) stably so the
    virtual-column store can recognize it across plans."""
    concept: str
    cascade_id: tuple
    reps: list                       # list[Representation], one per level
    model_fns: list                  # level input tensor -> scores (B,)
    thresholds: list                 # [(p_low, p_high)...]; final (None, None)
    cost_s: float = 0.0              # estimated seconds/row (planner)
    selectivity: float = 0.5         # estimated P(predicate true)
    # serving-path knob; the scan paths ignore it and run full-width
    # levels so results are batch-packing independent
    capacities: list | None = None
    # level-0 model in kernel-foldable form (core/executor.Stage0)
    stage0: Stage0 | None = None

    @property
    def key(self) -> tuple:
        return (self.concept, tuple(self.cascade_id))

    @property
    def resolutions(self) -> list[int]:
        return sorted({r.resolution for r in self.reps}, reverse=True)


class VirtualColumnStore:
    """Partial virtual columns keyed by (concept, cascade-id): int8 labels
    with -1 = not yet evaluated (host numpy). Shared across executions of
    one engine so re-planned queries reuse prior work."""

    def __init__(self, n_rows: int):
        self.n_rows = n_rows
        self._cols: dict[tuple, np.ndarray] = {}

    def column(self, key: tuple) -> np.ndarray:
        if key not in self._cols:
            self._cols[key] = np.full(self.n_rows, -1, np.int8)
        return self._cols[key]

    def lookup(self, key: tuple, ids: np.ndarray) -> np.ndarray:
        return self.column(key)[ids]

    def record(self, key: tuple, ids: np.ndarray, labels) -> None:
        self.column(key)[ids] = np.asarray(labels, np.int8)

    def known_rows(self, key: tuple) -> int:
        return int((self.column(key) >= 0).sum())

    def rows_with_label(self, key: tuple, ids: np.ndarray,
                        label: int) -> np.ndarray:
        """Of ``ids``, the rows whose stored label equals ``label``.
        The algebra executor's NOT path (engine/algebra.py, DESIGN.md
        §15): after a scan has decided every candidate row, the
        decided-0 rows of a cascade's int8 column are exactly ¬Pred."""
        ids = np.asarray(ids, np.int64)
        return ids[self.column(key)[ids] == label]

    def keys(self) -> list[tuple]:
        return list(self._cols)

    def seed_from(self, other: "VirtualColumnStore", rows) -> None:
        """Copy ``other``'s labels for ``rows`` only — the shard-store
        seed: a shard executor never looks beyond its partition, so
        seeding its row slice is enough (and O(partition), not
        O(corpus), per shard)."""
        assert other.n_rows == self.n_rows
        for key in other.keys():
            self.column(key)[rows] = other.column(key)[rows]

    def merge_from(self, other: "VirtualColumnStore") -> None:
        """Union of computed entries: ``other``'s known labels fill this
        store's unknown (-1) slots. A computed entry is NEVER overwritten
        — neither by -1 nor by a conflicting label — so merging shard
        stores in any order yields the same corpus-wide store as long as
        shards evaluated disjoint rows (the ShardPlan invariant)."""
        assert other.n_rows == self.n_rows
        for key in other.keys():
            src = other.column(key)
            dst = self.column(key)
            fill = (dst < 0) & (src >= 0)
            dst[fill] = src[fill]

    def merge_rows_from(self, other: "VirtualColumnStore", rows) -> None:
        """``merge_from`` restricted to ``rows``: identical union /
        never-overwrite semantics at O(len(rows)) per column instead of
        O(corpus) — the serving path's per-delivery commit."""
        assert other.n_rows == self.n_rows
        rows = np.asarray(rows, np.int64)
        for key in other.keys():
            src = other.column(key)[rows]
            dst = self.column(key)
            take = (dst[rows] < 0) & (src >= 0)
            if take.any():
                dst[rows[take]] = src[take]

    def save(self, path, token: tuple = ()) -> None:
        """Persist the store as an npz (labels verbatim, keys via repr);
        ``token`` fingerprints the owning corpus."""
        data = {"n_rows": np.int64(self.n_rows),
                "token": np.asarray(token, np.float64),
                "keys": np.array([repr(k) for k in self._cols])}
        for i, col in enumerate(self._cols.values()):
            data[f"col_{i}"] = col
        np.savez(path, **data)

    @classmethod
    def load(cls, path, token: tuple = ()) -> "VirtualColumnStore":
        """Inverse of ``save``; refuses a snapshot saved for a different
        corpus ``token`` (row-indexed labels would be misattributed)."""
        import ast
        with np.load(path, allow_pickle=False) as z:
            if not np.array_equal(z["token"],
                                  np.asarray(token, np.float64)):
                raise ValueError(
                    "VirtualColumnStore snapshot was saved for a "
                    "different corpus — its row-indexed labels would "
                    "be misattributed; refusing to load")
            store = cls(int(z["n_rows"]))
            for i, key in enumerate(z["keys"]):
                store._cols[ast.literal_eval(str(key))] = \
                    z[f"col_{i}"].astype(np.int8)
        return store


def stage_needs(cascades: Sequence[CompiledCascade],
                base_hw: int) -> tuple[list, tuple]:
    """``needed[s]``: pyramid resolutions stages >= s still require;
    ``union_res``: needed[0] plus the raw base."""
    needed: list[list[int]] = []
    acc: set[int] = set()
    for c in reversed(cascades):
        acc |= {r.resolution for r in c.reps}
        needed.append(sorted(acc, reverse=True))
    needed = needed[::-1]
    union_res = tuple(sorted(set(needed[0]) | {base_hw}, reverse=True))
    return needed, union_res


def level_schedule(cascades: Sequence[CompiledCascade], base_hw: int,
                   lazy: bool = True) -> tuple[tuple, list, list]:
    """The engine's level-materialization schedule (DESIGN.md §13):
    ``ingest`` (non-base levels pooled at chunk ingest: lazy = the first
    cascade's levels, eager = the whole union), ``carry[s]`` (levels rows
    entering stage s carry in their buffer) and ``derive[s]`` (levels
    stage s's flush pools at first touch by survivors)."""
    needed, _ = stage_needs(cascades, base_hw)
    res = [{r.resolution for r in c.reps} for c in cascades]
    ingest = (set(res[0]) if lazy else set(needed[0])) - {base_hw}
    mat = ingest | {base_hw}
    carry: list[tuple] = []
    derive: list[tuple] = []
    for s in range(len(cascades)):
        carry.append(tuple(sorted((set(needed[s]) & mat) - {base_hw},
                                  reverse=True)))
        derive.append(tuple(sorted(res[s] - mat, reverse=True)))
        mat |= res[s]
    return tuple(sorted(ingest, reverse=True)), carry, derive


@dataclass
class StageStats:
    concept: str
    rows_in: int = 0          # rows routed to this predicate
    rows_cached: int = 0      # resolved from the virtual-column store
    rows_evaluated: int = 0   # rows actually run through the cascade
    batches: int = 0          # cascade invocations (static-width flushes)


@dataclass
class ScanStats:
    chunks: int = 0           # ingest chunks == shared pyramids built
    rows_scanned: int = 0     # rows surviving metadata (pyramid rows)
    rep_rows_cached: int = 0  # rows whose pooled levels came from the
    #                           cross-query representation cache (no
    #                           per-chunk pyramid materialization)
    reorders: int = 0         # mid-scan predicate re-orderings applied
    pyramid_levels: tuple = ()  # static union level set (+ raw base)
    level_rows: dict = field(default_factory=dict)  # measured per-level
    #                           materializations: resolution -> valid rows
    stages: list = field(default_factory=list)

    @property
    def rows_evaluated(self) -> int:
        return sum(s.rows_evaluated for s in self.stages)


@dataclass
class ScanResult:
    indices: np.ndarray       # sorted matching row ids
    stats: ScanStats


class _StageBuffer:
    """Fixed-capacity row accumulator for one predicate stage: ids (host)
    plus the pooled pyramid rows (device) every stage >= this one still
    needs."""

    def __init__(self, cap: int, resolutions: Sequence[int], device):
        self.cap = cap
        self.ids = np.zeros(cap, np.int64)
        self.rows = {r: torch.zeros((cap, r, r, 3), device=device)
                     for r in resolutions}
        self.fill = 0


def _corpus(images, device) -> torch.Tensor:
    if torch.is_tensor(images):
        return images.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(images, np.float32)
                            ).to(device)


def _mask(v: torch.Tensor, keep: np.ndarray) -> torch.Tensor:
    return v[torch.from_numpy(keep).to(v.device)]


class ScanEngine:
    """Streaming multi-predicate scan over one corpus resident on
    ``device`` (default ``cuda``). Holds the virtual-column store and the
    per-cascade flush/ingest closures, so repeated or re-planned queries
    reuse both.

    ``fused``: chunk ingest runs pyramid + the FULL first cascade as one
    unit (instead of a pyramid pass + stage-0 buffer flushes). ``lazy``:
    later-stage-only levels are pooled at flush-time first touch.
    ``int8``: stage-0 inference on int8-quantized weights.
    ``use_kernel``: force the fused pyramid+stage-0 kernel on/off (None:
    on for CUDA chunks with stage-0 params). ``repcache``
    (serve/repcache.RepresentationCache): chunks whose non-base ingest
    levels are all cached skip pyramid materialization, and freshly
    pooled ingest levels are published for later queries and the
    serving path; row sets are the same either way."""

    def __init__(self, images, metadata: Mapping[str, np.ndarray]
                 | None = None, *, chunk: int = 64, repcache=None,
                 fused: bool = True, lazy: bool = True,
                 int8: bool = False, use_kernel: bool | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.images = _corpus(images, self.device)
        self.repcache = repcache
        if repcache is not None:
            from repro_torch.serve.repcache import corpus_token
            repcache.bind_corpus(corpus_token(self.images),
                                 self.images.device)
        self.n_rows = int(self.images.shape[0])
        self.metadata = dict(metadata or {})
        self.chunk = int(chunk)
        self.fused = bool(fused)
        self.lazy = bool(lazy)
        self.int8 = bool(int8)
        self.use_kernel = use_kernel
        self.store = VirtualColumnStore(self.n_rows)
        self._casc_fns: dict = {}
        self._ingest_fns: dict = {}

    def reset_cache(self) -> None:
        """Drop the virtual-column store (keeps the cascade closures)."""
        self.store = VirtualColumnStore(self.n_rows)

    def _gather(self, ids: np.ndarray) -> torch.Tensor:
        return self.images[torch.from_numpy(
            np.asarray(ids, np.int64)).to(self.device)]

    # ------------------------------------------------- flush programs --
    def _cascade_fn(self, casc: CompiledCascade, in_res: tuple,
                    out_res: tuple) -> Callable:
        """Flush program for one cascade: pyr ({res: rows} covering
        ``in_res``) -> (labels, {res: derived level for res in
        ``out_res``}). Levels the cascade reads that are NOT in ``in_res``
        are derived progressively (the plan_pyramid policy)."""
        key = (casc.key, tuple(in_res), tuple(out_res))
        if key not in self._casc_fns:
            caps = [self.chunk] * (len(casc.model_fns) - 1)
            steps: list[tuple[int, int]] = []
            avail = set(in_res)
            for r in sorted(set(casc.resolutions) - avail, reverse=True):
                steps.append((r, min(m for m in avail if m % r == 0)))
                avail.add(r)

            def run(pyr):
                cache = dict(pyr)
                for r, src in steps:
                    cache[r] = resize_area(cache[src], r)
                labels = run_cascade_on_pyramid(
                    cache, casc.model_fns, casc.thresholds, casc.reps,
                    caps)[0]
                return labels, {r: cache[r] for r in out_res}
            self._casc_fns[key] = run
        return self._casc_fns[key]

    def _ingest_fn(self, casc: CompiledCascade, out_res: tuple) -> Callable:
        """Fused chunk ingest (core/executor.make_fused_ingest): imgs ->
        (stage-0 labels, carried levels)."""
        key = (casc.key, tuple(out_res))
        if key not in self._ingest_fns:
            caps = [self.chunk] * (len(casc.model_fns) - 1)
            int8 = (self.int8 and casc.stage0 is not None
                    and casc.stage0.qparams is not None)
            use_kernel = self.use_kernel if casc.stage0 is not None \
                else False
            self._ingest_fns[key] = make_fused_ingest(
                casc.model_fns, casc.thresholds, casc.reps, caps,
                out_res, stage0=casc.stage0, use_kernel=use_kernel, int8=int8)
        return self._ingest_fns[key]

    # --------------------------------------------------------- execution --
    def metadata_mask(self, metadata_eq: Mapping | None) -> np.ndarray:
        mask = np.ones(self.n_rows, bool)
        for col, val in (metadata_eq or {}).items():
            mask &= np.asarray(self.metadata[col]) == val
        return mask

    def execute(self, cascades: Sequence[CompiledCascade],
                metadata_eq: Mapping | None = None, *,
                survivors: np.ndarray | None = None,
                monitor=None) -> ScanResult:
        """SELECT row ids WHERE metadata_eq AND every cascade labels 1,
        evaluating cascades in the given (planner's) order. ``monitor``
        (engine/planner.OnlineReorderer) enables mid-scan re-ordering;
        ``survivors`` restricts the scan to a pre-filtered row set."""
        ids_all = np.where(self.metadata_mask(metadata_eq))[0]
        if survivors is not None:
            ids_all = np.intersect1d(ids_all,
                                     np.asarray(survivors, np.int64))
        if not cascades:
            return ScanResult(ids_all, ScanStats())
        return self.scan_rows(cascades, ids_all, monitor=monitor)

    @torch.no_grad()
    def scan_rows(self, cascades: Sequence[CompiledCascade],
                  ids_all: np.ndarray, *,
                  store: VirtualColumnStore | None = None,
                  monitor=None) -> ScanResult:
        """Run the chunk/stage pipeline over exactly ``ids_all``
        (metadata-filtered row ids), reading and writing ``store``
        (default: this engine's store). With a ``monitor``, buffers are
        drained and the pipeline rebuilt when it proposes a cheaper
        order; row sets are identical either way."""
        store = self.store if store is None else store
        cascades = list(cascades)
        k = len(cascades)
        stats = ScanStats(stages=[StageStats(c.concept) for c in cascades])
        ids_all = np.asarray(ids_all, np.int64)
        if k == 0:
            return ScanResult(np.sort(ids_all), stats)

        dev = self.device
        base_hw = int(self.images.shape[1])
        needed, union_res = stage_needs(cascades, base_hw)
        stats.pyramid_levels = union_res
        ingest_set, carry, derive = level_schedule(cascades, base_hw,
                                                   self.lazy)
        buffers = [_StageBuffer(self.chunk, carry[s], dev) for s in range(k)]
        accepted: list[np.ndarray] = []

        def count_levels(res, n: int) -> None:
            for r in res:
                stats.level_rows[r] = stats.level_rows.get(r, 0) + n

        def route(stage: int, ids: np.ndarray, rows: dict) -> None:
            """Advance rows through cached labels; buffer the first
            stage that actually needs evaluation."""
            while len(ids):
                if stage == k:
                    accepted.append(ids)
                    return
                casc = cascades[stage]
                st = stats.stages[stage]
                st.rows_in += len(ids)
                cached = store.lookup(casc.key, ids)
                known = cached >= 0
                st.rows_cached += int(known.sum())
                unknown = ~known
                if unknown.any():
                    feed(stage, ids[unknown],
                         {r: _mask(v, unknown) for r, v in rows.items()
                          if r in buffers[stage].rows})
                keep = known & (cached == 1)
                ids = ids[keep]
                rows = {r: _mask(v, keep) for r, v in rows.items()}
                stage += 1

        def feed(stage: int, ids: np.ndarray, rows: dict) -> None:
            buf = buffers[stage]
            missing = [r for r in buf.rows if r not in rows]
            if missing:
                # cache-skip backfill: rows that hopped over earlier stages
                # on cached labels pool their carry levels from base
                rows = dict(rows)
                imgs = self._gather(ids)
                for r in missing:
                    rows[r] = resize_area(imgs, r)
                count_levels(missing, len(ids))
            pos = 0
            while pos < len(ids):
                take = min(buf.cap - buf.fill, len(ids) - pos)
                buf.ids[buf.fill:buf.fill + take] = ids[pos:pos + take]
                for r in buf.rows:
                    buf.rows[r][buf.fill:buf.fill + take] = \
                        rows[r][pos:pos + take]
                buf.fill += take
                pos += take
                if buf.fill == buf.cap:
                    flush(stage)

        def flush(stage: int) -> None:
            buf = buffers[stage]
            nv = buf.fill
            if nv == 0:
                return
            casc = cascades[stage]
            st = stats.stages[stage]
            bres = tuple(buf.rows)
            down_carry = tuple(r for r in bres
                               if stage + 1 < k and r in needed[stage + 1])
            out_dev = tuple(r for r in derive[stage]
                            if stage + 1 < k and r in needed[stage + 1])
            need_base = base_hw in casc.resolutions or bool(derive[stage])
            fn = self._cascade_fn(
                casc, bres + ((base_hw,) if need_base else ()), out_dev)
            # rows past ``fill`` are stale padding: per-row independence
            # keeps the valid rows' labels exact regardless
            pyr = dict(buf.rows)
            if need_base:
                pyr[base_hw] = self._gather(buf.ids)
            labels, dev_levels = fn(pyr)
            labels = labels[:nv].cpu().numpy()
            ids = buf.ids[:nv].copy()
            down = {r: buf.rows[r][:nv] for r in down_carry}
            for r in out_dev:
                down[r] = dev_levels[r][:nv]
            count_levels(derive[stage], nv)
            buf.fill = 0
            st.rows_evaluated += nv
            st.batches += 1
            store.record(casc.key, ids, labels)
            if monitor is not None:
                # only a first-position flush sees the unfiltered stream
                monitor.observe(casc.key, labels, marginal=stage == 0)
            keep = labels == 1
            # boolean-mask indexing copies, so the next fill of this
            # buffer cannot clobber the rows routed downstream
            route(stage + 1, ids[keep], {r: _mask(v, keep)
                                         for r, v in down.items()})

        def apply_order(perm: list) -> None:
            """Drain every buffer under the current order, then permute
            the per-stage structures and rebuild empty buffers."""
            nonlocal needed, ingest_set, carry, derive, small
            for s in range(k):
                flush(s)
            cascades[:] = [cascades[i] for i in perm]
            stats.stages[:] = [stats.stages[i] for i in perm]
            needed, _ = stage_needs(cascades, base_hw)
            ingest_set, carry, derive = level_schedule(
                cascades, base_hw, self.lazy)
            small = list(ingest_set)
            buffers[:] = [_StageBuffer(self.chunk, carry[s], dev)
                          for s in range(k)]
            stats.reorders += 1

        stats.rows_scanned = len(ids_all)
        small = list(ingest_set)
        for lo in range(0, len(ids_all), self.chunk):
            sel = ids_all[lo:lo + self.chunk]
            casc0 = cascades[0]
            cached0 = store.lookup(casc0.key, sel)
            unk = cached0 < 0
            n_unknown = int(unk.sum())
            cached = (self.repcache.lookup_rows(sel, small)
                      if self.repcache is not None and small else None)
            if cached is not None:
                # every ingest level of every chunk row is cached: skip
                # materialization; stage 0 evaluates through its buffer
                # like any later stage
                stats.rep_rows_cached += len(sel)
                route(0, sel, {r: v.to(dev) for r, v in cached.items()})
            elif n_unknown == 0:
                # stage-0 labels all known: no ingest work at all
                route(0, sel, {})
            else:
                # static-width pad (repeat the last row): per-row results
                # do not depend on the batch, and one width serves every
                # chunk
                idx = np.concatenate([sel, np.repeat(
                    sel[-1:], self.chunk - len(sel))])
                imgs = self._gather(idx)
                if self.fused:
                    # fused ingest: pyramid + the FULL first cascade; only
                    # unknown rows are recorded/counted. With a repcache
                    # every ingest level leaves the program (the cache
                    # sees complete chunks), otherwise only what later
                    # stages carry
                    out_res = (tuple(ingest_set)
                               if self.repcache is not None
                               else (carry[1] if k > 1 else ()))
                    labels, levels = self._ingest_fn(casc0, out_res)(imgs)
                    labels = labels[:len(sel)].cpu().numpy()
                    rows = {r: v[:len(sel)] for r, v in levels.items()}
                    stats.chunks += 1
                    count_levels(ingest_set, len(sel))
                    self._publish(sel, small, rows)
                    st = stats.stages[0]
                    st.rows_in += len(sel)
                    st.rows_cached += len(sel) - n_unknown
                    st.rows_evaluated += n_unknown
                    st.batches += 1
                    store.record(casc0.key, sel[unk], labels[unk])
                    if monitor is not None:
                        monitor.observe(casc0.key, labels[unk],
                                        marginal=True)
                    keep = np.where(unk, labels, cached0) == 1
                    route(1, sel[keep], {r: _mask(v, keep)
                                         for r, v in rows.items()})
                else:
                    # unfused ingest: one pyramid pass per chunk, stage 0
                    # through its buffer
                    levels = materialize_pyramid(imgs, ingest_set)
                    rows = {r: levels[r][:len(sel)] for r in ingest_set}
                    stats.chunks += 1
                    count_levels(ingest_set, len(sel))
                    self._publish(sel, small, rows)
                    route(0, sel, rows)
            if monitor is not None and k > 1:
                perm = monitor.propose(cascades)
                if perm is not None:
                    apply_order(perm)
        for s in range(k):                # drain partial buffers in order
            flush(s)

        if accepted:
            out = np.sort(np.concatenate(accepted))
        else:
            out = np.empty(0, np.int64)
        return ScanResult(out, stats)

    def _publish(self, ids: np.ndarray, small, rows: dict) -> None:
        """Hand a chunk's freshly pooled ingest levels to the repcache."""
        if self.repcache is not None:
            for r in small:
                if r in rows:
                    self.repcache.put_rows(ids, r, rows[r])


# ------------------------------------------------------- reference paths --
@torch.no_grad()
def naive_scan(images, cascades: Sequence[CompiledCascade],
               metadata: Mapping[str, np.ndarray] | None = None,
               metadata_eq: Mapping | None = None, *, chunk: int = 64,
               int8: bool = False, device=None,
               _fn_cache: dict | None = None) -> np.ndarray:
    """The seed workflow: each predicate's cascade runs a FULL corpus scan
    (its own pyramid per chunk, no sharing, no masking, no fused kernel);
    masks are ANDed at the end. The same row set as ScanEngine.execute
    for the same cascades. ``int8`` runs the FIRST cascade's level 0 on
    its dequantized int8 weights — the fused engine's ``int8=True``
    arithmetic, which quantizes only the stage-0 model its chunk ingest
    folds in. ``device`` defaults to the corpus tensor's device, else
    ``cuda``. ``_fn_cache`` (dict) lets callers that scan one cascade
    many times (engine/algebra.naive_tree_rows) reuse its per-chunk
    program."""
    from functools import partial

    from repro_torch.models.cnn import cnn_predict_proba, dequantize_cnn

    if device is None and torch.is_tensor(images):
        device = images.device
    dev = resolve_device(device)
    images = _corpus(images, dev)
    n = int(images.shape[0])
    mask = np.ones(n, bool)
    for col, val in (metadata_eq or {}).items():
        mask &= np.asarray(metadata[col]) == val

    cache = _fn_cache if _fn_cache is not None else {}
    for pos, casc in enumerate(cascades):
        q8 = (int8 and pos == 0 and casc.stage0 is not None
              and casc.stage0.qparams is not None)
        key = (casc.key, chunk, q8)
        if key not in cache:
            # full-width levels, matching ScanEngine (see CompiledCascade)
            caps = [chunk] * (len(casc.model_fns) - 1)
            fns = list(casc.model_fns)
            if q8:
                fns[0] = partial(cnn_predict_proba,
                                 dequantize_cnn(casc.stage0.qparams))

            def run(imgs, _c=casc, _fns=fns, _caps=caps):
                pyr = materialize_pyramid(imgs, _c.resolutions)
                return run_cascade_on_pyramid(pyr, _fns, _c.thresholds,
                                              _c.reps, _caps)[0]
            cache[key] = run
        fn = cache[key]
        col = np.zeros(n, np.int8)
        for lo in range(0, n, chunk):
            imgs = images[lo:lo + chunk]
            nv = imgs.shape[0]
            if nv < chunk:
                imgs = torch.cat([imgs, imgs[-1:].expand(
                    chunk - nv, *imgs.shape[1:])])
            col[lo:lo + nv] = fn(imgs)[:nv].cpu().numpy()
        mask &= col == 1
    return np.where(mask)[0]


def make_batch_runner(casc: CompiledCascade, batch_size: int, *,
                      device=None) -> Callable[[list], list]:
    """``run_batch`` callable for serve.Batcher / CascadeService: stacks
    request payloads (one image each) on ``device`` (default ``cuda``),
    runs the cascade and returns per-request int labels. Levels past the
    first run at ``casc.capacities`` (default: the full batch), the
    sync batcher's bounded-tail knob (see CompiledCascade). The batch
    goes through the scan engines' fused ingest
    (core/executor.make_fused_ingest): on a card, with stage-0 params,
    the pyramid and level 0 are one ``fused_pyramid_stage0`` launch."""
    dev = resolve_device(device)
    caps = (list(casc.capacities) if casc.capacities is not None
            else [batch_size] * (len(casc.model_fns) - 1))
    fn = make_fused_ingest(casc.model_fns, casc.thresholds, casc.reps, caps,
                           (), stage0=casc.stage0)

    @torch.no_grad()
    def run_batch(payloads: list) -> list:
        imgs = torch.stack([torch.as_tensor(p, dtype=torch.float32,
                                            device=dev) for p in payloads])
        return [int(v) for v in fn(imgs)[0].cpu().tolist()]
    return run_batch
