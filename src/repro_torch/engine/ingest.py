"""Streaming ingest-time indexing (DESIGN.md §14) on a torch device.

As frames arrive from a camera, an ``IngestPipeline`` consumes them
chunk-by-chunk and runs two cheap passes whose output — a
``CandidateIndex`` — the query planner consults as a metadata-like
pre-filter:

* a **temporal-difference skip detector** on the host: consecutive
  frames whose downsampled grayscale signatures differ by less than a
  threshold are near-duplicates; each is ALIASED to the last distinct
  (reference) frame and never scored. 'approx' mode lets aliased rows
  inherit the reference's candidates and decided labels; 'exact' mode
  never trusts an alias;
* an **ingest-time candidate-concept index**: the reference frames of a
  chunk are copied to the device, padded to the chunk's static width,
  and run ONE stage-0 rung per planned concept. The anchor concept's
  rung goes through core/executor.make_fused_ingest(emit_scores=True) —
  on a card with stage-0 params, the hand-written pyramid + stage-0
  kernel — and emits the pooled levels the other concepts' stage-0
  heads read, so the chunk's pyramid is materialized once. The scores
  give **exact decided labels** (s0 <= p_low or s0 >= p_high, the
  cascade's own thresholds: the query-time cascade stops at stage 0
  with the same label when it computes the same score) recorded in a
  ``VirtualColumnStore``, and **approximate candidates** (score past a
  recall-knob threshold, optionally capped to the ``top_k`` best
  margins) that prune in 'approx' mode only.

Which scores are "the same": a row's stage-0 score depends on the width
of the launch it ran in (the kernel's dense pass splits K by the batch
width) and on the route (the kernel, or ``models/cnn`` through
``F.conv2d``). Build the pipeline with the scan engine's chunk so both
pad to one width; where a concept's ingest route differs from its
query-time route, scores differ within f32 tolerance and a row whose
two scores straddle a threshold can take another label. On the CPU
both routes are the plain versions and the labels are identical.

``plan_query(..., index=...)`` attaches the index to the
``PhysicalPlan``; ``indexed_execute`` seeds an engine's store from it,
pre-filters the survivors and scans what remains. Build the index from
the SAME physical cascades the plan selects (labels are keyed by
``CompiledCascade.key``): plan first, then ingest with
``plan.cascades``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.executor import make_fused_ingest
from repro_torch.core.transforms import color_transform
from repro_torch.device import resolve_device
from repro_torch.engine.scan import CompiledCascade, VirtualColumnStore


# ------------------------------------------------------ skip detector ----
def frame_signature(frames: np.ndarray, res: int = 8) -> np.ndarray:
    """Downsampled grayscale detector signature (B, res, res): channel
    mean then box-mean pooling — pure host numpy, a few hundred bytes
    per frame, the cheap difference feature NoScope's detectors use."""
    frames = np.asarray(frames, np.float32)
    b, hw = frames.shape[0], frames.shape[1]
    res = min(res, hw)
    k = hw // res
    gray = frames[:, : res * k, : res * k].mean(axis=3)
    return gray.reshape(b, res, k, res, k).mean(axis=(2, 4))


@dataclass
class IngestStats:
    frames: int = 0            # frames consumed
    chunks: int = 0            # fused scoring dispatches issued
    refs: int = 0              # distinct (reference) frames scored
    skipped: int = 0           # near-duplicate frames aliased, not scored
    decided_labels: int = 0    # exact stage-0 decisions recorded
    stage0_scores: int = 0     # stage-0 scores computed (refs x concepts)


class CandidateIndex:
    """The ingest pipeline's output: per-row skip-aliases, per-concept
    candidate masks, and a ``VirtualColumnStore`` of exact stage-0
    decided labels (host numpy, row-indexed against one corpus).
    ``save``/``load`` persist it as an npz with the same corpus-token
    guard as the store."""

    def __init__(self, n_rows: int, cascades: Sequence[CompiledCascade],
                 *, top_k: int | None = None, prune_margin: float = 0.25):
        self.n_rows = int(n_rows)
        self.concepts = [c.concept for c in cascades]
        self.cascade_keys = {c.concept: c.key for c in cascades}
        self.top_k = top_k
        self.prune_margin = float(prune_margin)
        self.alias = np.arange(self.n_rows, dtype=np.int64)
        self.indexed = np.zeros(self.n_rows, bool)
        self.candidates = {c: np.zeros(self.n_rows, bool)
                           for c in self.concepts}
        self.scores = {c: np.full(self.n_rows, np.nan, np.float32)
                       for c in self.concepts}
        self.decided = VirtualColumnStore(self.n_rows)

    # ------------------------------------------------------- queries ----
    def survivors(self, ids: np.ndarray,
                  cascades: Sequence[CompiledCascade], *,
                  exact: bool = True) -> np.ndarray:
        """The metadata-like pre-filter: of ``ids``, the rows a scan for
        the AND of ``cascades`` must still consider. Always drops rows
        with an exact own-pixel decided-0 label (the seeded engine would
        reject them from cache — pruning them is a pure work skip, row
        sets unchanged). 'approx' additionally drops rows whose
        skip-alias reference is decided 0 or whose alias-resolved
        candidate set excludes a planned concept (unless decided 1)."""
        ids = np.asarray(ids, np.int64)
        keep = np.ones(len(ids), bool)
        ref = self.alias[ids]
        idx = self.indexed[ids]
        for casc in cascades:
            col = self.decided.column(casc.key)
            keep &= col[ids] != 0
            if exact:
                continue
            ali = col[ref]
            keep &= ~(idx & (ali == 0))
            cand = self.candidates.get(casc.concept)
            if cand is not None:
                keep &= ~(idx & ~cand[ref] & (ali != 1))
        return ids[keep]

    def planning_stats(self, key: tuple, base_sel: float, *,
                       prefilter: bool = True) -> tuple[float, float]:
        """Index-conditioned planning statistics for ONE cascade
        (DESIGN.md §14.5): ``(eval_frac, selectivity)`` where
        ``eval_frac`` is the fraction of candidate rows whose label the
        seeded store does NOT already hold, and ``selectivity`` is
        P(label == 1) over the rows the scan will consider, combining
        the index's exact decided counts with ``base_sel`` on the
        undecided remainder. ``prefilter=True`` conditions both on the
        exact-mode survivor set (the conjunctive planner's path);
        ``prefilter=False`` keeps every row in the denominator (the
        algebra executor only SEEDS the store: pruning decided-0 rows is
        unsound under OR/NOT). A ``key`` the index never built returns
        ``(1.0, base_sel)`` unchanged."""
        if self.n_rows == 0 or key not in set(self.decided.keys()):
            return 1.0, float(base_sel)
        col = self.decided.column(key)
        n0 = int((col == 0).sum())
        n1 = int((col == 1).sum())
        und = self.n_rows - n0 - n1
        denom = (self.n_rows - n0) if prefilter else self.n_rows
        if denom <= 0:
            return 0.0, 0.0
        sel = (n1 + und * float(base_sel)) / denom
        return und / denom, float(min(max(sel, 0.0), 1.0))

    def seed_store(self, store: VirtualColumnStore, *,
                   exact: bool = True) -> int:
        """Seed an engine's ``VirtualColumnStore`` from ingest-time
        decisions with merge semantics (a computed label is never
        overwritten). Exact mode copies only own-pixel decided labels;
        approx mode additionally propagates a reference frame's labels
        to its skip-aliases (the NoScope approximation). Returns labels
        seeded."""
        n = 0
        for key in self.decided.keys():
            src = self.decided.column(key)
            dst = store.column(key)
            lab = src if exact else np.where(self.indexed,
                                             src[self.alias], src)
            fill = (dst < 0) & (lab >= 0)
            dst[fill] = lab[fill]
            n += int(fill.sum())
        return n

    def measured_recall(self, concept: str, truth: np.ndarray,
                        ids: np.ndarray | None = None) -> float:
        """The recall knob's measured cost on labeled rows: of the
        indexed rows whose ground-truth ``concept`` label is 1, the
        fraction the 'approx' pre-filter keeps (candidate, decided 1,
        or alias thereof). 1.0 means pruning loses nothing on this
        data."""
        ids = (np.arange(self.n_rows, dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64))
        ids = ids[self.indexed[ids]]
        truth = np.asarray(truth)
        pos = ids[truth[ids] == 1]
        if not len(pos):
            return 1.0
        ref = self.alias[pos]
        col = self.decided.column(self.cascade_keys[concept])
        kept = (self.candidates[concept][ref] | (col[ref] == 1)) \
            & (col[ref] != 0) & (col[pos] != 0)
        return float(kept.mean())

    def describe(self, cascades: Sequence[CompiledCascade], *,
                 exact: bool = True) -> str:
        """One EXPLAIN line (PhysicalPlan.explain renders it)."""
        n_idx = int(self.indexed.sum())
        n_alias = int((self.alias != np.arange(self.n_rows))
                      [self.indexed].sum())
        ids = np.arange(self.n_rows, dtype=np.int64)
        surv = len(self.survivors(ids, cascades, exact=exact))
        mode = "exact" if exact else (
            f"approx, top_k={self.top_k}, margin={self.prune_margin:g}")
        frac = surv / self.n_rows if self.n_rows else 1.0
        return (f"{n_idx}/{self.n_rows} rows indexed, {n_alias} "
                f"skip-aliased; prefilter keeps {surv} ({frac:.0%}) "
                f"[{mode}]")

    # --------------------------------------------------- persistence ----
    def save(self, path, token: tuple = ()) -> None:
        """Persist as npz with the corpus-token guard (see
        VirtualColumnStore.save): an ingest-built index loaded against
        a different corpus would alias and prune the wrong rows."""
        data = {"n_rows": np.int64(self.n_rows),
                "token": np.asarray(token, np.float64),
                "top_k": np.int64(-1 if self.top_k is None else self.top_k),
                "prune_margin": np.float64(self.prune_margin),
                "alias": self.alias, "indexed": self.indexed,
                "concepts": np.array(self.concepts),
                "concept_keys": np.array(
                    [repr(self.cascade_keys[c]) for c in self.concepts]),
                "dec_keys": np.array([repr(k)
                                      for k in self.decided.keys()])}
        for c in self.concepts:
            data[f"cand_{c}"] = self.candidates[c]
            data[f"score_{c}"] = self.scores[c]
        for i, k in enumerate(self.decided.keys()):
            data[f"dec_{i}"] = self.decided.column(k)
        np.savez(path, **data)

    @classmethod
    def load(cls, path, token: tuple = ()) -> "CandidateIndex":
        import ast
        with np.load(path, allow_pickle=False) as z:
            if not np.array_equal(z["token"],
                                  np.asarray(token, np.float64)):
                raise ValueError(
                    "CandidateIndex snapshot was saved for a different "
                    "corpus — row-indexed aliases/candidates would "
                    "misattribute rows; refusing to load")
            out = cls.__new__(cls)
            out.n_rows = int(z["n_rows"])
            out.concepts = [str(c) for c in z["concepts"]]
            out.cascade_keys = {
                c: ast.literal_eval(str(k))
                for c, k in zip(out.concepts, z["concept_keys"])}
            tk = int(z["top_k"])
            out.top_k = None if tk < 0 else tk
            out.prune_margin = float(z["prune_margin"])
            out.alias = z["alias"].astype(np.int64)
            out.indexed = z["indexed"].astype(bool)
            out.candidates = {c: z[f"cand_{c}"].astype(bool)
                              for c in out.concepts}
            out.scores = {c: z[f"score_{c}"].astype(np.float32)
                          for c in out.concepts}
            out.decided = VirtualColumnStore(out.n_rows)
            for i, k in enumerate(z["dec_keys"]):
                out.decided._cols[ast.literal_eval(str(k))] = \
                    z[f"dec_{i}"].astype(np.int8)
        return out


class IngestPipeline:
    """Streaming chunk-by-chunk frame consumer building a
    ``CandidateIndex`` (module docstring). Construct with the planned
    cascades and the corpus capacity, then feed arriving host frames
    with ``ingest(frames, ids)`` (global row ids; chunks split
    internally) or sweep a resident corpus with ``run(images)``.
    Stateful across calls: the skip detector chains through the previous
    call's last frame, so a camera stream can be fed in any batch
    granularity. Reference frames are scored on ``device`` (default
    ``cuda``)."""

    def __init__(self, cascades: Sequence[CompiledCascade], n_rows: int,
                 *, chunk: int = 64, skip: bool = True,
                 skip_threshold: float | None = 0.008, skip_res: int = 8,
                 calib_frames: int = 48,
                 top_k: int | None = None, prune_margin: float = 0.25,
                 use_kernel: bool | None = None, int8: bool = False,
                 device=None):
        if not cascades:
            raise ValueError("need at least one cascade to index")
        self.cascades = list(cascades)
        self.chunk = int(chunk)
        self.skip = bool(skip)
        # skip_threshold=None LEARNS the per-camera threshold from the
        # first ``calib_frames`` consecutive-frame signature diffs (the
        # warmup window) instead of trusting the pinned default; no
        # frame is skipped until calibration completes, so warmup is
        # conservative (every frame a scored reference), never lossy.
        self.skip_threshold = (None if skip_threshold is None
                               else float(skip_threshold))
        self.calib_frames = int(calib_frames)
        self._calib_diffs: list[float] = []
        self.skip_res = int(skip_res)
        self.use_kernel = use_kernel
        self.int8 = bool(int8)
        self.device = resolve_device(device)
        self.index = CandidateIndex(n_rows, cascades, top_k=top_k,
                                    prune_margin=prune_margin)
        self.stats = IngestStats()
        self._prev_sig: np.ndarray | None = None
        self._prev_ref: int | None = None
        self._anchor_fn: Callable | None = None
        self._head_fns: list = []

    # ------------------------------------------------- scoring rungs ----
    def _build(self) -> None:
        """One cheap stage-0 rung per concept, pyramid shared: the
        ANCHOR concept's rung is a truncated (level-0-only) cascade
        through core/executor.make_fused_ingest(emit_scores=True) — the
        pyramid + stage-0 kernel on a card — emitting the pooled levels
        the OTHER concepts' stage-0 heads read, so per scored chunk the
        pyramid is materialized exactly once."""
        c0 = self.cascades[0]
        head_res = [c.reps[0].resolution for c in self.cascades[1:]]
        out_res = tuple(sorted(set(head_res), reverse=True))
        int8 = (self.int8 and c0.stage0 is not None
                and c0.stage0.qparams is not None)
        use_kernel = self.use_kernel if c0.stage0 is not None else False
        self._anchor_fn = make_fused_ingest(
            c0.model_fns[:1], [c0.thresholds[0]], c0.reps[:1], [],
            out_res, stage0=c0.stage0, use_kernel=use_kernel,
            int8=int8, emit_scores=True)
        self._head_fns = []
        for c in self.cascades[1:]:
            def head(level, _fn=c.model_fns[0], _rep=c.reps[0]):
                return _fn(color_transform(level, _rep.color))
            self._head_fns.append(head)

    @torch.no_grad()
    def _score_refs(self, frames: np.ndarray) -> np.ndarray:
        """Stage-0 scores (n_ref, n_concepts) for a batch of reference
        frames, padded on the host to the static chunk width and copied
        to the device in one transfer."""
        nv = len(frames)
        if self._anchor_fn is None:
            self._build()
        if nv < self.chunk:
            pad = np.repeat(frames[-1:], self.chunk - nv, axis=0)
            frames = np.concatenate([frames, pad])
        imgs = torch.from_numpy(np.ascontiguousarray(frames)).to(
            self.device)
        _, levels, s0 = self._anchor_fn(imgs)
        cols = [s0[:nv]]
        for c, fn in zip(self.cascades[1:], self._head_fns):
            cols.append(fn(levels[c.reps[0].resolution])[:nv])
        self.stats.chunks += 1
        self.stats.stage0_scores += nv * len(self.cascades)
        return torch.stack(cols, dim=1).cpu().numpy()

    # ----------------------------------------------------- streaming ----
    def ingest(self, frames: np.ndarray, ids: np.ndarray) -> None:
        """Consume arriving frames (global row ``ids``): detect skips,
        score reference frames, record candidates + exact decided
        labels into the index."""
        frames = np.asarray(frames, np.float32)
        ids = np.asarray(ids, np.int64)
        idx = self.index
        for lo in range(0, len(ids), self.chunk):
            blk = frames[lo:lo + self.chunk]
            bids = ids[lo:lo + self.chunk]
            self.stats.frames += len(bids)
            idx.indexed[bids] = True
            sigs = frame_signature(blk, self.skip_res)
            ref_rows: list[int] = []
            for i, rid in enumerate(bids):
                diff = (float(np.abs(sigs[i] - self._prev_sig).mean())
                        if self._prev_sig is not None else None)
                if diff is not None and self.skip_threshold is None:
                    self._calib_diffs.append(diff)
                    if len(self._calib_diffs) >= self.calib_frames:
                        self.skip_threshold = self.calibrate_threshold(
                            self._calib_diffs)
                dup = (self.skip and diff is not None
                       and self._prev_ref is not None
                       and self.skip_threshold is not None
                       and diff <= self.skip_threshold)
                if dup:
                    idx.alias[rid] = self._prev_ref
                    self.stats.skipped += 1
                else:
                    idx.alias[rid] = rid
                    self._prev_ref = int(rid)
                    ref_rows.append(i)
                self._prev_sig = sigs[i]
            if not ref_rows:
                continue
            ref_rows = np.asarray(ref_rows, np.int64)
            rids = bids[ref_rows]
            scores = self._score_refs(blk[ref_rows])
            self.stats.refs += len(rids)
            margins = np.empty_like(scores)
            for k, casc in enumerate(self.cascades):
                s0 = scores[:, k]
                idx.scores[casc.concept][rids] = s0
                lab, decided, margin = self._grade(casc, s0)
                if decided.any():
                    idx.decided.record(casc.key, rids[decided],
                                       lab[decided])
                    self.stats.decided_labels += int(decided.sum())
                margins[:, k] = margin
            cand = margins > 0.0
            if idx.top_k is not None and idx.top_k < len(self.cascades):
                # Focus-style cap: keep only the top_k best margins
                order = np.argsort(-margins, axis=1, kind="stable")
                capped = np.zeros_like(cand)
                np.put_along_axis(capped, order[:, : idx.top_k], True,
                                  axis=1)
                cand &= capped
            for k, casc in enumerate(self.cascades):
                # decided-1 frames are always candidates; decided-0 never
                col = idx.decided.column(casc.key)[rids]
                idx.candidates[casc.concept][rids] = \
                    (cand[:, k] | (col == 1)) & (col != 0)

    @staticmethod
    def calibrate_threshold(diffs, *, min_ratio: float = 4.0,
                            fallback: float = 0.008) -> float:
        """Per-camera skip threshold from a warmup window of
        consecutive-frame signature diffs (NoScope-style difference-
        detector calibration). Within-scene sensor jitter sits orders of
        magnitude below scene-change diffs: sort the diffs and split at
        the largest MULTIPLICATIVE gap between neighbors; the threshold
        is the geometric mean of the gap's endpoints. Falls back to the
        pinned default on too few samples or no gap of ``min_ratio``
        (a static camera: nothing but jitter in the window)."""
        d = np.sort(np.asarray([x for x in diffs if x > 0.0], np.float64))
        if len(d) < 8:
            return float(fallback)
        ratios = d[1:] / d[:-1]
        k = int(np.argmax(ratios))
        if ratios[k] < min_ratio:
            return float(fallback)
        return float(np.sqrt(d[k] * d[k + 1]))

    def _grade(self, casc: CompiledCascade, s0: np.ndarray):
        """(labels, exact-decided mask, candidate margin) for one
        concept's stage-0 scores. Decisions use the cascade's OWN
        thresholds, compared in f32 as the cascade loop compares them.
        The candidate margin shifts p_low toward the undecided band by
        ``prune_margin`` (the recall knob): margin <= 0 marks a
        non-candidate."""
        lo, hi = casc.thresholds[0]
        if lo is None:               # single-level cascade: stage 0 final
            lab = (s0 >= 0.5).astype(np.int8)
            return lab, np.ones(len(s0), bool), s0 - 0.5
        decided = (s0 <= np.float32(lo)) | (s0 >= np.float32(hi))
        lab = (s0 >= np.float32(hi)).astype(np.int8)
        tau = lo + self.index.prune_margin * max(0.5 - lo, 0.0)
        return lab, decided, s0 - tau

    def run(self, images: np.ndarray,
            ids: np.ndarray | None = None) -> CandidateIndex:
        """Sweep a resident corpus (or a contiguous stream slice)
        through ``ingest`` in chunk steps; returns the index."""
        images = np.asarray(images, np.float32)
        if ids is None:
            ids = np.arange(len(images), dtype=np.int64)
        self.ingest(images, ids)
        return self.index


# ------------------------------------------------------ orchestration ----
def indexed_execute(engine, plan, *, monitor=None):
    """Execute a ``PhysicalPlan`` carrying an ingest index against a
    scan engine: seed the engine's store from the index (exact-only
    labels in 'exact' mode, alias-propagated in 'approx'), pre-filter
    the metadata survivors through the index, and scan only what
    remains. Returns the engine's ScanResult."""
    exact = plan.index_mode == "exact"
    if plan.index is not None:
        plan.index.seed_store(engine.store, exact=exact)
        surv = plan.index_prefilter(
            np.where(engine.metadata_mask(plan.metadata_eq))[0])
    else:
        surv = None
    return engine.execute(plan.cascades, plan.metadata_eq,
                          survivors=surv, monitor=monitor)
