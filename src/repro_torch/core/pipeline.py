"""TAHOMA system assembly (paper Fig. 2) on a torch device: model bank ->
cost profiler -> cascade builder -> cascade evaluator, per binary
predicate.

The training half of the reference's ``initialize_system`` (grid training
with AdamW) is not part of this package yet; ``system_from_bank`` is its
tail — score matrix on the config split, Algorithm-1 thresholds, measured
inference costs, modeled cost profile, eval-split scores — over a bank
whose weights come from elsewhere (``models/cnn.params_from_jax`` or
``init_cnn``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import TahomaCNNConfig
from repro_torch.core import thresholds as thr_mod
from repro_torch.core.cascade import (CascadeSpace, evaluate_cascades,
                                      evaluate_cascades_streaming)
from repro_torch.core.costs import CostProfile
from repro_torch.core.transforms import (Representation, apply_transform,
                                         materialize_representations)
from repro_torch.device import resolve_device, tensor_device
from repro_torch.models.cnn import cnn_predict_proba


def _as_images(raw, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(raw, np.float32) if not
                           torch.is_tensor(raw) else raw,
                           dtype=torch.float32, device=device)


@dataclass
class ModelEntry:
    name: str
    arch: TahomaCNNConfig
    rep: Representation
    params: object              # models/cnn parameter dict (torch tensors)
    trusted: bool = False

    def predict(self, raw_images) -> np.ndarray:
        x = apply_transform(_as_images(raw_images,
                                       tensor_device(self.params)), self.rep)
        return cnn_predict_proba(self.params, x).cpu().numpy()


@dataclass
class ModelBank:
    """The A x F model grid (+ the trusted model) on one device. Every
    entry's parameters must lie on ``device`` (default ``cuda``)."""
    entries: list[ModelEntry] = field(default_factory=list)
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for e in self.entries:
            dev = tensor_device(e.params)
            if dev is not None and dev.type != self.device.type:
                raise ValueError(f"{e.name}: params on {dev}, bank on "
                                 f"{self.device}")

    @property
    def names(self):
        return [e.name for e in self.entries]

    @property
    def reps(self):
        return [e.rep for e in self.entries]

    @property
    def trusted_index(self) -> int:
        return next(i for i, e in enumerate(self.entries) if e.trusted)

    @torch.no_grad()
    def score_matrix(self, raw_images, batch: int = 256) -> np.ndarray:
        """(M, I): inference once per model (paper §V-D). All
        representations the bank needs are materialized in ONE progressive
        pyramid pass per batch of ``batch`` images."""
        raw = _as_images(raw_images, "cpu")
        out = np.empty((len(self.entries), len(raw)), np.float32)
        for lo in range(0, len(raw), batch):
            imgs = raw[lo:lo + batch].to(self.device)
            reps = materialize_representations(imgs, self.reps)
            for m, e in enumerate(self.entries):
                out[m, lo:lo + len(imgs)] = cnn_predict_proba(
                    e.params, reps[e.rep]).cpu().numpy()
        return out


# -------------------------------------------------------------- profiling --
@torch.no_grad()
def profile_infer_costs(bank: ModelBank, sample_raw, *, batch: int = 32,
                        repeats: int = 3) -> dict[str, float]:
    """Measured seconds/image of pure inference on the bank's device (the
    cost profiler of Fig. 2): the best of ``repeats`` timed calls after
    one warm-up, with CUDA events on a card and the host clock on the
    CPU."""
    imgs = _as_images(np.asarray(sample_raw)[:batch], bank.device)
    cuda = bank.device.type == "cuda"
    out = {}
    for e in bank.entries:
        x = apply_transform(imgs, e.rep).contiguous()
        cnn_predict_proba(e.params, x)
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                cnn_predict_proba(e.params, x)
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                cnn_predict_proba(e.params, x)
                dt = time.perf_counter() - t0
            best = min(best, dt)
        out[e.name] = best / len(x)
    return out


# ---------------------------------------------------------- full pipeline --
@dataclass
class TahomaSystem:
    bank: ModelBank
    p_low: np.ndarray
    p_high: np.ndarray
    infer_s: dict[str, float]
    profile: CostProfile
    eval_scores: np.ndarray
    eval_truth: np.ndarray
    targets: tuple
    space_cache: dict = field(default_factory=dict)
    dec_cache: dict = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.bank.device

    def cascade_space(self, scenario: str, *, max_level: int = 3,
                      reps_subset=None, streaming: bool = False,
                      **stream_kw) -> CascadeSpace:
        """Re-cost + re-evaluate all cascades under a deployment scenario
        (pure linear algebra over cached scores — §V-E). streaming=True
        runs the bounded-memory chunked evaluator on the bank's device
        (the hand-written matmul kernel on a card) and returns only the
        surviving (Pareto/top-K) cascades; extra kwargs pass through.
        Plain evaluations are memoized per (scenario, max_level,
        streaming)."""
        plain = reps_subset is None and not stream_kw
        key = (scenario, max_level, streaming)
        if plain and key in self.space_cache:
            return self.space_cache[key]
        keep = None
        if reps_subset is not None:
            keep = [i for i, e in enumerate(self.bank.entries)
                    if e.rep in reps_subset or e.trusted]
        infer = np.array([self.infer_s[n] for n in self.bank.names])
        if streaming:
            stream_kw.setdefault("device", self.device)
            evaluate = evaluate_cascades_streaming
        else:
            evaluate = evaluate_cascades
        space = evaluate(
            self.eval_scores, self.eval_truth, self.p_low, self.p_high,
            self.bank.reps, infer, self.profile, scenario,
            self.bank.trusted_index, max_level=max_level,
            first_level_models=keep, **stream_kw)
        if plain:
            self.space_cache[key] = space
        return space

    def decomposed_cost(self, space: CascadeSpace, index: int,
                        scenario: str, *, dense_levels: bool = False):
        """Cascade ``index``'s §VI cost split into inference vs
        per-pyramid-level representation handling (core/costs
        .DecomposedCost), memoized per (scenario, mode, physical
        cascade)."""
        from repro_torch.core.cascade import spec_levels
        from repro_torch.core.costs import decompose_cascade_cost

        key = (scenario, bool(dense_levels), int(space.kind[index]),
               int(space.i1[index]), int(space.i2[index]))
        if key not in self.dec_cache:
            infer = np.array([self.infer_s[n] for n in self.bank.names])
            self.dec_cache[key] = decompose_cascade_cost(
                spec_levels(space, index, self.p_low, self.p_high),
                self.eval_scores, self.bank.reps, infer, self.profile,
                scenario, dense_levels=dense_levels)
        return self.dec_cache[key]

    def compiled_cascade(self, space: CascadeSpace, index: int, *,
                         concept: str = "pred", capacities=None):
        """Decode cascade ``index`` of an evaluated space into an
        executable engine.scan.CompiledCascade: per-level model closures
        over this bank's params, thresholds, representations, the
        planner's cost and selectivity estimates, and the level-0 model in
        kernel-foldable form (executor.Stage0, with an int8-quantized
        copy) for the fused pyramid+stage-0 ingest."""
        from functools import partial

        from repro_torch.core.cascade import spec_levels
        from repro_torch.core.executor import Stage0
        from repro_torch.core.selector import estimate_selectivity
        from repro_torch.engine.scan import CompiledCascade
        from repro_torch.models.cnn import quantize_cnn

        levels = spec_levels(space, index, self.p_low, self.p_high)
        reps, fns, ths = [], [], []
        for m, lo, hi in levels:
            e = self.bank.entries[m]
            reps.append(e.rep)
            fns.append(partial(cnn_predict_proba, e.params))
            ths.append((None if lo is None else float(lo),
                        None if hi is None else float(hi)))
        sel = estimate_selectivity(space, index, self.eval_scores,
                                   self.p_low, self.p_high)
        cascade_id = (int(space.kind[index]), int(space.i1[index]),
                      int(space.i2[index]))
        e0 = self.bank.entries[levels[0][0]]
        stage0 = Stage0(params=e0.params, rep=e0.rep,
                        qparams=quantize_cnn(e0.params))
        return CompiledCascade(
            concept=concept, cascade_id=cascade_id, reps=reps,
            model_fns=fns, thresholds=ths,
            cost_s=float(space.time_s[index]), selectivity=sel,
            capacities=capacities, stage0=stage0)


def system_from_bank(bank: ModelBank, config_split, eval_split, *,
                     targets: Sequence[float] = thr_mod.PRECISION_TARGETS,
                     infer_s: dict[str, float] | None = None
                     ) -> TahomaSystem:
    """The reference ``initialize_system`` after training: config-split
    scores -> Algorithm-1 thresholds per precision target, measured
    per-model inference costs (``infer_s`` pins them instead, e.g. to the
    reference's measurements), the modeled cost profile, and the cached
    eval-split score matrix."""
    (cf_x, cf_y), (ev_x, ev_y) = config_split, eval_split
    cfg_scores = bank.score_matrix(cf_x)
    p_low, p_high = thr_mod.compute_thresholds_batch(cfg_scores, cf_y,
                                                     targets)
    if infer_s is None:
        infer_s = profile_infer_costs(bank, ev_x)
    profile = CostProfile.modeled(infer_s, list(set(bank.reps)),
                                  base_hw=int(np.shape(cf_x)[1]))
    eval_scores = bank.score_matrix(ev_x)
    return TahomaSystem(bank, p_low, p_high, dict(infer_s), profile,
                        eval_scores, np.asarray(ev_y), tuple(targets))


def build_scan_engine(images, metadata=None, *, shards: int | None = None,
                      chunk: int = 64, repcache=None, fused: bool = True,
                      lazy: bool = True, int8: bool = False,
                      use_kernel: bool | None = None, device=None):
    """System-level scan-executor factory: the single-device ScanEngine
    (``fused``/``lazy``/``int8``/``use_kernel`` are the hot-path knobs).
    The sharded engine and the cross-query representation cache are not
    part of this package yet."""
    from repro_torch.engine.scan import ScanEngine

    if shards:
        raise NotImplementedError(
            "build_scan_engine(shards=...): the sharded scan engine is "
            "ported in a later slice (engine/sharded)")
    return ScanEngine(images, metadata, chunk=chunk, repcache=repcache,
                      fused=fused, lazy=lazy, int8=int8,
                      use_kernel=use_kernel, device=device)
