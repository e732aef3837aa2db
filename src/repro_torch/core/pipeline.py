"""TAHOMA system initialization (paper Fig. 2) on a torch device: model
trainer -> cost profiler -> cascade builder -> cascade evaluator, per
binary predicate.

``initialize_system`` trains the A x F model grid plus the trusted model
(``train_model_grid``: BCE + AdamW with the reference's seeds, steps,
batch and index stream, through autograd and ``F.conv2d``), then
``system_from_bank`` takes the config-split scores to Algorithm-1
thresholds, profiles inference costs (or takes pinned ones) and caches
the eval-split score matrix. ``system_from_bank`` also accepts a bank
whose weights come from elsewhere (``models/cnn.params_from_jax``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Sequence

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
from repro_torch.models.cnn import bce_loss, cnn_predict_proba, init_cnn
from repro_torch.train.optimizer import (adamw_step_, bias_correction,
                                         clip_by_global_norm, tree_leaves,
                                         tree_unflatten)


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


# ------------------------------------------------------------- training ----
@contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (weight
    gradients without atomics), the caller's setting after it."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _training_step(params, x, y, *, steps: int, batch: int, lr: float,
                   seed: int, device):
    """``fit_cnn``'s state and its step: -> (leaves, reset, step), where
    ``step()`` runs the next training step in place on ``leaves`` (the
    params, f32, in ``tree_leaves`` order) and ``reset()`` puts params,
    moments and the step counter back to the start. The index stream and
    the f32 bias corrections of every step are made on the host first; a
    step reads its batch and corrections from them by a step counter on
    the device, so no step waits for the host and one captured step
    replays as any other."""
    x = _as_images(x, device)
    y = torch.as_tensor(np.asarray(y) if not torch.is_tensor(y) else y,
                        dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(np.array(
        [rng.integers(0, len(x), size=batch) for _ in range(steps)],
        np.int64).reshape(steps, batch), device=device)
    b1, b2 = 0.9, 0.95                    # adamw's defaults
    c1, c2 = (torch.tensor([bias_correction(b, k) for k in
                            range(1, steps + 1)], dtype=torch.float32,
                           device=device) for b in (b1, b2))
    init = [p.detach().to(device, torch.float32)
            for p in tree_leaves(params)]
    leaves = [p.clone().requires_grad_() for p in init]
    m = [torch.zeros_like(p) for p in init]
    v = [torch.zeros_like(p) for p in init]
    t = torch.zeros(1, dtype=torch.long, device=device)

    def step():
        i = idx.index_select(0, t).view(-1)
        with torch.enable_grad():
            loss = bce_loss(tree_unflatten(params, leaves),
                            x.index_select(0, i), y.index_select(0, i))
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            grads, _ = clip_by_global_norm(list(grads), 1.0)
            adamw_step_(leaves, grads, m, v,
                        c1=c1.index_select(0, t).view(()),
                        c2=c2.index_select(0, t).view(()), lr=lr, b1=b1,
                        b2=b2, weight_decay=1e-4)
            t.add_(1)

    @torch.no_grad()
    def reset():
        torch._foreach_copy_(leaves, init)
        torch._foreach_zero_(m + v)
        t.zero_()

    return leaves, reset, step


def fit_cnn(params, x, y, *, steps: int = 120, batch: int = 16,
            lr: float = 3e-3, seed: int = 0, device=None) -> dict:
    """The reference ``train_cnn`` loop from the initial weights
    ``params``: AdamW(lr, weight_decay=1e-4, global-norm clip 1.0) on
    ``bce_loss``, one batch of ``np.random.default_rng(seed).integers(0,
    n, batch)`` per step. Returns detached, contiguous f32 params on
    ``device``; the caller's ``params`` are left as they were.

    On a card one step (``_training_step``) is captured in a CUDA graph,
    after up to two warm-up steps on a side stream that are then undone,
    and replayed ``steps`` times: a grid model's step is ~100 small
    launches, which the host alone takes longer to issue than the card
    to run.
    cuDNN runs its deterministic algorithms inside the loop, so one seed
    gives bit-identical weights."""
    dev = resolve_device(device)
    leaves, reset, step = _training_step(params, x, y, steps=steps,
                                         batch=batch, lr=lr, seed=seed,
                                         device=dev)
    with _deterministic_cudnn():
        if dev.type == "cuda" and steps:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(min(2, steps)):    # no step past the last
                    step()
            torch.cuda.current_stream(dev).wait_stream(side)
            reset()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            for _ in range(steps):
                graph.replay()
        else:
            for _ in range(steps):
                step()
    return tree_unflatten(params, [p.detach() for p in leaves])


def train_cnn(arch: TahomaCNNConfig, x, y, *, steps: int = 120,
              batch: int = 16, lr: float = 3e-3, seed: int = 0,
              device=None) -> dict:
    """Train one specialized classifier: ``init_cnn`` from a generator on
    ``device`` seeded with ``seed``, then ``fit_cnn``."""
    dev = resolve_device(device)
    params = init_cnn(torch.Generator(device=dev).manual_seed(seed), arch,
                      device=dev)
    return fit_cnn(params, x, y, steps=steps, batch=batch, lr=lr, seed=seed,
                   device=dev)


def train_model_grid(train_x, train_y, archs: Sequence[TahomaCNNConfig],
                     reps: Sequence[Representation], *,
                     trusted_arch: TahomaCNNConfig | None = None,
                     steps: int = 120, seed: int = 0,
                     log: Callable[[str], None] | None = None,
                     device=None) -> ModelBank:
    """The A x F grid (paper §V-B) + one trusted heavy model (the deepest,
    widest CNN at full resolution in full color, trained 3x as long).
    Every training input is materialized once, on ``device``, by one
    progressive pyramid pass; architecture ``ai`` trains with seed
    ``seed + ai`` and the trusted model with ``seed + 999``."""
    dev = resolve_device(device)
    raw = _as_images(train_x, dev)
    y = torch.as_tensor(np.asarray(train_y), dtype=torch.float32,
                        device=dev)
    rep_cache = materialize_representations(raw, reps)
    entries = []
    for ai, arch0 in enumerate(archs):
        for rep in reps:
            arch = TahomaCNNConfig(
                n_conv_layers=arch0.n_conv_layers,
                conv_nodes=arch0.conv_nodes, dense_nodes=arch0.dense_nodes,
                input_hw=rep.resolution, input_channels=rep.channels)
            params = train_cnn(arch, rep_cache[rep], y, steps=steps,
                               seed=seed + ai, device=dev)
            entries.append(ModelEntry(f"{arch.arch_id}_{rep.name}", arch,
                                      rep, params))
            if log:
                log(f"trained {entries[-1].name}")
    del rep_cache
    base_hw = raw.shape[1]
    t_arch = trusted_arch or TahomaCNNConfig(
        n_conv_layers=3, conv_nodes=48, dense_nodes=64,
        input_hw=base_hw, input_channels=3)
    t_params = train_cnn(t_arch, raw, y, steps=steps * 3, seed=seed + 999,
                         device=dev)
    entries.append(ModelEntry(f"trusted_{t_arch.arch_id}", t_arch,
                              Representation(base_hw, "rgb"), t_params,
                              trusted=True))
    if log:
        log(f"trained {entries[-1].name}")
    return ModelBank(entries, device=dev)


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

    def compiled_ladder(self, space: CascadeSpace, index: int, *,
                        concept: str = "pred",
                        min_accuracy: float | None = None,
                        max_rungs: int | None = None) -> list:
        """The serving degradation ladder for the cascade at ``index``:
        every strictly cheaper Pareto-frontier cascade (optionally
        floored/truncated), compiled with DISTINCT cascade ids so their
        labels land in their own virtual columns
        (core/selector.degradation_ladder; serve/service.py ladders=)."""
        from repro_torch.core.selector import degradation_ladder

        return [self.compiled_cascade(space, sel.index, concept=concept)
                for sel in degradation_ladder(space, index,
                                              min_accuracy=min_accuracy,
                                              max_rungs=max_rungs)]

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


def initialize_system(train_split, config_split, eval_split, archs, reps,
                      *, targets: Sequence[float] = thr_mod.PRECISION_TARGETS,
                      steps: int = 120, seed: int = 0, log=None,
                      infer_s: dict[str, float] | None = None,
                      device=None) -> TahomaSystem:
    """Paper Fig. 2 end to end: ``train_model_grid`` on the training
    split, then ``system_from_bank`` on the config and eval splits
    (``infer_s`` pins the per-model inference costs)."""
    tr_x, tr_y = train_split
    bank = train_model_grid(tr_x, tr_y, archs, reps, steps=steps, seed=seed,
                            log=log, device=device)
    return system_from_bank(bank, config_split, eval_split, targets=targets,
                            infer_s=infer_s)


def build_scan_engine(images, metadata=None, *, shards: int | None = None,
                      chunk: int = 64, strategy: str = "range",
                      repcache=None, fused: bool = True, lazy: bool = True,
                      int8: bool = False, use_kernel: bool | None = None,
                      device=None):
    """System-level scan-executor factory: ``shards=None``/0 builds the
    single-device ScanEngine; any explicit shard count (including 1, the
    scaling baseline) builds the ShardedScanEngine (``strategy`` 'range'
    or 'hash'; DESIGN.md §9). ``repcache`` (serial engine only) plugs a
    cross-query representation cache into per-chunk pyramid
    materialization (DESIGN.md §10.3).
    ``fused``/``lazy``/``int8``/``use_kernel`` are the hot-path knobs."""
    from repro_torch.engine.scan import ScanEngine
    from repro_torch.engine.sharded import ShardedScanEngine

    if shards:
        return ShardedScanEngine(images, metadata, shards=shards,
                                 chunk=chunk, strategy=strategy,
                                 fused=fused, lazy=lazy, int8=int8,
                                 use_kernel=use_kernel, device=device)
    return ScanEngine(images, metadata, chunk=chunk, repcache=repcache,
                      fused=fused, lazy=lazy, int8=int8,
                      use_kernel=use_kernel, device=device)


def build_cascade_service(images, cascades, *, mode: str = "async",
                          shards: int | None = None, batch_size: int = 32,
                          max_wait_s: float = 0.005, clock=None,
                          repcache_bytes: int | None = 64 << 20,
                          repcache=None, store=None, device=None,
                          host: bool = False, **hardening):
    """System-level serving factory (DESIGN.md §10, §12):
    ``mode='async'`` builds the shard-aware AsyncCascadeService
    (deadline scheduler, one queue and one lane per shard, cross-query
    representation cache — a fresh ``repcache_bytes``-budget cache
    unless the caller shares one via ``repcache``, e.g. the same object
    backing a ScanEngine); ``mode='sync'`` builds the synchronous-polling
    CascadeService from the same {concept -> CompiledCascade} table.
    ``store`` shares a scan engine's virtual columns with the service so
    previously scanned rows are served with zero model invocations.
    ``device`` (default ``cuda``; a CUDA request without a card raises)
    is where the corpus lives and the batches run.

    Hardening (async only; DESIGN.md §12): extra keyword args pass
    straight to AsyncCascadeService — ``queue_limit``, ``overload``,
    ``ladders`` (e.g. from ``TahomaSystem.compiled_ladder``),
    ``degrade`` (a DegradeConfig), ``batch_timeout_s``,
    ``request_deadline_s``, ``dispatch_retries``, ``faults``,
    ``devices``, and the ingest-index seeds
    ``ingest_index``/``ingest_exact`` (a CandidateIndex built by
    build_ingest_pipeline seeds the service store so ingest-decided rows
    answer at submit with zero model invocations).
    ``host=True`` wraps the service in a started wall-clock EventHost
    (serve/host.py) so deadlines fire without caller cooperation; the
    caller gets the HOST (``host.service`` reaches the service) and
    must ``stop()`` it."""
    import time

    from repro_torch.serve.batcher import CascadeService
    from repro_torch.serve.repcache import RepresentationCache
    from repro_torch.serve.service import AsyncCascadeService

    clock = clock or time.perf_counter
    if mode == "sync":
        if hardening or host:
            raise ValueError("hardening knobs require mode='async'")
        return CascadeService.from_cascades(cascades, batch_size,
                                            max_wait_s, clock, device=device)
    if mode != "async":
        raise ValueError(f"unknown serving mode {mode!r}")
    if repcache is None and repcache_bytes:
        repcache = RepresentationCache(repcache_bytes)
    service = AsyncCascadeService(images, cascades, shards=shards,
                                  batch_size=batch_size,
                                  max_wait_s=max_wait_s, clock=clock,
                                  repcache=repcache, store=store,
                                  device=device, **hardening)
    if host:
        from repro_torch.serve.host import EventHost
        return EventHost(service).start()
    return service


def build_ingest_pipeline(cascades, n_rows: int, *, chunk: int = 64,
                          skip: bool = True,
                          skip_threshold: float | None = 0.008,
                          calib_frames: int = 48,
                          top_k: int | None = None,
                          prune_margin: float = 0.25, int8: bool = False,
                          use_kernel: bool | None = None, device=None):
    """System-level ingest factory (DESIGN.md §14): a streaming
    IngestPipeline over the planned ``cascades`` (a sequence, or a
    {concept -> CompiledCascade} table) for a corpus/stream of
    ``n_rows`` frames. Feed arriving frames with ``.ingest(frames,
    ids)`` (any batch granularity — the temporal skip detector chains
    across calls) or sweep a resident corpus with ``.run(images)``; the
    resulting ``.index`` plugs into ``plan_query(..., index=...)`` and
    ``build_cascade_service(..., ingest_index=...)``. The
    cascades must be the SAME physical cascades queries will select —
    labels are keyed by CompiledCascade.key. A stage-0 score does not
    depend on ``chunk`` (the kernel's launch width), only on its route
    (engine/ingest.py). ``skip_threshold=None`` auto-calibrates the
    temporal-difference threshold per camera from the first
    ``calib_frames`` frames (IngestPipeline.calibrate_threshold)."""
    from repro_torch.engine.ingest import IngestPipeline

    if isinstance(cascades, dict):
        cascades = list(cascades.values())
    return IngestPipeline(cascades, n_rows, chunk=chunk, skip=skip,
                          skip_threshold=skip_threshold,
                          calib_frames=calib_frames, top_k=top_k,
                          prune_margin=prune_margin, int8=int8,
                          use_kernel=use_kernel, device=device)
