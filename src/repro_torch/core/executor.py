"""Online batched cascade execution (the reference's two-phase batch
compaction, DESIGN.md §3):
  1. classify the full (sub-)batch with level l;
  2. stable-argsort the uncertainty mask, gather the uncertain prefix into
     a FIXED-CAPACITY sub-batch, run level l+1 on it, scatter results back.
Capacity per level is a knob; overflow items keep level-l's forced
decision (o >= 0.5) and are counted in the returned stats.

Representation derivation: when levels are given as ``Representation``s,
each level's input is derived from the nearest already-materialized
pyramid level (box filters nest), exactly the policy core/cascade's cost
matrices price (``derivation_sources``).

Thresholds are compared in f32, as the reference compares a Python float
threshold against f32 scores.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.transforms import (Representation, color_transform,
                                         materialize_pyramid, resize_area)


def derivation_sources(res_seq: list[int], base: int) -> list[int]:
    """Source resolution each level's representation derives from: the
    smallest already-materialized pyramid level it divides (base is always
    materialized; running a level materializes its resolution)."""
    out = []
    materialized = {base}
    for r in res_seq:
        usable = [m for m in materialized if m % r == 0]
        out.append(min(usable) if usable else base)
        materialized.add(r)
    return out


def run_cascade_on_pyramid(pyramid, model_fns: Sequence[Callable],
                           thresholds, reps: Sequence[Representation],
                           capacities: Sequence[int], level0_scores=None):
    """Run a cascade whose level inputs all derive from a CALLER-PROVIDED
    RGB pyramid cache ``{resolution: (B, r, r, 3) tensor}`` (the scan
    engine's entry point: one pyramid per chunk serves every cascade).
    Missing levels are pooled from the smallest cached level they divide
    and cached in a local copy. ``level0_scores``: precomputed level-0
    probabilities (B,) — the fused pyramid+stage-0 kernel's output; level
    0's model is then not invoked. Returns (labels (B,), stats)."""
    pyr_cache = dict(pyramid)
    base = max(pyr_cache)
    res_seq = [r.resolution for r in reps]

    def _pyramid_level(res: int):
        if res not in pyr_cache:
            usable = [m for m in pyr_cache if m % res == 0]
            src = min(usable) if usable else base
            pyr_cache[res] = resize_area(pyr_cache[src], res)
        return pyr_cache[res]

    def get_input(l: int, take):
        level = _pyramid_level(res_seq[l])
        sub = level if take is None else level[take]
        return color_transform(sub, reps[l].color)

    b = next(iter(pyr_cache.values())).shape[0]
    return _cascade_loop(b, get_input, model_fns, thresholds, capacities,
                         level0_scores=level0_scores)


def run_cascade_batch(images, model_fns: Sequence[Callable],
                      thresholds, transforms, capacities: Sequence[int],
                      pyramid_cache=None):
    """images: raw batch (B, H, W, 3). Returns (labels (B,), stats).
    thresholds[l] = (p_low, p_high); final level may be (None, None).
    transforms: per-level transform callables, or per-level
    ``Representation``s (pyramid source derivation). capacities[l]:
    static sub-batch size for level l >= 1."""
    if transforms and isinstance(transforms[0], Representation):
        pyr = {images.shape[1]: images}
        if pyramid_cache:
            pyr.update(pyramid_cache)
        return run_cascade_on_pyramid(pyr, model_fns, thresholds,
                                      list(transforms), capacities)

    def get_input(l: int, take):
        sub = images if take is None else images[take]
        return transforms[l](sub)

    return _cascade_loop(images.shape[0], get_input, model_fns,
                         thresholds, capacities)


def _f32(x: float) -> float:
    """``x`` rounded to f32, kept a Python number: comparing f32 scores
    with it is the f32 comparison, and it needs no host-to-device copy
    (one from pageable memory waits for the stream, which would stall a
    shard lane of engine/sharded.py)."""
    return float(np.float32(x))


def _cascade_loop(b: int, get_input, model_fns, thresholds, capacities,
                  level0_scores=None):
    """Two-phase compaction loop shared by both input paths."""
    o = (model_fns[0](get_input(0, None)) if level0_scores is None
         else level0_scores)
    dev = o.device
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    levels_used = torch.zeros(len(model_fns), dtype=torch.int32, device=dev)
    levels_used[0] = b
    lo, hi = thresholds[0]
    if lo is None:
        return (o >= 0.5).to(torch.int32), {"overflow": overflow,
                                            "levels_used": levels_used}
    lo, hi = _f32(lo), _f32(hi)
    decided = (o <= lo) | (o >= hi)
    labels = (o >= hi).to(torch.int32)
    forced = (o >= 0.5).to(torch.int32)      # fallback if never decided

    active = ~decided
    for l in range(1, len(model_fns)):
        cap = int(capacities[l - 1])
        # compact: uncertain items first (stable order; uint8 keys since
        # the sort must not depend on how a backend orders bools)
        order = torch.argsort((~active).to(torch.uint8), stable=True)
        take = order[:cap]
        valid = active[take]
        overflow = overflow + active.sum() - valid.sum()
        o = model_fns[l](get_input(l, take))
        levels_used[l] = valid.sum()
        lo, hi = thresholds[l]
        final = lo is None
        if final:
            sub_decided = valid
            sub_labels = (o >= 0.5).to(torch.int32)
        else:
            lo, hi = _f32(lo), _f32(hi)
            sub_decided = valid & ((o <= lo) | (o >= hi))
            sub_labels = (o >= hi).to(torch.int32)
        labels[take] = torch.where(sub_decided, sub_labels, labels[take])
        decided[take] = decided[take] | sub_decided
        active[take] = active[take] & ~sub_decided
        if final:
            break
    labels = torch.where(decided, labels, forced)
    return labels, {"overflow": overflow, "levels_used": levels_used}


def calibrate_capacity(uncertain_fraction: float, batch: int,
                       quantile_margin: float = 1.3) -> int:
    """Capacity knob: expected uncertain count x a margin, clamped."""
    return int(min(batch, max(8, round(batch * uncertain_fraction
                                       * quantile_margin))))


# ------------------------------------------------- fused chunk ingest --
# The per-chunk hot path of the scan engine: pyramid materialization + the
# full stage-0 cascade + carried-level emission for one chunk. On a CUDA
# chunk with stage-0 params, the pyramid + level-0 model run as ONE kernel
# (kernels/image_transform.fused_pyramid_stage0, one read of the base).


@dataclass(frozen=True)
class Stage0:
    """The first cascade stage's model in kernel-foldable form: the raw CNN
    parameter dict + its input representation (CompiledCascade's model_fns
    are opaque closures — the fused kernel needs the actual weights).
    ``qparams`` (models/cnn.quantize_cnn) enables the int8 weight path."""
    params: Any
    rep: Representation
    qparams: Any = None


def make_fused_ingest(model_fns: Sequence[Callable], thresholds,
                      reps: Sequence[Representation],
                      capacities: Sequence[int], out_res,
                      *, stage0: Stage0 | None = None,
                      use_kernel: bool | None = None, int8: bool = False,
                      emit_scores: bool = False):
    """Build the fused per-chunk ingest: fn(imgs (B,H,H,3)) -> (labels
    (B,), {res: (B,res,res,3) raw pooled level for res in out_res}).

    Runs the FULL stage-0 cascade (all its levels, full width) and emits
    the ``out_res`` pyramid levels later stages carry.
    ``use_kernel=None`` resolves per call to True when the chunk lies on a
    CUDA device and ``stage0`` is given. ``int8`` swaps stage-0's weights
    for the int8-quantized copy (requires ``stage0.qparams``).
    ``emit_scores=True`` additionally returns the level-0 probabilities."""
    out_res = [int(r) for r in out_res]
    need = sorted({r.resolution for r in reps} | set(out_res))
    if use_kernel and stage0 is None:
        raise ValueError("use_kernel requires stage0 params")
    if int8 and (stage0 is None or stage0.qparams is None):
        raise ValueError("int8 requires stage0.qparams")

    unfused_fns = list(model_fns)
    if int8:
        # unfused int8: dequantize once at build, identical arithmetic to
        # the kernel's dequantize-at-use
        from repro_torch.models.cnn import cnn_predict_proba, dequantize_cnn
        unfused_fns[0] = partial(cnn_predict_proba,
                                 dequantize_cnn(stage0.qparams))

    def finish(pyr, fns, s0):
        labels, _ = run_cascade_on_pyramid(pyr, fns, thresholds, reps,
                                           capacities, level0_scores=s0)
        emitted = {r: pyr[r] for r in out_res}
        return (labels, emitted, s0) if emit_scores else (labels, emitted)

    def run(imgs):
        base = imgs.shape[1]
        pooled = [r for r in need if r != base]
        kernel = (use_kernel if use_kernel is not None
                  else stage0 is not None and imgs.is_cuda)
        if kernel:
            from repro_torch.kernels.image_transform import \
                fused_pyramid_stage0
            levels, s0 = fused_pyramid_stage0(
                imgs, pooled, stage0.params, stage0.rep,
                qparams=stage0.qparams if int8 else None)
            return finish({base: imgs, **levels}, list(model_fns), s0)
        pyr = materialize_pyramid(imgs, pooled)
        s0 = None
        if emit_scores:
            # score level 0 explicitly and feed it back as level0_scores
            s0 = unfused_fns[0](color_transform(pyr[reps[0].resolution],
                                                reps[0].color))
        return finish(pyr, unfused_fns, s0)

    return run
