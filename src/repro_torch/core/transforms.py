"""The physical input-representation space F (paper §IV Def. 6, §V-B).

A Representation = (resolution, color) names one physical form of an image.
``apply_transform`` produces it from the raw full-resolution RGB image.
Downscaling uses area averaging (box filter) — a reshape-mean over NHWC
tensors, the same arithmetic as the reference, so pooled levels are
bit-identical to it on dyadic (k/256) pixels.

Representations are the unit of data-handling cost (§VI): a cascade that
uses the same representation at two levels pays its load/transform cost
ONCE (core/costs.py).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

COLOR_REPS = ("rgb", "r", "g", "b", "gray")
_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


@dataclass(frozen=True, order=True)
class Representation:
    resolution: int
    color: str  # COLOR_REPS

    @property
    def channels(self) -> int:
        return 3 if self.color == "rgb" else 1

    @property
    def values(self) -> int:
        """Input values per image = resolution^2 * channels (paper §VII-D)."""
        return self.resolution * self.resolution * self.channels

    @property
    def bytes(self) -> int:
        return self.values  # uint8 storage

    @property
    def name(self) -> str:
        return f"{self.resolution}x{self.resolution}_{self.color}"


def resize_area(img: torch.Tensor, out_hw: int) -> torch.Tensor:
    """Box-filter downscale (B,H,W,C) -> (B,out,out,C). H must be a
    multiple of out_hw (the paper's resolutions nest under our base)."""
    b, h, w, c = img.shape
    if h == out_hw:
        return img
    if h % out_hw or w % out_hw:
        raise ValueError(f"{out_hw} does not divide {(h, w)}")
    f = h // out_hw
    return img.reshape(b, out_hw, f, out_hw, f, c).mean(dim=(2, 4))


@functools.lru_cache(maxsize=None)
def _gray_on(device: torch.device) -> torch.Tensor:
    """The gray projection's weights on ``device``, copied there once (a
    copy from pageable memory waits for the stream)."""
    return torch.as_tensor(_GRAY, device=device)


def color_transform(img: torch.Tensor, color: str) -> torch.Tensor:
    """(B,H,W,3) -> (B,H,W,C') per the color representation."""
    if color == "rgb":
        return img
    if color == "gray":
        gray = _gray_on(img.device)
        return (img * gray).sum(-1, keepdim=True)
    idx = {"r": 0, "g": 1, "b": 2}[color]
    return img[..., idx:idx + 1]


def apply_transform(img: torch.Tensor, rep: Representation) -> torch.Tensor:
    """Raw RGB float image in [0,1], (B,H,W,3) -> representation tensor."""
    return color_transform(resize_area(img, rep.resolution), rep.color)


def representation_space(resolutions: Iterable[int],
                         colors: Iterable[str] = COLOR_REPS
                         ) -> list[Representation]:
    return [Representation(r, c) for r in resolutions for c in colors]


# ------------------------------------------------- representation pyramid --
# Box filters nest: area-averaging base->r1->r2 equals base->r2 whenever the
# factors divide. Each resolution is derived from the nearest (smallest)
# already-materialized resolution, and every color representation of a
# resolution shares that one pooled RGB tensor.

@dataclass(frozen=True)
class PyramidStep:
    """Produce the ``resolution`` RGB level from the ``source`` level."""
    resolution: int
    source: int


def plan_pyramid(resolutions: Iterable[int], base_hw: int
                 ) -> list[PyramidStep]:
    """Progressive downscale plan over distinct resolutions <= base_hw.
    Each level is derived from the smallest already-materialized resolution
    it divides (base_hw is always materialized). Raises if some resolution
    cannot nest under base_hw at all."""
    steps: list[PyramidStep] = []
    avail = [base_hw]
    for r in sorted({int(r) for r in resolutions}, reverse=True):
        if r == base_hw:
            continue
        src = min((a for a in avail if a > r and a % r == 0),
                  default=None)
        if src is None:
            raise ValueError(f"resolution {r} does not nest under "
                             f"{sorted(avail)}")
        steps.append(PyramidStep(r, src))
        avail.append(r)
    return steps


def materialize_pyramid(img: torch.Tensor, resolutions: Iterable[int]
                        ) -> dict:
    """One progressive pass: raw RGB (B,H,H,3) -> {resolution: RGB tensor}.
    Bit-identical to ``resize_area(img, r)`` from base when pixel values
    are exactly representable dyadics (k/256 floats: sums stay exact in
    f32 and the nested factors are powers of two); within 1 ulp
    otherwise."""
    base = img.shape[1]
    levels = {base: img}
    for step in plan_pyramid(resolutions, base):
        levels[step.resolution] = resize_area(levels[step.source],
                                              step.resolution)
    return levels


def materialize_representations(img: torch.Tensor,
                                reps: Iterable[Representation]) -> dict:
    """All representations a cascade (or the full A x F grid) needs, in one
    progressive pass: {Representation: tensor}. Color projections reuse the
    shared pooled RGB level of their resolution."""
    reps = list(reps)
    levels = materialize_pyramid(img, (r.resolution for r in reps))
    return {rep: color_transform(levels[rep.resolution], rep.color)
            for rep in set(reps)}


# analytic per-image transform FLOPs/bytes (feeds core/costs.py).
# source_hw prices the *incremental* pyramid transform: reading an already
# materialized source level instead of the full-size base image.
def transform_cost(rep: Representation, base_hw: int,
                   source_hw: int | None = None) -> dict:
    src = base_hw if source_hw is None else source_hw
    read = src * src * 3                  # bytes in (uint8)
    flops = src * src * 3                 # box-filter adds
    if rep.color == "gray":
        flops += rep.resolution ** 2 * 3
    write = rep.bytes
    return {"flops": float(flops), "bytes": float(read + write)}


def pyramid_bytes_moved(reps: Iterable[Representation], base_hw: int
                        ) -> float:
    """Total analytic bytes for materializing all reps progressively
    (vs. ``sum(transform_cost(r, base_hw)['bytes'])`` for the naive
    one-rep-at-a-time path)."""
    reps = list(reps)
    total = 0.0
    for step in plan_pyramid((r.resolution for r in reps), base_hw):
        total += step.source ** 2 * 3 + step.resolution ** 2 * 3
    for rep in set(reps):
        if rep.color == "rgb":
            continue                      # shares the pooled RGB level
        total += rep.resolution ** 2 * 3 + rep.bytes
    return total
