"""Public entry points of the kernels: the counterpart of the reference's
``kernels/ops.py``.

Each ``*_op`` is a plain function over a kernel wrapper, so it runs where
its operands lie: the plain version on CPU tensors, the hand-written kernel
on CUDA tensors (or it raises). The reference's ``backend="ref"`` is a
direct call of ``kernels/ref.py`` here. ``LAUNCHES``, ``FLASH_SHAPES``,
``SSD_SHAPES`` and ``reset_launch_counts`` are ``kernels/bindings.py``'s
own objects, the one place launch counts are read.
"""
from __future__ import annotations

from repro_torch.core.transforms import COLOR_REPS
from repro_torch.kernels.bindings import (FLASH_SHAPES, LAUNCHES,
                                          SSD_SHAPES, reset_launch_counts)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.image_transform import (color_weight_matrix,
                                                 fused_pyramid_transform,
                                                 fused_transform)
from repro_torch.kernels.matmul import matmul
from repro_torch.kernels.ssd_scan import ssd_scan

__all__ = ["COLOR_WEIGHTS", "FLASH_SHAPES", "LAUNCHES", "SSD_SHAPES",
           "reset_launch_counts",
           "transform_op", "pyramid_transform_op", "matmul_op",
           "flash_attention_op", "ssd_scan_op"]

COLOR_WEIGHTS = {c: color_weight_matrix(c) for c in COLOR_REPS}


def transform_op(images, *, res: int, color: str = "rgb"):
    return fused_transform(images, COLOR_WEIGHTS[color], res)


def pyramid_transform_op(images, *, specs):
    """Multi-output fused transform. specs: (res, color) pairs — one
    output tensor per pair, all from a single pass over the base image."""
    return fused_pyramid_transform(
        images, [(res, COLOR_WEIGHTS[color]) for res, color in specs])


def matmul_op(a, b):
    return matmul(a, b)


def flash_attention_op(q, k, v, *, causal: bool = True):
    return flash_attention(q, k, v, causal=causal)


def ssd_scan_op(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """y (B,S,H,P) only, as the reference's op returns it."""
    y, _ = ssd_scan(x, dt, a, bmat, cmat, chunk=chunk)
    return y
