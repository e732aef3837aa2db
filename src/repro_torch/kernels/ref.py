"""Plain PyTorch versions of the hand-written kernels: what the wrappers
run on CPU tensors, and what ``chip_smoke.py`` holds each kernel against
on the card."""
from __future__ import annotations

import torch

from repro_torch.core.transforms import color_transform, materialize_pyramid
from repro_torch.models.cnn import cnn_predict_proba, dequantize_cnn


def fused_pyramid_stage0_ref(images, out_res, params, rep, qparams=None):
    """The unfused materialize_pyramid -> color_transform ->
    cnn_predict_proba chain. With ``qparams`` the weights are dequantized
    first (weight-only int8: the arithmetic stays f32, matching the
    kernel's dequantize-at-use)."""
    p = dequantize_cnn(qparams) if qparams is not None else params
    out_res = [int(r) for r in out_res]
    levels = materialize_pyramid(images.to(torch.float32),
                                 set(out_res) | {int(rep.resolution)})
    scores = cnn_predict_proba(
        p, color_transform(levels[int(rep.resolution)], rep.color))
    return {r: levels[r] for r in out_res}, scores


def matmul_ref(a, b, out_dtype=None):
    out = a.to(torch.float32) @ b.to(torch.float32)
    return out.to(out_dtype or a.dtype)
