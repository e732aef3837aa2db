"""Plain PyTorch versions of the hand-written kernels: what the wrappers
run on CPU tensors, and what ``chip_smoke.py`` holds each kernel against
on the card."""
from __future__ import annotations

import torch

from repro_torch.core.transforms import (color_transform,
                                         materialize_pyramid, resize_area)
from repro_torch.models.cnn import cnn_predict_proba, dequantize_cnn


def fused_transform_ref(images, channel_weights, res: int,
                        mean: float = 0.5, std: float = 0.25):
    """resize_area -> (3, C') channel projection -> (x - mean) / std."""
    x = resize_area(images.to(torch.float32), res)
    cw = torch.as_tensor(channel_weights, dtype=torch.float32,
                         device=x.device)
    x = torch.einsum("bhwc,cd->bhwd", x, cw)
    return (x - mean) / std


def fused_pyramid_transform_ref(images, rep_specs, mean: float = 0.5,
                                std: float = 0.25):
    """Each (res, channel_weights) representation independently from the
    base (the nesting of box filters makes the progressive kernel agree)."""
    return tuple(fused_transform_ref(images, cw, int(res), mean, std)
                 for res, cw in rep_specs)


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


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q (B,H,S,D); k/v (B,H,T,D), KV heads already repeated."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    s = s * (q.shape[-1] ** -0.5)
    if causal:
        qn, kn = q.shape[2], k.shape[2]
        mask = (torch.arange(qn, device=q.device)[:, None]
                >= torch.arange(kn, device=q.device)[None, :])
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def ssd_scan_ref(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """The model layer's plain SSD (models/ssm.ssd_chunked) with no
    initial state: returns y (B,S,H,P) f32 and the final state (B,H,P,N)
    f32."""
    from repro_torch.models.ssm import ssd_chunked   # ssm imports ssd_scan
    return ssd_chunked(x, dt, a, bmat, cmat, chunk)
