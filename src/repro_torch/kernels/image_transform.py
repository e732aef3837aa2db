"""Fused pyramid + stage-0 pass (the per-chunk hot path of the scan
engine): one read of the raw base per image emits the raw pooled RGB
pyramid levels the engine carries between cascade stages AND the stage-0
cascade model's sigmoid scores.

``fused_pyramid_stage0`` picks by the device of ``images``: on a CPU
tensor it runs the plain version (kernels/ref.py); on a CUDA tensor it
launches the hand-written kernel (csrc/pyramid_stage0.cu) or raises.
There is no fallback between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.transforms import _GRAY, plan_pyramid
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_pyramid_stage0_ref


def color_weight_matrix(color: str) -> np.ndarray:
    """(3, C') channel-projection matrix matching core.transforms.
    color_transform exactly (identity / unit column / gray weights)."""
    if color == "rgb":
        return np.eye(3, dtype=np.float32)
    if color == "gray":
        return _GRAY.reshape(3, 1).astype(np.float32)
    idx = {"r": 0, "g": 1, "b": 2}[color]
    w = np.zeros((3, 1), np.float32)
    w[idx, 0] = 1.0
    return w


def fused_pyramid_stage0(images: torch.Tensor, out_res, params, rep, *,
                         qparams=None):
    """Raw RGB (B, H, H, 3) float32 -> ({res: (B, res, res, 3) raw pooled
    RGB level for res in out_res}, stage-0 sigmoid scores (B,)).

    Levels are bit-identical to core.transforms.materialize_pyramid on
    dyadic pixels. ``rep`` names the stage-0 model's input
    representation; its resolution is pooled even when not in
    ``out_res``. ``qparams`` (models/cnn.quantize_cnn output) selects the
    int8 weight path (dequantize-at-use)."""
    if images.device.type == "cpu":
        return fused_pyramid_stage0_ref(images, out_res, params, rep,
                                        qparams=qparams)
    if images.device.type != "cuda":
        raise ValueError(f"fused_pyramid_stage0: unsupported device "
                         f"{images.device}")
    return _launch(images, [int(r) for r in out_res], params, rep, qparams)


def _weight_operands(params, qparams):
    """[(w, b, scale)] per conv layer, then dense, then out; scale is
    1.0 on the f32 path."""
    src = qparams if qparams is not None else params

    def w(t):
        if qparams is None:
            return _aligned(t.to(torch.float32).contiguous()), 1.0
        return _aligned(t["q"].contiguous()), float(t["scale"])

    out = [(*w(l["w"]), l["b"].to(torch.float32).contiguous())
           for l in src["conv"]]
    out.append((*w(src["dense_w"]),
                src["dense_b"].to(torch.float32).contiguous()))
    out.append((*w(src["out_w"]), src["out_b"].to(torch.float32).contiguous()))
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads conv weights 16 bytes at a time: a view that does
    not start on a 16-byte boundary is copied to one that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(images, out_res, params, rep, qparams):
    if images.dtype != torch.float32 or images.dim() != 4 \
            or images.shape[1] != images.shape[2] or images.shape[3] != 3:
        raise ValueError(f"images must be (B, H, H, 3) float32, got "
                         f"{tuple(images.shape)} {images.dtype}")
    images = images.contiguous()
    dev = images.device
    b, h = images.shape[0], images.shape[1]
    if b == 0:
        raise ValueError("fused_pyramid_stage0: empty batch")
    s0_res = int(rep.resolution)
    steps = plan_pyramid(set(out_res) | {s0_res}, h)
    if len(steps) > ops.MAX_STEPS:
        raise ValueError(f"at most {ops.MAX_STEPS} pyramid steps")
    weights = _weight_operands(params, qparams)
    *conv, (dense_w, dense_s, dense_b), (out_w, out_s, out_b) = weights
    if len(conv) > ops.MAX_CONV:
        raise ValueError(f"at most {ops.MAX_CONV} conv layers")
    cw = color_weight_matrix(rep.color)
    c = cw.shape[1]
    dense_n = dense_w.shape[1]
    if dense_n > ops.PS0_THREADS:
        raise ValueError(f"dense layer wider than the kernel's "
                         f"{ops.PS0_THREADS} threads")

    # scratch: two ping-pong activation buffers per image, each large
    # enough for the projected input and for every pooled conv output
    hw, need, cin = s0_res, s0_res * s0_res * c, c
    for w, _, _ in conv:
        if w.shape[:3] != (3, 3, cin):
            raise ValueError(f"conv weight {tuple(w.shape)} is not 3x3x{cin}")
        cin = w.shape[3]
        hw //= 2
        need = max(need, hw * hw * cin)
    if dense_w.shape[0] != hw * hw * cin:
        raise ValueError("dense_w rows do not match the flattened conv "
                         "output")
    for t in [dense_w, dense_b, out_w, out_b] + [x for l in conv for x in
                                                 (l[0], l[2])]:
        if t.device != dev:
            raise ValueError("stage-0 weights must lie on the images' "
                             "device")

    levels = {st.resolution: torch.empty((b, st.resolution, st.resolution,
                                          3), device=dev)
              for st in steps}
    scores = torch.empty(b, device=dev)
    scratch = torch.empty(b * 2 * need, device=dev)
    index = {st.resolution: i for i, st in enumerate(steps)}

    prm = ops.PS0Params()
    prm.img = images.data_ptr()
    prm.scores = scores.data_ptr()
    prm.scratch = scratch.data_ptr()
    prm.scratch_stride = need
    prm.B, prm.H, prm.n_steps = b, h, len(steps)
    for i, st in enumerate(steps):
        prm.step_out[i] = levels[st.resolution].data_ptr()
        prm.step_res[i] = st.resolution
        prm.step_src[i] = -1 if st.source == h else index[st.source]
    prm.s0_step = -1 if s0_res == h else index[s0_res]
    prm.s0_res, prm.C = s0_res, c
    for i, v in enumerate(cw.reshape(-1)):
        prm.cw[i] = float(v)
    prm.n_conv = len(conv)
    for i, (w, s, bias) in enumerate(conv):
        prm.conv_w[i] = w.data_ptr()
        prm.conv_b[i] = bias.data_ptr()
        prm.conv_cout[i] = w.shape[3]
        prm.conv_scale[i] = s
    prm.dense_w, prm.dense_b, prm.dense_n = (dense_w.data_ptr(),
                                             dense_b.data_ptr(), dense_n)
    prm.out_w, prm.out_b = out_w.data_ptr(), out_b.data_ptr()
    prm.dense_scale, prm.out_scale = dense_s, out_s
    ops.launch_pyramid_stage0(prm, int8_weights=qparams is not None)
    # the caching allocator may hand `scratch` (and dropped operand copies)
    # to later work queued on this same stream only, so freeing them here
    # is safe without a synchronize
    return {r: images if r == h else levels[r] for r in out_res}, scores
