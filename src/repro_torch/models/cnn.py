"""TAHOMA's specialized classifier family (paper Fig. 3):
[conv(3x3) -> ReLU -> maxpool(2x2)] x L -> dense ReLU -> sigmoid output.

Parameters keep the reference's layout so weights cross over unchanged
(``params_from_jax``): HWIO conv weights, NHWC activations at the public
functions, and an NHWC flatten before ``dense_w``. The convolutions run
through ``F.conv2d`` outside the fused stage-0 kernel, as the reference
leaves them to XLA. Maxpool is VALID with floor, like the reference's
``reduce_window``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import TahomaCNNConfig
from repro_torch.device import resolve_device


def init_cnn(generator: torch.Generator, cfg: TahomaCNNConfig, *,
             device=None) -> dict:
    """He-style init with the reference's shapes and scales. Numbers come
    from ``generator`` (drawn on its own device), so they are not the
    reference's: parity tests carry weights over with ``params_from_jax``."""
    dev = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    params = {"conv": []}
    c_in = cfg.input_channels
    hw = cfg.input_hw
    k = cfg.kernel_size
    for _ in range(cfg.n_conv_layers):
        w = normal(k, k, c_in, cfg.conv_nodes) * (2.0 / (k * k * c_in)) ** 0.5
        params["conv"].append({"w": w,
                               "b": torch.zeros(cfg.conv_nodes, device=dev)})
        c_in = cfg.conv_nodes
        hw = hw // 2
    flat = hw * hw * c_in
    params["dense_w"] = normal(flat, cfg.dense_nodes) * (2.0 / flat) ** 0.5
    params["dense_b"] = torch.zeros(cfg.dense_nodes, device=dev)
    params["out_w"] = (normal(cfg.dense_nodes, 1)
                       * (1.0 / cfg.dense_nodes) ** 0.5)
    params["out_b"] = torch.zeros(1, device=dev)
    return params


def cnn_forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, C) float32 in [0,1] -> pre-sigmoid logits (B,)."""
    h = images.permute(0, 3, 1, 2)                      # NHWC -> NCHW
    for layer in params["conv"]:
        w = layer["w"].permute(3, 2, 0, 1)              # HWIO -> OIHW
        h = F.conv2d(h, w, padding="same")
        h = torch.relu(h + layer["b"][None, :, None, None])
        h = F.max_pool2d(h, 2)                          # VALID, floor
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    h = torch.relu(h @ params["dense_w"] + params["dense_b"])
    return (h @ params["out_w"] + params["out_b"])[:, 0]


def cnn_predict_proba(params: dict, images: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(cnn_forward(params, images))


def cnn_flops(cfg: TahomaCNNConfig) -> float:
    """Forward FLOPs per image (the cost profiler's analytic input)."""
    total = 0.0
    hw, c_in = cfg.input_hw, cfg.input_channels
    for _ in range(cfg.n_conv_layers):
        total += 2.0 * hw * hw * cfg.kernel_size ** 2 * c_in \
            * cfg.conv_nodes
        c_in = cfg.conv_nodes
        hw //= 2
    flat = hw * hw * c_in
    total += 2.0 * flat * cfg.dense_nodes + 2.0 * cfg.dense_nodes
    return total


def quantize_cnn(params: dict) -> dict:
    """Weight-only int8 quantization (per-tensor symmetric, scale =
    absmax/127), bit-identical to the reference's. Biases stay float32.
    Every weight tensor becomes ``{"q": int8, "scale": f32 scalar}``;
    ``dequantize_cnn`` keeps the arithmetic in f32."""
    def q(w):
        w = w.to(torch.float32)
        scale = torch.clamp(w.abs().max(), min=1e-8) / 127.0
        return {"q": torch.clamp(torch.round(w / scale), -127, 127
                                 ).to(torch.int8),
                "scale": scale}

    return {
        "conv": [{"w": q(l["w"]), "b": l["b"].to(torch.float32)}
                 for l in params["conv"]],
        "dense_w": q(params["dense_w"]),
        "dense_b": params["dense_b"].to(torch.float32),
        "out_w": q(params["out_w"]),
        "out_b": params["out_b"].to(torch.float32),
    }


def dequantize_cnn(qparams: dict) -> dict:
    """Inverse of ``quantize_cnn`` up to rounding: int8 weights back to
    f32 (``q * scale``), shaped like ``init_cnn`` output."""
    def dq(t):
        return t["q"].to(torch.float32) * t["scale"]

    return {
        "conv": [{"w": dq(l["w"]), "b": l["b"]} for l in qparams["conv"]],
        "dense_w": dq(qparams["dense_w"]),
        "dense_b": qparams["dense_b"],
        "out_w": dq(qparams["out_w"]),
        "out_b": qparams["out_b"],
    }


def params_from_jax(params_np, device=None):
    """A reference CNN pytree (or ``quantize_cnn`` output) already
    converted to numpy on the caller's side -> the same tree of torch
    tensors on ``device``. Layouts are kept as they are (HWIO, NHWC
    flatten order), dtypes too (int8 ``q``, f32 scalar ``scale``)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x)).to(dev)

    return conv(params_np)


def bce_loss(params: dict, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy on ``cnn_forward``'s logits
    (labels in {0,1}), averaged over the batch."""
    logits = cnn_forward(params, images)
    z = torch.clamp(logits, min=0.0)
    loss = z - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()
