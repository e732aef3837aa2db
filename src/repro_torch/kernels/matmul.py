"""Blocked (M,K) @ (K,N) matrix product with an f32 accumulator.

``matmul`` picks by the device of its inputs: on CPU tensors it runs the
plain version (kernels/ref.matmul_ref); on CUDA tensors it launches the
hand-written tiled kernel (csrc/matmul.cu) or raises. f32 or bf16 inputs,
f32 accumulation, ``out_dtype`` (default: the input dtype) out.

``bindings.matmul_plan`` chooses the kernel's tiling per shape: the output
tile of a block and, where the tiles alone cannot fill the card, a split of
K whose partial sums a second pass adds in a fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bindings
from repro_torch.kernels.ref import matmul_ref

_DTYPES = (torch.float32, torch.bfloat16)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None
           ) -> torch.Tensor:
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    out_dtype = out_dtype or a.dtype
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES \
            or out_dtype not in _DTYPES:
        raise ValueError(f"matmul: dtypes {a.dtype}, {b.dtype} -> "
                         f"{out_dtype}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype,
                      device=a.device)
    if out.numel():
        bindings.launch_matmul(a, b, out)
    return out
