"""Online-softmax attention over (B,H,S,D) q and (B,H,T,D) k/v with the KV
heads already repeated, scale D^-0.5, causal or not.

``flash_attention`` picks by the device of its inputs: on CPU tensors it
runs the plain version (kernels/ref.flash_attention_ref); on CUDA tensors
it launches the hand-written kernel (csrc/flash_attention.cu) or raises.
Under autograd (an operand that requires grad) the kernel still computes
the forward; the backward is the plain version's, recomputed (``_Flash``),
so a model trains on the card through the kernel.
q, k, v share one dtype (f32 or bf16); the output is in that dtype; head
width D is 16, 32, 64 or 128 on the card.

The kernel takes strided operands: any (B,H,S,D) view whose last
dimension is contiguous and whose rows start 16-byte aligned
(``bindings.flash_strides``), such as the (B,S,H,D).transpose(1, 2) views
the model passes. Only a view it cannot take is copied. The output is
allocated like q (``torch.empty_like`` keeps a dense view's strides), so
for the model's views ``out.transpose(1, 2)`` is a contiguous (B,S,H,D)
tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bindings
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (16, 32, 64, 128)


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the kernel takes its strides, else a contiguous
    copy."""
    if bindings.flash_refusal(t) is None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention(q, k, v, *, causal: bool = True):
    args = (q, k, v)
    if all(t.device.type == "cpu" for t in args):
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda" or any(t.device != q.device for t in args):
        raise ValueError(f"flash_attention: operands on "
                         f"{sorted({str(t.device) for t in args})}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {q.shape[3]} not in "
                         f"{_HEAD_DIMS}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Flash.apply(q, k, v, causal)
    return _launch(q, k, v, causal)


def _launch(q, k, v, causal):
    q, k, v = (kernel_operand(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if not k.shape[2]:
        return out.zero_()         # no keys: the kernel's 0 / max(0, 1e-30)
    if out.numel():
        bindings.launch_flash_attention(q, k, v, out, causal)
    return out


class _Flash(torch.autograd.Function):
    """The kernel's forward under autograd. The backward differentiates
    the plain version, recomputed from the saved inputs: the reference's
    Pallas kernel has no backward to port, and its models differentiate
    plain softmax attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_ref(*args, causal=ctx.causal)
        return (*torch.autograd.grad(out, args, grad), None)
