"""Mamba-2 SSD chunk scan: y and the final state of every (batch, head)
stream.

``ssd_scan`` picks by the device of its inputs: on CPU tensors it runs the
plain version (kernels/ref.ssd_scan_ref, the model layer's
``ssd_chunked``); on CUDA tensors it launches the hand-written kernel
(csrc/ssd_scan.cu) or raises. x (B,S,H,P) and bmat/cmat (B,S,N) share one
dtype (f32 or bf16), dt (B,S,H) and a (H,) are f32; returns y (B,S,H,P)
f32 and the final state (B,H,P,N) f32. ``chunk`` is the plain version's
chunk length; the kernel runs its own 64-token chunk, and the result does
not depend on it beyond f32 rounding. Both refuse a sequence that is not
a multiple of ``min(chunk, S)``, as the reference does. bf16 operands go
to the tensor-core kernel (P <= 64, N <= 128, several heads a block:
``bindings.ssd_heads_per_block``), f32 operands and other shapes to the
f32 FFMA kernel; a head width and state size whose tiles exceed a block's
shared memory there (above 128 x 128) fail at launch, and the wrapper
raises.

Under autograd (grad enabled and an operand that requires grad) the
kernel still computes the forward; the backward differentiates the plain
version, recomputed from the saved inputs, for both outputs (``_SSD``),
so a model trains on the card through the kernel. The reference has no
backward kernel to port: its Pallas kernel has none, and its models
differentiate the plain ``ssd_chunked``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bindings
from repro_torch.kernels.ref import ssd_scan_ref

_DTYPES = (torch.float32, torch.bfloat16)


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 128):
    args = (x, dt, a, bmat, cmat)
    if all(t.device.type == "cpu" for t in args):
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in args):
        raise ValueError(f"ssd_scan: operands on "
                         f"{sorted({str(t.device) for t in args})}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} is not (B,S,H,P)")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,)
            or tuple(bmat.shape) != (b, s, n)
            or tuple(cmat.shape) != (b, s, n)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(bmat.shape)}, c {tuple(cmat.shape)}")
    if s % min(chunk, max(s, 1)):
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    if (x.dtype not in _DTYPES or bmat.dtype != x.dtype
            or cmat.dtype != x.dtype or dt.dtype != torch.float32
            or a.dtype != torch.float32):
        raise ValueError(f"ssd_scan: dtypes x {x.dtype}, b {bmat.dtype}, "
                         f"c {cmat.dtype}, dt {dt.dtype}, a {a.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _SSD.apply(x, dt, a, bmat, cmat, chunk)
    return _launch(x, dt, a, bmat, cmat)


def _launch(x, dt, a, bmat, cmat):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if not y.numel():
        return y, final.zero_()
    bindings.launch_ssd_scan(x.contiguous(), dt.contiguous(), a.contiguous(),
                        bmat.contiguous(), cmat.contiguous(), y, final)
    return y, final


class _SSD(torch.autograd.Function):
    """The kernel's forward under autograd. The backward differentiates
    the plain version (``ssd_scan_ref``), recomputed from the saved
    inputs, for y and the final state: the reference's Pallas kernel has
    no backward to port, and its models differentiate ``ssd_chunked``."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk):
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        return _launch(x, dt, a, bmat, cmat)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        want = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(w)
                    for t, w in zip(ctx.saved_tensors, want)]
            y, final = ssd_scan_ref(*args, chunk=ctx.chunk)
        wrt = [t for t, w in zip(args, want) if w]
        grads = iter(torch.autograd.grad((y, final), wrt,
                                         (grad_y, grad_final)))
        return (*(next(grads) if w else None for w in want), None)
