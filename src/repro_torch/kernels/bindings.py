"""ctypes bindings of the hand-written CUDA kernels, and their launch
counters.

Each ``launch_*`` function takes tensors that already lie on the card
(the wrappers in ``image_transform.py``, ``matmul.py``,
``flash_attention.py`` and ``ssd_scan.py`` validate and allocate), launches
on ``torch.cuda.current_stream()`` without synchronizing, raises if the C
entry point reports a CUDA error, and adds one to its kernel's count in
``LAUNCHES`` — there and nowhere else. ``kernels/ops.py`` re-exports
``LAUNCHES`` and ``reset_launch_counts``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import library

MAX_STEPS = 8
MAX_CONV = 8
PS0_THREADS = 512   # THREADS in csrc/pyramid_stage0.cu: one per dense unit
IT_MAX_OUTPUTS = 32   # csrc/image_transform.cu: the query path needs 20
IT_MAX_LEVELS = 16
SMS = 132          # streaming multiprocessors of an H100 SXM
# (BM, BN) output tiles that csrc/matmul.cu instantiates, largest first
MM_TILES = ((64, 64), (32, 64), (32, 32))
MM_BK = 32         # BK in csrc/matmul.cu; a split-K chunk is a multiple
MM_MIN_K_CHUNK = 2 * MM_BK   # a split keeps at least two K steps to pipeline

LAUNCHES = {"fused_pyramid_stage0": 0, "matmul": 0, "flash_attention": 0,
            "ssd_scan": 0, "fused_transform": 0,
            "fused_pyramid_transform": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PS0Params(ctypes.Structure):
    """Mirror of ``struct PS0Params`` in csrc/pyramid_stage0.cu."""
    _fields_ = [
        ("img", ctypes.c_void_p),
        ("scores", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("step_out", ctypes.c_void_p * MAX_STEPS),
        ("conv_w", ctypes.c_void_p * MAX_CONV),
        ("conv_b", ctypes.c_void_p * MAX_CONV),
        ("dense_w", ctypes.c_void_p),
        ("dense_b", ctypes.c_void_p),
        ("out_w", ctypes.c_void_p),
        ("out_b", ctypes.c_void_p),
        ("scratch_stride", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("n_steps", ctypes.c_int),
        ("s0_step", ctypes.c_int), ("s0_res", ctypes.c_int),
        ("C", ctypes.c_int), ("n_conv", ctypes.c_int),
        ("dense_n", ctypes.c_int),
        ("step_res", ctypes.c_int * MAX_STEPS),
        ("step_src", ctypes.c_int * MAX_STEPS),
        ("conv_cout", ctypes.c_int * MAX_CONV),
        ("cw", ctypes.c_float * 9),
        ("conv_scale", ctypes.c_float * MAX_CONV),
        ("dense_scale", ctypes.c_float),
        ("out_scale", ctypes.c_float),
    ]


class ITParams(ctypes.Structure):
    """Mirror of ``struct ITParams`` in csrc/image_transform.cu."""
    _fields_ = [
        ("img", ctypes.c_void_p),
        ("out", ctypes.c_void_p * IT_MAX_OUTPUTS),
        ("B", ctypes.c_int), ("H", ctypes.c_int),
        ("tile_h", ctypes.c_int), ("tile_w", ctypes.c_int),
        ("vec4", ctypes.c_int), ("smem_bytes", ctypes.c_int),
        ("n_levels", ctypes.c_int),
        ("level_res", ctypes.c_int * IT_MAX_LEVELS),
        ("level_src", ctypes.c_int * IT_MAX_LEVELS),
        ("level_off", ctypes.c_int * IT_MAX_LEVELS),
        ("n_out", ctypes.c_int),
        ("out_level", ctypes.c_int * IT_MAX_OUTPUTS),
        ("out_ch", ctypes.c_int * IT_MAX_OUTPUTS),
        ("out_cw", ctypes.c_float * (9 * IT_MAX_OUTPUTS)),
        ("mean", ctypes.c_float), ("inv_std", ctypes.c_float),
    ]


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _ps0_fn():
    lib = library("pyramid_stage0")
    fn = lib.repro_pyramid_stage0
    if fn.argtypes is None:
        lib.repro_ps0_params_size.restype = ctypes.c_int
        size = lib.repro_ps0_params_size()
        if size != ctypes.sizeof(PS0Params):
            raise RuntimeError(f"PS0Params layout mismatch: C {size} bytes, "
                               f"ctypes {ctypes.sizeof(PS0Params)}")
        fn.argtypes = [ctypes.POINTER(PS0Params), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_pyramid_stage0(prm: PS0Params, int8_weights: bool) -> None:
    """Every pointer in ``prm`` must reference a live CUDA tensor the
    caller keeps alive until the stream has run the kernel."""
    fn = _ps0_fn()
    _check(fn(ctypes.byref(prm), int(int8_weights), _stream()),
           "fused_pyramid_stage0")
    LAUNCHES["fused_pyramid_stage0"] += 1


def _bind(stem: str, name: str, argtypes):
    fn = getattr(library(stem), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def matmul_plan(m: int, n: int, k: int) -> tuple[int, int, int, int]:
    """-> (bm, bn, split, k_chunk) for an (m,k) @ (k,n) launch of
    csrc/matmul.cu: the largest tile of MM_TILES (no taller than m needs)
    that can reach SMS blocks, and the fewest K chunks of ``k_chunk`` (a
    multiple of MM_BK, at least MM_MIN_K_CHUNK; the last may be short)
    that reach them. Where nothing reaches SMS (small or shallow
    products), the smallest tile and as many chunks as K allows. Split-K
    partial sums go to a workspace that a second pass adds in a fixed
    order."""
    max_split = max(1, k // MM_MIN_K_CHUNK)
    fits = [t for t in MM_TILES if t[0] <= _cdiv(m, 32) * 32] \
        or [MM_TILES[-1]]
    bm, bn = next((t for t in fits
                   if _cdiv(m, t[0]) * _cdiv(n, t[1]) * max_split >= SMS),
                  fits[-1])
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    for split in range(1, max_split + 1):
        k_chunk = _cdiv(_cdiv(k, split), MM_BK) * MM_BK
        split = _cdiv(k, k_chunk) if k_chunk else 1   # rounding may merge
        if tiles * split >= SMS:
            break
    return bm, bn, split, k_chunk


def launch_matmul(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor
                  ) -> None:
    """a (M,K) @ b (K,N) -> out (M,N), contiguous, with the tiling and
    split-K of ``matmul_plan``; a split-K workspace is allocated here."""
    fn = _bind("matmul", "repro_matmul",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    m, k = a.shape
    n = b.shape[1]
    bm, bn, split, k_chunk = matmul_plan(m, n, k)
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=a.device)
          if split > 1 else None)
    _check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
              None if ws is None else ws.data_ptr(), m, n, k,
              int(a.dtype == torch.bfloat16),
              int(out.dtype == torch.bfloat16), bm, bn, split, k_chunk,
              _stream()), "matmul")
    LAUNCHES["matmul"] += 1


def launch_ssd_scan(x, dt, a, bmat, cmat, y, final) -> None:
    fn = _bind("ssd_scan", "repro_ssd_scan",
               [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    _check(fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
              cmat.data_ptr(), y.data_ptr(), final.data_ptr(), b, s, h, p, n,
              int(x.dtype == torch.bfloat16), _stream()), "ssd_scan")
    LAUNCHES["ssd_scan"] += 1


def flash_refusal(t: torch.Tensor) -> str | None:
    """Why csrc/flash_attention.cu cannot take ``t`` as a (B,H,S,D)
    operand, or None: it needs the last dimension contiguous and every
    row start 16-byte aligned."""
    if t.dim() != 4:
        return f"shape {tuple(t.shape)} is not (B,H,S,D)"
    (b, h, s, d), st = t.shape, t.stride()
    if d > 1 and st[3] != 1:
        return f"last stride {st[3]} is not 1"
    per = 16 // t.element_size()
    ptr = t.data_ptr()
    if ptr % 16 or (b > 1 and st[0] % per) or (h > 1 and st[1] % per) \
            or (s > 1 and st[2] % per):
        return (f"rows not 16-byte aligned (strides {st}, {t.dtype}, data "
                f"at {ptr % 16} mod 16)")
    return None


def flash_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """The (batch, head, sequence) strides in elements that
    csrc/flash_attention.cu takes for a (B,H,S,D) operand; a dimension of
    size 1 gets 0 (its stride is never used). ValueError if the kernel
    cannot take ``t`` (``flash_refusal``)."""
    why = flash_refusal(t)
    if why:
        raise ValueError(f"flash_attention: {why}")
    (b, h, s, _), st = t.shape, t.stride()
    return (st[0] if b > 1 else 0, st[1] if h > 1 else 0,
            st[2] if s > 1 else 0)


def launch_flash_attention(q, k, v, out, causal: bool) -> None:
    """q, out (B,H,S,D); k, v (B,H,T,D); any strides that
    ``flash_strides`` accepts."""
    fn = _bind("flash_attention", "repro_flash_attention",
               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
               + [ctypes.c_float] + [ctypes.c_longlong] * 12
               + [ctypes.c_void_p])
    b, h, s, d = q.shape
    strides = [x for t in (q, k, v, out) for x in flash_strides(t)]
    _check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              b, h, s, k.shape[2], d, int(q.dtype == torch.bfloat16),
              int(causal), d ** -0.5, *strides, _stream()),
           "flash_attention")
    LAUNCHES["flash_attention"] += 1


def _it_fn(name: str):
    lib = library("image_transform")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        lib.repro_it_params_size.restype = ctypes.c_int
        size = lib.repro_it_params_size()
        if size != ctypes.sizeof(ITParams):
            raise RuntimeError(f"ITParams layout mismatch: C {size} bytes, "
                               f"ctypes {ctypes.sizeof(ITParams)}")
        fn.argtypes = [ctypes.POINTER(ITParams), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch_fused_transform(prm: ITParams) -> None:
    """``prm`` holds one output. Every pointer in it must reference a live
    CUDA tensor the caller keeps alive until the stream has run the
    kernel."""
    _check(_it_fn("repro_fused_transform")(ctypes.byref(prm), _stream()),
           "fused_transform")
    LAUNCHES["fused_transform"] += 1


def launch_fused_pyramid_transform(prm: ITParams) -> None:
    """As ``launch_fused_transform``, for any number of outputs up to
    ``IT_MAX_OUTPUTS``."""
    _check(_it_fn("repro_fused_pyramid_transform")(ctypes.byref(prm),
                                                   _stream()),
           "fused_pyramid_transform")
    LAUNCHES["fused_pyramid_transform"] += 1
