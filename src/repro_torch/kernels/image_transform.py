"""Fused physical-representation transforms of raw frames.

* ``fused_transform``: area-average resize to one resolution, the
  channel projection of one color representation, and normalization.
* ``fused_pyramid_transform``: every (resolution, color) representation of
  a list from one read of the base, levels pooled progressively along
  ``core.transforms.plan_pyramid``. On the card a chain of levels 2, 4, 8
  times smaller on aligned frames takes the strip kernel (persistent
  blocks, a bulk-copy ring, levels in registers: ``strip_plan``), any
  other plan the tile kernel (``transform_tiling``).
* ``fused_pyramid_stage0`` (the per-chunk hot path of the scan engine):
  one read of the raw base per image emits the raw pooled RGB pyramid
  levels the engine carries between cascade stages AND the stage-0
  cascade model's sigmoid scores.

Each picks by the device of ``images``: on a CPU tensor it runs the plain
version (kernels/ref.py); on a CUDA tensor it launches the hand-written
kernel (csrc/image_transform.cu, csrc/pyramid_stage0.cu) or raises; any
other device is refused. There is no fallback between the two.
"""
from __future__ import annotations

import collections
import functools
import math
import threading
import typing

import numpy as np
import torch

from repro_torch.core.transforms import _GRAY, plan_pyramid
from repro_torch.kernels import bindings
from repro_torch.kernels.ref import (fused_pyramid_stage0_ref,
                                     fused_pyramid_transform_ref,
                                     fused_transform_ref)

# A transform block's base tile stays within TILE_BYTES where the pooling
# factors allow (~28 KB of shared memory with its levels, so registers,
# not shared memory, cap the blocks on an SM); no block may take more
# than SMEM_MAX, a block's limit on an H100.
TILE_BYTES = 24 * 1024
SMEM_MAX = 227 * 1024


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


def _square(images: torch.Tensor, name: str) -> int:
    if images.dim() != 4 or images.shape[1] != images.shape[2] \
            or images.shape[3] != 3:
        raise ValueError(f"{name}: images must be (B, H, H, 3), got "
                         f"{tuple(images.shape)}")
    return int(images.shape[1])


def _on_card(images: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {images.device}")
    return images.device.type == "cuda"


def fused_transform(images: torch.Tensor, channel_weights, res: int,
                    mean: float = 0.5, std: float = 0.25) -> torch.Tensor:
    """images (B, H, H, 3) float; channel_weights (3, C') encodes the
    color representation (identity columns / unit column / gray weights;
    C' is 1 or 3 on the card). -> (B, res, res, C') float32,
    (area-average @ channel_weights - mean) / std."""
    h = _square(images, "fused_transform")
    res = int(res)
    if not 1 <= res <= h or h % res:
        raise ValueError(f"fused_transform: {res} does not divide {h}")
    if not _on_card(images, "fused_transform"):
        return fused_transform_ref(images, channel_weights, res, mean, std)
    (out,) = _launch_transform(images, [(res, channel_weights)], mean, std,
                               bindings.launch_fused_transform)
    return out


def fused_pyramid_transform(images: torch.Tensor, rep_specs,
                            mean: float = 0.5, std: float = 0.25) -> tuple:
    """images (B, H, H, 3) float -> one (B, res_i, res_i, C'_i) float32
    tensor per (res_i, channel_weights_i) of ``rep_specs``, all from a
    single read of the base on the card. Raises ValueError when a
    resolution does not nest under H (``plan_pyramid``)."""
    h = _square(images, "fused_pyramid_transform")
    specs = [(int(r), cw) for r, cw in rep_specs]
    if any(r < 1 for r, _ in specs):
        raise ValueError(f"fused_pyramid_transform: resolutions "
                         f"{[r for r, _ in specs]}")
    plan_pyramid([r for r, _ in specs], h)
    if not _on_card(images, "fused_pyramid_transform"):
        return fused_pyramid_transform_ref(images, specs, mean, std)
    return _launch_transform(images, specs, mean, std,
                             bindings.launch_fused_pyramid_transform)


def transform_tiling(h: int, steps) -> tuple[int, int, list[int], int]:
    """The tile kernel's tile for base ``h`` and pyramid ``steps``:
    (tile_h, tile_w, each step's float offset in shared memory, shared
    bytes). Both sides are multiples of every pooling factor from the base
    and divide ``h``; a strip of full rows is preferred (one contiguous
    span of the frame), as tall as TILE_BYTES allows. Raises ValueError
    when even the smallest tile exceeds SMEM_MAX."""
    unit = math.lcm(1, *(h // st.resolution for st in steps))
    sides = [unit * m for m in range(1, h // unit + 1)
             if (h // unit) % m == 0]

    def tallest(width):
        return max((s for s in sides if s * width * 12 <= TILE_BYTES),
                   default=unit)

    tile_h = tallest(h)
    tile_w = h if tile_h * h * 12 <= TILE_BYTES else tallest(unit)
    offsets, floats = [], tile_h * tile_w * 3
    for st in steps:
        f = h // st.resolution
        offsets.append(floats)
        floats += (tile_h // f) * (tile_w // f) * 3
    if floats * 4 > SMEM_MAX:
        raise ValueError(f"pooling factor {unit} under {h} needs "
                         f"{floats * 4} bytes of shared memory per block, "
                         f"above {SMEM_MAX}")
    return tile_h, tile_w, offsets, floats * 4


def _launch_transform(images, specs, mean, std, launch) -> tuple:
    images = images.to(torch.float32).contiguous()
    prm, outs = transform_params(images, specs, mean, std)
    if prm is not None:
        launch(prm)
    return outs


# The strip kernel (csrc/image_transform.cu, fused_pyramid_strip_kernel):
# base rows a strip, and the most ring slots it takes (MAX_RING there).
STRIP_ROWS = 16
STRIP_MAX_RING = 4
STRIP_STATIC_SMEM = 1024  # its static shared memory (write plan, barriers)


class StripPlan(typing.NamedTuple):
    chain: int          # ps0_chain's mask of the levels
    ring: int           # slots of STRIP_ROWS base rows
    tile_row: int       # floats a slot row: 3 h, padded by 4
    lv_stride: int      # floats a level buffer (the kernel keeps two)
    smem: int           # shared bytes a block


def strip_plan(h: int, steps, aligned: bool = True) -> StripPlan | None:
    """The strip kernel's plan for base ``h`` and pyramid ``steps``, or
    None for the tile kernel. Strips need a chain of levels 2, 4 and 8
    times smaller than the base (``ps0_chain``: the query path's {112, 56,
    28} and {112, 28} at 224 px), a base that is a multiple of STRIP_ROWS
    (every level's part of a strip is whole rows, every row 16-byte
    aligned), ``aligned`` frames (16-byte bulk copies) and at least two
    ring slots within SMEM_MAX. A slot holds STRIP_ROWS base rows, each
    padded by 4 floats, so that 16-byte reads of neighbouring rows fall in
    other banks; a level buffer holds every level's part of one strip,
    unpadded, in the plan's order."""
    if not aligned or h % STRIP_ROWS or not steps:
        return None
    chain = ps0_chain(h, steps)
    if not chain:
        return None
    lv = sum(STRIP_ROWS // (h // st.resolution) * st.resolution * 3
             for st in steps)
    row = 3 * h + 4
    for ring in range(STRIP_MAX_RING, 1, -1):
        smem = 4 * (ring * STRIP_ROWS * row + 2 * lv)
        if smem + STRIP_STATIC_SMEM <= SMEM_MAX:
            return StripPlan(chain, ring, row, lv, smem)
    return None


def strip_grid(b: int, h: int, sms: int) -> int:
    """Persistent blocks of the strip kernel: one an SM, at most one a
    work item."""
    return max(1, min(b * (h // STRIP_ROWS), sms))


def strip_work(b: int, h: int, grid: int) -> list[list[tuple[int, int]]]:
    """Each strip block's work items in its order, as (image, first base
    row): block k takes items k, k + grid, ..., and item i is strip
    i % (h / STRIP_ROWS) of image i // (h / STRIP_ROWS)."""
    strips = h // STRIP_ROWS
    return [[(i // strips, i % strips * STRIP_ROWS)
             for i in range(k, b * strips, grid)] for k in range(grid)]


def output_kind(cw: np.ndarray) -> int:
    """How the kernel projects with the (3, C) matrix ``cw`` (out_kind in
    csrc/image_transform.cu): 1 the identity (a copy), 2 + k the unit
    column k (a select), else 0 (three products a value). A copy or a
    select gives the bits of r 1 + g 0 + b 0 on finite pixels."""
    if cw.shape == (3, 3) and np.array_equal(cw, np.eye(3)):
        return 1
    if cw.shape == (3, 1) and sorted(cw[:, 0].tolist()) == [0.0, 0.0, 1.0]:
        return 2 + int(np.argmax(cw[:, 0]))
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def transform_params(images: torch.Tensor, specs, mean: float = 0.5,
                     std: float = 0.25):
    """The transform kernels' launch parameters for contiguous float32
    (B, H, H, 3) CUDA ``images`` and (res, channel_weights) ``specs``, and
    the outputs they point at: (ITParams, outputs), or (None, outputs)
    when there is nothing to launch. They hold the tile kernel's plan
    (``transform_tiling``) and, for a chain on aligned frames, the strip
    kernel's (``strip_plan``), which fused_pyramid_transform's launch then
    takes. The caller keeps ``images`` and the outputs alive while a launch
    with the parameters may run."""
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("transform_params: images must be contiguous "
                         "float32")
    b, h = int(images.shape[0]), int(images.shape[1])
    key = []
    for r, cw in specs:
        cw = np.asarray(cw.detach().cpu() if torch.is_tensor(cw) else cw,
                        np.float32)
        key.append((int(r), cw.shape, cw.tobytes()))
    dev = images.device
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    template, shapes = param_template(b, h, tuple(key), float(mean),
                                      float(std), images.data_ptr() % 16 == 0,
                                      sms)
    # torch.empty on the card starts every output 512-byte aligned
    outs = tuple(torch.empty(s, device=dev) for s in shapes)
    if template is None:
        return None, outs
    prm = bindings.ITParams.from_buffer_copy(template)
    prm.img = images.data_ptr()
    for o, out in enumerate(outs):
        prm.out[o] = out.data_ptr()
    return prm, outs


@functools.lru_cache(maxsize=64)
def param_template(b: int, h: int, specs: tuple, mean: float, std: float,
                   aligned: bool, sms: int):
    """ITParams, as bytes, with every field but the image and output
    pointers, for ``b`` frames of ``h`` px (16-byte ``aligned`` or not) on
    a card of ``sms`` SMs and ``specs`` ((res, shape, float32 bytes of the
    channel weights), ...); and the outputs' shapes. (None, shapes) when
    there is nothing to launch. Built once per such key."""
    cws = []
    for _, shape, buf in specs:
        if len(shape) != 2 or shape[0] != 3 or shape[1] not in (1, 3):
            raise ValueError(f"channel weights must be (3, 1) or (3, 3) on "
                             f"the card, got {shape}")
        cws.append(np.frombuffer(buf, np.float32).reshape(shape))
    if len(specs) > bindings.IT_MAX_OUTPUTS:
        raise ValueError(f"at most {bindings.IT_MAX_OUTPUTS} outputs")
    steps = plan_pyramid([r for r, _, _ in specs], h)
    if len(steps) > bindings.IT_MAX_LEVELS:
        raise ValueError(f"at most {bindings.IT_MAX_LEVELS} pyramid levels")
    tile_h, tile_w, offsets, smem = transform_tiling(h, steps)
    if b * (h // tile_h) * (h // tile_w) >= 2 ** 31:
        raise ValueError(f"{b} images of {h} px exceed one launch's grid")
    shapes = tuple((b, r, r, cw.shape[1]) for (r, _, _), cw in zip(specs,
                                                                  cws))
    if not b or not shapes:
        return None, shapes
    level = {st.resolution: i for i, st in enumerate(steps)}
    prm = bindings.ITParams()
    prm.B, prm.H, prm.tile_h, prm.tile_w = b, h, tile_h, tile_w
    prm.vec4 = int(h % 4 == 0 and tile_w % 4 == 0 and aligned)
    prm.smem_bytes = smem
    plan = strip_plan(h, steps, aligned)
    if plan is not None:
        prm.chain, prm.ring, prm.tile_row = plan.chain, plan.ring, \
            plan.tile_row
        prm.lv_stride, prm.grid = plan.lv_stride, strip_grid(b, h, sms)
    prm.n_levels = len(steps)
    for i, st in enumerate(steps):
        prm.level_res[i] = st.resolution
        prm.level_src[i] = -1 if st.source == h else level[st.source]
        prm.level_off[i] = offsets[i]
    prm.n_out = len(specs)
    for o, ((r, _, _), cw) in enumerate(zip(specs, cws)):
        prm.out_level[o] = -1 if r == h else level[r]
        prm.out_ch[o] = cw.shape[1]
        prm.out_kind[o] = output_kind(cw)
        for k, v in enumerate(cw.reshape(-1)):
            prm.out_cw[9 * o + k] = float(v)
    prm.mean, prm.inv_std = mean, 1.0 / std
    return bytes(prm), shapes


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
    """([(w, b, scale)] per conv layer, then dense, then out, copied:
    whether any operand is a copy of the caller's tensor). scale is 1.0 on
    the f32 path."""
    src = qparams if qparams is not None else params
    copied = []

    def f32(t):
        out = t.to(torch.float32).contiguous()
        copied.append(out is not t)
        return out

    def w(t):
        if qparams is None:
            return _aligned(f32(t), copied), 1.0
        return _aligned(t["q"].contiguous(), copied), float(t["scale"])

    out = [(*w(l["w"]), f32(l["b"])) for l in src["conv"]]
    out.append((*w(src["dense_w"]), f32(src["dense_b"])))
    out.append((*w(src["out_w"]), f32(src["out_b"])))
    return out, any(copied)


def _aligned(t: torch.Tensor, copied: list) -> torch.Tensor:
    """The kernel reads conv weights 16 bytes at a time: a view that does
    not start on a 16-byte boundary is copied to one that does."""
    copied.append(t.data_ptr() % 16 != 0)
    return t if not copied[-1] else t.clone()


# The launch setup of recent (weights, shapes): everything but the chunk's
# own tensors. An entry holds the caller's weight dicts, so their ids stay
# theirs, and is used only while the dicts still hold the same tensors; it
# is kept only when the kernel reads the caller's weight tensors themselves
# (no dtype or alignment copy), so that weights changed in place are read
# as they are. An int8 scale is read once per entry.
_SETUP_CACHE: collections.OrderedDict = collections.OrderedDict()
_SETUP_CACHE_SIZE = 64
_SETUP_LOCK = threading.Lock()


class _Setup(typing.NamedTuple):
    params: object
    qparams: object
    leaves: list        # the weight dicts' tensors when it was built
    steps: list
    prm: bytes          # PS0Params with every field but the chunk's tensors
    need: int           # floats per scratch buffer per image
    part: int           # floats of split-K partial sums
    operands: list      # the weight tensors the kernel reads


def _setup(images, out_res, params, rep, qparams) -> _Setup:
    b, h = int(images.shape[0]), int(images.shape[1])
    key = (id(params), id(qparams), b, h, tuple(out_res),
           int(rep.resolution), rep.color, images.device)
    leaves = _weight_leaves(params, qparams)
    with _SETUP_LOCK:
        hit = _SETUP_CACHE.get(key)
        if hit is not None and hit.params is params \
                and hit.qparams is qparams and len(hit.leaves) == len(leaves) \
                and all(a is b for a, b in zip(hit.leaves, leaves)):
            _SETUP_CACHE.move_to_end(key)
            return hit
    setup, copied = _build_setup(images, out_res, params, rep, qparams)
    if not copied:
        with _SETUP_LOCK:
            _SETUP_CACHE[key] = setup
            if len(_SETUP_CACHE) > _SETUP_CACHE_SIZE:
                _SETUP_CACHE.popitem(last=False)
    return setup


def _weight_leaves(params, qparams) -> list:
    """The tensors (and int8 scales) of the weight dicts, in one order."""
    src = qparams if qparams is not None else params

    def w(t):
        return [t["q"], t["scale"]] if qparams is not None else [t]

    out = [x for l in src["conv"] for x in (*w(l["w"]), l["b"])]
    return out + [*w(src["dense_w"]), src["dense_b"], *w(src["out_w"]),
                  src["out_b"]]


def _build_setup(images, out_res, params, rep, qparams):
    dev = images.device
    b, h = int(images.shape[0]), int(images.shape[1])
    s0_res = int(rep.resolution)
    steps = plan_pyramid(set(out_res) | {s0_res}, h)
    if len(steps) > bindings.MAX_STEPS:
        raise ValueError(f"at most {bindings.MAX_STEPS} pyramid steps")
    weights, copied = _weight_operands(params, qparams)
    *conv, (dense_w, dense_s, dense_b), (out_w, out_s, out_b) = weights
    if len(conv) > bindings.MAX_CONV:
        raise ValueError(f"at most {bindings.MAX_CONV} conv layers")
    cw = color_weight_matrix(rep.color)
    c = cw.shape[1]
    dense_n = dense_w.shape[1]

    # scratch: two ping-pong activation buffers per image, each large
    # enough for the projected input and for every pooled conv output
    hw, need, cin = s0_res, s0_res * s0_res * c, c
    staged = True     # every layer's input and weights fit PS0_CNN_STAGE
    for w, _, _ in conv:
        if w.shape[:3] != (3, 3, cin):
            raise ValueError(f"conv weight {tuple(w.shape)} is not 3x3x{cin}")
        staged &= (-(-hw * hw * cin // 4) * 4 + 9 * cin * w.shape[3]
                   <= bindings.PS0_CNN_STAGE)
        cin = w.shape[3]
        hw //= 2
        need = max(need, hw * hw * cin)
    flat = hw * hw * cin
    need = -(-need // 4) * 4     # rows of the scratch start 16-byte aligned
    if dense_w.shape[0] != flat:
        raise ValueError("dense_w rows do not match the flattened conv "
                         "output")
    operands = [dense_w, dense_b, out_w, out_b] + [x for l in conv
                                                   for x in (l[0], l[2])]
    if any(t.device != dev for t in operands):
        raise ValueError("stage-0 weights must lie on the images' device")
    tiling = ps0_tiling(h, steps)
    split, k_chunk = bindings.ps0_dense_plan(b, flat, dense_n)
    index = {st.resolution: i for i, st in enumerate(steps)}

    prm = bindings.PS0Params()
    prm.scratch_stride = need
    prm.B, prm.H, prm.n_steps = b, h, len(steps)
    for i, st in enumerate(steps):
        prm.step_res[i] = st.resolution
        prm.step_src[i] = -1 if st.source == h else index[st.source]
    (prm.tile_h, prm.tile_w, prm.tile_row, prm.tile_stride, offsets,
     prm.smem_bytes, prm.chain) = tiling
    for i, off in enumerate(offsets):
        prm.level_off[i] = off
    prm.grid = min(b, bindings.SMS)    # one pooling block an SM
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
    prm.flat, prm.flat_buf = flat, len(conv) % 2
    prm.dense_vec4 = int(need % 4 == 0 and flat % 4 == 0
                         and dense_n % 4 == 0
                         and dense_w.data_ptr() % 16 == 0)
    prm.cnn_stage = bindings.PS0_CNN_STAGE if conv and staged else 0
    prm.dense_split, prm.dense_k_chunk = split, k_chunk
    prm.dense_w, prm.dense_b, prm.dense_n = (dense_w.data_ptr(),
                                             dense_b.data_ptr(), dense_n)
    prm.out_w, prm.out_b = out_w.data_ptr(), out_b.data_ptr()
    prm.dense_scale, prm.out_scale = dense_s, out_s
    return _Setup(params, qparams, _weight_leaves(params, qparams), steps,
                  bytes(prm), need,
                  split * b * dense_n, operands), copied


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
    st = _setup(images, out_res, params, rep, qparams)
    prm = bindings.PS0Params.from_buffer_copy(st.prm)
    levels = {s.resolution: torch.empty((b, s.resolution, s.resolution, 3),
                                        device=dev) for s in st.steps}
    scores = torch.empty(b, device=dev)
    work = torch.empty(b * 2 * st.need + st.part, device=dev)
    prm.img = images.data_ptr()
    prm.vec4 = int(h % 4 == 0 and prm.tile_w % 4 == 0
                   and images.data_ptr() % 16 == 0)
    prm.scores = scores.data_ptr()
    prm.scratch = work.data_ptr()
    prm.part = work.data_ptr() + 4 * b * 2 * st.need
    for i, s in enumerate(st.steps):
        prm.step_out[i] = levels[s.resolution].data_ptr()
    bindings.launch_pyramid_stage0(prm, int8_weights=qparams is not None)
    # the caching allocator may hand `work` (and dropped operand copies) to
    # later work queued on this same stream only, so freeing them here is
    # safe without a synchronize
    return {r: images if r == h else levels[r] for r in out_res}, scores


def ps0_tiling(h: int, steps):
    """The stage-0 pooling kernel's tiling for base ``h`` and pyramid
    ``steps``: (tile_h, tile_w, floats per tile row in shared memory,
    floats per ring slot, each step's float offset after the ring, shared
    bytes, chain). A chain of levels 2, 4, 8 times smaller than the base
    (``ps0_chain``) is pooled in registers from strips of 16 full rows;
    any other plan in shared memory, level by level, from
    ``transform_tiling``'s tile, its levels' parts after the ring (offsets
    multiples of 4). Rows are padded by 4 floats, so they start 16 bytes
    apart and 16-byte reads of neighbouring rows fall in other banks.
    Raises ValueError above SMEM_MAX."""
    chain = ps0_chain(h, steps) if h % 16 == 0 else 0
    offsets, floats = [0] * len(steps), 0
    if chain:
        tile_h, tile_w = 16, h
    else:
        tile_h, tile_w, _, _ = transform_tiling(h, steps)
        for i, st in enumerate(steps):
            f = h // st.resolution
            offsets[i] = floats
            floats += -(-(tile_h // f) * (tile_w // f) * 3 // 4) * 4
    row = -(-tile_w * 3 // 4) * 4 + 4
    smem = 4 * (bindings.PS0_RING * tile_h * row + floats)
    if smem > SMEM_MAX:
        raise ValueError(f"a {tile_h} x {tile_w} tile needs {smem} bytes of "
                         f"shared memory per stage-0 block, above "
                         f"{SMEM_MAX}")
    return tile_h, tile_w, row, tile_h * row, offsets, smem, chain


def ps0_chain(h: int, steps) -> int:
    """A bit per level 2, 4 or 8 times smaller than the base ``h`` (bits
    0, 1, 2) when the pyramid ``steps`` form such a chain, each level
    pooled from the one before and the first from the base; else 0."""
    mask, prev = 0, h
    for st in steps:
        f = h // st.resolution
        if st.source != prev or f not in (2, 4, 8):
            return 0
        mask |= {2: 1, 4: 2, 8: 4}[f]
        prev = st.resolution
    return mask
