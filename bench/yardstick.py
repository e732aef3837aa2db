"""The benchmark's own arithmetic: peaks, the work a scan needs, and the
statistics its metrics are made of.

Everything here is computed from shapes and from the configuration, never
from the program, so a change to the program cannot move the count:

* ``PEAKS``: published NVIDIA H100 figures (data sheet, dense rates, no
  sparsity, at the part's full power limit);
* ``cnn_flops``: forward FLOPs of one image through a TAHOMA CNN
  (paper Fig. 3: [conv 3x3 -> ReLU -> maxpool 2x2] x L -> dense -> out);
* ``stage0_work``: bytes and f32 operations one chunk's pyramid and
  stage-0 model need, each input byte read once and each output byte
  written once;
* ``percentile``, ``busy_union``: the statistics.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple


class Peaks(NamedTuple):
    part: str
    hbm_bw: float        # B/s
    f32_flops: float     # FLOP/s, f32 FFMA outside the tensor cores
    bf16_flops: float    # FLOP/s, dense bf16 tensor cores


# the most specific part name first: "H100 PCIe" before "H100"
PEAKS = (Peaks("H100 PCIe", 2.0e12, 51e12, 756e12),
         Peaks("H100 NVL", 3.9e12, 60e12, 835e12),
         Peaks("H100", 3.35e12, 67e12, 989e12))


def peaks(device_name: str) -> Peaks | None:
    """The row of the part ``device_name`` names, or None for a device
    the table does not name: no share is taken against a guessed peak."""
    for row in PEAKS:
        if row.part in device_name:
            return row
    return None


F32 = 4              # bytes per float32 value


def cnn_flops(arch, res: int, channels: int, kernel: int = 3) -> float:
    """Forward FLOPs per image of ``arch`` = (conv layers, conv width,
    dense width) on a ``res`` x ``res`` x ``channels`` input: a
    multiply-add counts two, 'same' convolutions, floor 2x2 pooling."""
    n_conv, conv_nodes, dense_nodes = arch
    total, hw, c_in = 0.0, res, channels
    for _ in range(n_conv):
        total += 2.0 * hw * hw * kernel * kernel * c_in * conv_nodes
        c_in = conv_nodes
        hw //= 2
    flat = hw * hw * c_in
    return total + 2.0 * flat * dense_nodes + 2.0 * dense_nodes


def cnn_weight_count(arch, res: int, channels: int, kernel: int = 3) -> int:
    """Number of f32 weights and biases of ``arch``."""
    n_conv, conv_nodes, dense_nodes = arch
    total, hw, c_in = 0, res, channels
    for _ in range(n_conv):
        total += kernel * kernel * c_in * conv_nodes + conv_nodes
        c_in = conv_nodes
        hw //= 2
    flat = hw * hw * c_in
    return total + flat * dense_nodes + dense_nodes + dense_nodes + 1


def pyramid_steps(resolutions: Iterable[int], base: int) -> list:
    """[(resolution, source)] of a progressive box-filter pyramid: each
    level pooled from the smallest level already made that it divides."""
    steps, avail = [], [base]
    for r in sorted({int(r) for r in resolutions}, reverse=True):
        if r == base:
            continue
        src = min(a for a in avail if a > r and a % r == 0)
        steps.append((r, src))
        avail.append(r)
    return steps


def channels(color: str) -> int:
    return 3 if color == "rgb" else 1


def stage0_work(b: int, base: int, out_res: Iterable[int], level0) -> tuple:
    """(bytes, f32 operations) one chunk of ``b`` frames needs to pool its
    pyramid and score the first cascade's level-0 model ``level0`` =
    (arch, res, color): the frames, the weights and the scores read or
    written once, each pooled level in ``out_res`` written once; one add
    per pooled source value, five operations per projected pixel, the
    CNN's FLOPs."""
    arch, res, color = level0
    out_res = [int(r) for r in out_res]
    nbytes = (b * base * base * 3 * F32
              + cnn_weight_count(arch, res, channels(color)) * F32
              + b * F32
              + sum(b * r * r * 3 * F32 for r in out_res))
    steps = pyramid_steps(set(out_res) | {res}, base)
    ops = b * (sum(src * src * 3 for _, src in steps) + 5 * res * res
               + cnn_flops(arch, res, channels(color)))
    return nbytes, ops


def bound_s(nbytes: float, ops: float, pk: Peaks) -> float:
    """Least time for the work: the larger of bytes over HBM bandwidth and
    f32 operations over the FFMA peak."""
    return max(nbytes / pk.hbm_bw, ops / pk.f32_flops)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks (numpy's default)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def busy_union(spans, lo=None, hi=None) -> float:
    """Length of the union of intervals ``[(start, end), ...]``, each
    clipped to ``[lo, hi]`` where given."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        total += max(0.0, e - max(s, end))
        end = max(end, e)
    return total
