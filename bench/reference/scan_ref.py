"""Plain PyTorch reference of a multi-predicate scan's answer.

What the scan must return: the ids of the rows that pass the metadata
filter and that every predicate's cascade labels 1. A cascade labels one
row at a time: level 0 scores the row; a score at or below the level's low
threshold decides 0, at or above its high threshold decides 1; any other
row goes on to the next level; the last level decides by score >= 0.5.
Scores are sigmoids of the CNN's logit, compared with f32 thresholds.

Frozen copies of what the answer depends on, written from the paper's
definitions and imported from nowhere: area (box-filter) pooling, the
colour projections, and the CNN forward pass (paper Fig. 3: [conv 3x3
'same' -> ReLU -> maxpool 2x2 floor] x L -> flatten (NHWC) -> dense ReLU ->
one logit). Weights are dicts in HWIO layout: ``{"conv": [{"w", "b"}],
"dense_w", "dense_b", "out_w", "out_b"}``.

``precision``: "f32" computes every product in float32 with TF32 off;
"tf32" is the control, the same arithmetic with every operand of a
convolution and a matrix product rounded to TF32's 10-bit mantissa and
TF32 switched on, the lower precision a faster path would be tempted by.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

GRAY = (0.299, 0.587, 0.114)


def area_pool(x: torch.Tensor, res: int) -> torch.Tensor:
    """(B, H, H, C) -> (B, res, res, C), each output the mean of its
    (H/res)^2 input block."""
    b, h, w, c = x.shape
    if h == res:
        return x
    f = h // res
    return x.reshape(b, res, f, res, f, c).mean(dim=(2, 4))


def project(x: torch.Tensor, color: str) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, C) for color rgb, r, g, b or gray."""
    if color == "rgb":
        return x
    if color == "gray":
        w = torch.tensor(GRAY, dtype=x.dtype, device=x.device)
        return (x * w).sum(-1, keepdim=True)
    i = "rgb".index(color)
    return x[..., i:i + 1]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10 mantissa
    bits."""
    bits = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def precision_mode(precision: str):
    """TF32 on for "tf32", off for "f32", restored on exit."""
    if precision not in ("f32", "tf32"):
        raise ValueError(f"precision {precision!r}")
    on = precision == "tf32"
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cnn_logits(params: dict, x: torch.Tensor,
               precision: str = "f32") -> torch.Tensor:
    """x (B, H, W, C) float32 -> logits (B,)."""
    rnd = to_tf32 if precision == "tf32" else (lambda t: t)
    h = x.permute(0, 3, 1, 2)
    for layer in params["conv"]:
        w = layer["w"].permute(3, 2, 0, 1)
        h = F.conv2d(rnd(h), rnd(w), padding="same")
        h = torch.relu(h + layer["b"][None, :, None, None])
        h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(rnd(h) @ rnd(params["dense_w"]) + params["dense_b"])
    return (rnd(h) @ rnd(params["out_w"]) + params["out_b"])[:, 0]


def level_scores(corpus: torch.Tensor, rows: np.ndarray, level: dict,
                 precision: str = "f32", block: int = 512) -> torch.Tensor:
    """Scores (len(rows),) of one cascade level ``{"params", "res",
    "color"}`` on ``corpus[rows]``, ``block`` rows at a time."""
    out = []
    with precision_mode(precision):
        for lo in range(0, len(rows), block):
            idx = torch.as_tensor(rows[lo:lo + block], device=corpus.device)
            x = project(area_pool(corpus[idx], level["res"]), level["color"])
            out.append(torch.sigmoid(cnn_logits(level["params"], x,
                                                precision)))
    if not out:
        return torch.empty(0, device=corpus.device)
    return torch.cat(out)


def f32(x: float) -> float:
    return float(np.float32(x))


def cascade_labels(corpus, rows: np.ndarray, levels: list, thresholds: list,
                   precision: str = "f32", block: int = 512):
    """(labels int8 (len(rows),), rows reaching each level, each row's
    least distance of a deciding score from its level's threshold).
    ``thresholds[l]`` is (low, high); the last level's is (None, None)."""
    rows = np.asarray(rows, np.int64)
    labels = np.zeros(len(rows), np.int8)
    margin = np.full(len(rows), np.inf)
    active = np.arange(len(rows))
    reach = []
    for lvl, (level, (lo, hi)) in enumerate(zip(levels, thresholds)):
        reach.append(len(active))
        if not len(active):
            continue
        s = level_scores(corpus, rows[active], level, precision,
                         block).cpu().numpy()
        last = lo is None
        ts = [0.5] if last else [f32(lo), f32(hi)]
        margin[active] = np.minimum(
            margin[active], np.min([np.abs(s - t) for t in ts], axis=0))
        if last:
            labels[active] = s >= np.float32(0.5)
            break
        labels[active] = s >= np.float32(f32(hi))
        undecided = (s > np.float32(f32(lo))) & (s < np.float32(f32(hi)))
        active = active[undecided]
    return labels, reach, margin


def scan_answer(corpus, rows: np.ndarray, cascades: list,
                precision: str = "f32", block: int = 512):
    """The scan's answer over ``rows`` (the metadata filter's): (sorted
    ids every cascade labels 1, [rows reaching each level] per cascade,
    each cascade's margins by row id). Cascades run in the given order on
    the rows every earlier one labelled 1; the answer is their AND
    whatever the order."""
    alive = np.asarray(rows, np.int64)
    reach, margins = [], {}
    for casc in cascades:
        labels, r, m = cascade_labels(corpus, alive, casc["levels"],
                                      casc["thresholds"], precision, block)
        reach.append(r)
        margins.update({int(i): min(margins.get(int(i), np.inf), float(v))
                        for i, v in zip(alive, m)})
        alive = alive[labels == 1]
    return np.sort(alive), reach, margins
