"""ALC — area to the left of the (throughput vs accuracy) step curve
(paper §VII-A4). Dividing ALC by the accuracy range gives the average
frontier throughput; the ratio of two ALCs over the SAME range is the
speedup of one cascade set over another. Plain numpy: a copy of the
reference's module, pinned equal to it by tests/test_torch_oracles.py."""
from __future__ import annotations

import numpy as np

from repro_torch.core.pareto import pareto_indices


def alc(acc, thr, lo: float, hi: float) -> float:
    """Step-interpolated area of max-throughput-at-accuracy>=a over
    [lo, hi]. Points form a step function: at accuracy a the attainable
    throughput is max{thr_i : acc_i >= a}; cascades below lo are ignored."""
    acc = np.asarray(acc, np.float64)
    thr = np.asarray(thr, np.float64)
    if len(acc) == 0 or hi <= lo:
        return 0.0
    idx = pareto_indices(acc, thr)          # acc desc, thr asc
    a_desc = acc[idx]
    t_desc = thr[idx]
    area = 0.0
    prev = lo
    # walk accuracy ascending: throughput is a non-increasing step in acc
    for a, t in zip(a_desc[::-1], t_desc[::-1]):
        if a <= prev:
            continue
        seg_hi = min(a, hi)
        if seg_hi > prev:
            area += (seg_hi - prev) * t
            prev = seg_hi
        if prev >= hi:
            break
    return area


def average_throughput(acc, thr, lo: float, hi: float) -> float:
    return alc(acc, thr, lo, hi) / (hi - lo) if hi > lo else 0.0


def speedup(acc_a, thr_a, acc_b, thr_b, lo=None, hi=None) -> float:
    """ALC(A)/ALC(B) over the smaller shared accuracy range
    (paper: 'choose the smallest said range')."""
    lo = max(np.min(acc_a), np.min(acc_b)) if lo is None else lo
    hi = min(np.max(acc_a), np.max(acc_b)) if hi is None else hi
    denom = alc(acc_b, thr_b, lo, hi)
    return alc(acc_a, thr_a, lo, hi) / denom if denom else float("inf")


def best_matching(acc, thr, target_acc: float):
    """Paper §VII-A4: vs a single classifier, pick the optimal cascade whose
    accuracy is higher than and closest to the target. Returns index or
    None."""
    acc = np.asarray(acc)
    ok = np.where(acc >= target_acc)[0]
    if len(ok) == 0:
        return None
    thr = np.asarray(thr)
    # among qualifying, frontier point with max throughput
    return int(ok[np.argmax(thr[ok])])
