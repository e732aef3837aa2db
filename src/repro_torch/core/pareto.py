"""Pareto frontier (skyline) over (accuracy, throughput) — paper §V-E.

O(n log n) Kung/Luccio/Preparata sweep for two maximization criteria:
sort by accuracy descending (throughput descending tie-break) and keep
points whose throughput strictly exceeds the best seen so far; a point
dominates another iff >= on both attributes and > on at least one.
"""
from __future__ import annotations

import numpy as np


def pareto_indices(acc, thr) -> np.ndarray:
    """Indices of the non-dominated points, sorted by accuracy desc."""
    acc = np.asarray(acc, np.float64)
    thr = np.asarray(thr, np.float64)
    order = np.lexsort((-thr, -acc))        # acc desc, thr desc
    keep = []
    best_thr = -np.inf
    prev_acc = None
    for i in order:
        if thr[i] > best_thr:
            # equal-accuracy group: only the first (max-thr) survives, and
            # equal (acc,thr) duplicates collapse to one representative.
            if prev_acc is not None and acc[i] == prev_acc and keep and \
                    thr[keep[-1]] >= thr[i]:
                continue
            keep.append(i)
            best_thr = thr[i]
        prev_acc = acc[i]
    return np.asarray(keep, np.int64)


def dominates(a, b) -> bool:
    """a, b = (accuracy, throughput)."""
    return a[0] >= b[0] and a[1] >= b[1] and (a[0] > b[0] or a[1] > b[1])


def is_frontier(acc, thr, idx) -> bool:
    pts = list(zip(np.asarray(acc), np.asarray(thr)))
    p = pts[idx]
    return not any(dominates(q, p) for j, q in enumerate(pts) if j != idx)
