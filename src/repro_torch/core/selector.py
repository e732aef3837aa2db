"""Query-time cascade selection (paper Fig. 2 'cascade selector').

Because per-model inference on the eval split is cached, selection —
including re-costing every cascade under the CURRENT deployment scenario —
is cheap enough to run inside query planning (paper §V-E)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.cascade import CascadeSpace, spec_levels
from repro_torch.core.pareto import pareto_indices


@dataclass
class Selection:
    index: int
    accuracy: float
    throughput: float


def pareto_set(space: CascadeSpace) -> np.ndarray:
    return pareto_indices(space.acc, space.throughput)


def select(space: CascadeSpace, *, min_accuracy: float | None = None,
           min_throughput: float | None = None) -> Selection:
    """Pick from the Pareto set: with a min_accuracy constraint return the
    fastest qualifying cascade; with min_throughput the most accurate
    qualifying one; with neither, the most accurate overall. Implemented
    as a pick from ``select_candidates`` (the pool is fastest-first and
    the frontier is strictly ordered, so the ends are exactly those two
    rules) — the joint planner's never-worse guarantee depends on this
    pick being a MEMBER of the candidate pool, which is now true by
    construction."""
    pool = select_candidates(space, min_accuracy=min_accuracy,
                             min_throughput=min_throughput)
    return pool[0] if min_accuracy is not None else pool[-1]


def select_candidates(space: CascadeSpace, *,
                      min_accuracy: float | None = None,
                      min_throughput: float | None = None
                      ) -> list[Selection]:
    """EVERY Pareto-frontier cascade satisfying the clause constraints,
    fastest-first — the joint planner's per-predicate candidate pool
    (engine/planner.plan_query joint=True). ``select`` picks one element
    of this pool (the independent rule); joint selection searches the
    product of pools instead, so the independent pick is always a member
    and the joint plan can never be priced worse."""
    idx = pareto_set(space)
    acc = space.acc[idx]
    thr = space.throughput[idx]
    mask = np.ones(len(idx), bool)
    if min_accuracy is not None:
        mask &= acc >= min_accuracy
    if min_throughput is not None:
        mask &= thr >= min_throughput
    if not mask.any():
        raise ValueError("no cascade satisfies the constraints")
    cand = idx[np.where(mask)[0]]
    cand = cand[np.argsort(space.time_s[cand], kind="stable")]
    return [Selection(int(i), float(space.acc[i]),
                      float(space.throughput[i])) for i in cand]


def degradation_ladder(space: CascadeSpace, primary_index: int, *,
                       min_accuracy: float | None = None,
                       max_rungs: int | None = None) -> list[Selection]:
    """The overload degradation ladder for a selected cascade: every
    Pareto-frontier cascade STRICTLY CHEAPER than the primary, ordered
    nearest-cost-first (gentlest accuracy sacrifice first), optionally
    floored at ``min_accuracy`` and truncated to ``max_rungs``. The
    serving layer (serve/service.py) steps down this list under load
    and back up on recovery. The primary itself is never in the ladder;
    an empty list means the primary is already the cheapest qualifying
    frontier point (nothing to degrade to)."""
    idx = pareto_set(space)
    t0 = float(space.time_s[primary_index])
    rungs = [int(i) for i in idx
             if float(space.time_s[i]) < t0 and int(i) != int(primary_index)]
    if min_accuracy is not None:
        rungs = [i for i in rungs if space.acc[i] >= min_accuracy]
    rungs.sort(key=lambda i: -float(space.time_s[i]))
    if max_rungs is not None:
        rungs = rungs[:max_rungs]
    return [Selection(i, float(space.acc[i]), float(space.throughput[i]))
            for i in rungs]


# --------------------------------------------- planner-facing estimates ----
def cascade_eval_labels(space: CascadeSpace, i: int, scores_eval,
                        p_low, p_high) -> np.ndarray:
    """Labels cascade ``i`` would emit on the eval split, simulated from
    the cached score matrix (paper §V-D: no inference needed). Vectorized
    per-level walk with the exact Def. 7 semantics."""
    levels = spec_levels(space, i, p_low, p_high)
    s = np.asarray(scores_eval)
    n = s.shape[1]
    labels = np.zeros(n, np.int32)
    active = np.ones(n, bool)
    for m, lo, hi in levels:
        o = s[m]
        if lo is None:
            labels[active] = (o >= 0.5)[active]
            active[:] = False
            break
        dec = active & ((o <= lo) | (o >= hi))
        labels[dec] = (o >= hi)[dec]
        active &= ~dec
    return labels


def estimate_selectivity(space: CascadeSpace, i: int, scores_eval,
                         p_low, p_high) -> float:
    """Estimated P(predicate true) = positive fraction the cascade labels
    on the eval split — the statistic the query planner orders binary
    predicates by (selectivity x per-row cost)."""
    return float(cascade_eval_labels(space, i, scores_eval,
                                     p_low, p_high).mean())
