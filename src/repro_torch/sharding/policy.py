"""Corpus row sharding (scan engine, DESIGN.md §9), numpy only.

``ShardPlan`` / ``plan_shards`` partition a scan's metadata-survivor row
set across shard executors. Range partitioning splits the (sorted) id
list into contiguous runs balanced by a per-row weight — skew-aware when
the caller supplies the planner's expected per-row evaluation cost — and
hash partitioning assigns each row id a stable pseudo-random shard so a
row keeps its shard (and its shard-side caches) across queries. Both are
exact partitions: every row lands in exactly one shard. ``shard_route``
routes single rows the way a hash plan does.

The parameter half of the reference module (mesh axes, param specs)
belongs to the training and launch substrate and is not here.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SHARD_STRATEGIES = ("range", "hash")


@dataclass(frozen=True)
class ShardPlan:
    """An exact partition of a scan's surviving row ids across shards.

    ``shards[i]`` is the i-th shard's row-id array (sorted ascending,
    possibly empty); the arrays are disjoint and their union is exactly
    the planned id set. ``weights[i]`` is the shard's total estimated
    evaluation cost under the weighting used to build the plan (row
    counts when the caller gave no weights)."""
    n_shards: int
    strategy: str
    shards: tuple
    weights: tuple

    @property
    def sizes(self) -> list[int]:
        return [len(s) for s in self.shards]

    @property
    def n_rows(self) -> int:
        return sum(self.sizes)

    @property
    def balance(self) -> float:
        """max/mean shard weight over non-degenerate plans; 1.0 is a
        perfectly even split, higher means skew."""
        mean = sum(self.weights) / max(self.n_shards, 1)
        return max(self.weights) / mean if mean > 0 else 1.0

    def all_rows(self) -> np.ndarray:
        """The planned id set, sorted (partition invariant: equals the
        ids the plan was built from)."""
        parts = [s for s in self.shards if len(s)]
        if not parts:
            return np.empty(0, np.int64)
        return np.sort(np.concatenate(parts))

    def validate(self, ids=None) -> None:
        """Check the partition invariants (cheap; guards caller-supplied
        plans in ShardedScanEngine.execute). Raises ValueError — not
        assert, which python -O strips — because a bad plan silently
        returns a wrong row set otherwise."""
        cat = self.all_rows()
        if len(np.unique(cat)) != len(cat):
            raise ValueError("invalid ShardPlan: a row is assigned to "
                             "more than one shard")
        if ids is not None and not np.array_equal(
                cat, np.sort(np.asarray(ids))):
            raise ValueError("invalid ShardPlan: partition does not "
                             "cover the id set (stale plan?)")

    def describe(self) -> str:
        sz = self.sizes
        lo, hi = (min(sz), max(sz)) if sz else (0, 0)
        return (f"{self.n_shards} shards ({self.strategy})  rows "
                f"min/max={lo}/{hi}  balance={self.balance:.2f}")


def _hash_ids(ids: np.ndarray) -> np.ndarray:
    """Stable 64-bit mix (splitmix64 finalizer) so hash shards spread
    contiguous id runs without Python-hash salt dependence."""
    h = ids.astype(np.uint64, copy=True)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h ^ (h >> np.uint64(31))


def shard_route(ids, n_shards: int) -> np.ndarray:
    """Stationary hash routing of individual row ids: the shard that
    owns each row under ``strategy='hash'`` partitioning, WITHOUT
    building a plan. ``plan_shards(ids, n, 'hash').shards[s]`` contains
    exactly the ids with ``shard_route(ids, n) == s`` — the serving
    path (serve/service.py) routes single-row requests with this and
    lands on the same shard (hence the same shard-local virtual
    columns) every scan-time hash plan used."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    ids = np.atleast_1d(np.asarray(ids, np.int64))
    return (_hash_ids(ids) % np.uint64(n_shards)).astype(np.int64)


def plan_shards(ids, n_shards: int, *, strategy: str = "range",
                weights=None) -> ShardPlan:
    """Partition row ids into ``n_shards`` disjoint shards.

    ``strategy='range'``: contiguous runs of the sorted id list, with
    boundaries placed on the cumulative ``weights`` curve (uniform when
    None) — the skew-aware split: a run of expensive rows ends up in a
    smaller shard. ``strategy='hash'``: stable per-id hash mod
    ``n_shards`` — balanced in expectation and stationary across
    queries. Empty shards are legal (n_shards may exceed len(ids))."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if strategy not in SHARD_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {SHARD_STRATEGIES}")
    ids = np.asarray(ids, np.int64)
    if weights is None:
        order = np.argsort(ids)
        ids = ids[order]
        w = np.ones(len(ids))
    else:
        w = np.asarray(weights, np.float64)
        assert w.shape == ids.shape, "weights must align with ids"
        # keep each weight paired with its row while sorting
        order = np.argsort(ids)
        ids, w = ids[order], w[order]
        # degenerate/negative weights would break the cumulative split
        w = np.clip(w, 0.0, None) + 1e-12

    if strategy == "hash":
        shard_of = shard_route(ids, n_shards)
        parts = [ids[shard_of == s] for s in range(n_shards)]
        wsums = [float(w[shard_of == s].sum()) for s in range(n_shards)]
        return ShardPlan(n_shards, strategy, tuple(parts), tuple(wsums))

    cum = np.cumsum(w)
    total = cum[-1] if len(cum) else 0.0
    targets = total * np.arange(1, n_shards) / n_shards
    # boundary b_j = first index whose cumulative weight exceeds target j
    # (side='right': a row exactly on the target closes the shard)
    bounds = np.searchsorted(cum, targets, side="right")
    parts = np.split(ids, bounds)
    wparts = np.split(w, bounds)
    return ShardPlan(n_shards, strategy, tuple(parts),
                     tuple(float(p.sum()) for p in wparts))
