"""Mini relational layer over an image corpus (paper §IV).

A content-based query = metadata predicates (evaluated directly on stored
tuples) AND binary contains-object predicates (evaluated by a selected
cascade). The cascade's output materializes the predicate's virtual
column (paper: 'the output of a classifier model can be thought of as a
virtual column'), cached corpus-side PARTIALLY: only the rows a query
actually had to evaluate are stored (int8, -1 = unknown), and later
queries pay only for rows no earlier query decided.

Predicate ordering here is fixed (metadata first, then the binary
predicates in the given order) and each binary predicate runs ONLY on
rows surviving everything before it. The planned path — cascade
selection per predicate, selectivity x cost ordering, shared-pyramid
chunk scan — is repro_torch.engine (DESIGN.md §4); this module remains
the simple executor-closure reference the engine is tested against.
Plain numpy: a copy of the reference's module, pinned equal to it by
tests/test_torch_oracles.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np


@dataclass
class Corpus:
    images: np.ndarray                       # (N, H, W, 3) float32 [0,1]
    metadata: Mapping[str, np.ndarray]       # column -> (N,)
    virtual_columns: dict = field(default_factory=dict)

    def __len__(self):
        return len(self.images)


@dataclass
class BinaryPredicate:
    """contains_object(<concept>) implemented by an executor closure
    mapping an image batch -> int labels (the selected cascade)."""
    concept: str
    executor: Callable[[np.ndarray], np.ndarray]


def evaluate_predicate(corpus: Corpus, pred: BinaryPredicate,
                       batch_size: int = 64,
                       mask: np.ndarray | None = None) -> np.ndarray:
    """Populate the predicate's PARTIAL virtual column for the rows in
    ``mask`` (all rows when None) that are still unknown; rows other
    queries already decided are never re-run. Returns the full column
    (int8; -1 = never evaluated)."""
    n = len(corpus)
    col = corpus.virtual_columns.get(pred.concept)
    if col is None:
        col = np.full(n, -1, np.int8)
        corpus.virtual_columns[pred.concept] = col
    need = col == -1
    if mask is not None:
        need = need & np.asarray(mask, bool)
    ids = np.where(need)[0]
    for lo in range(0, len(ids), batch_size):
        sub = ids[lo:lo + batch_size]
        chunk = corpus.images[sub]
        if len(sub) < batch_size:            # static-shape pad (TPU)
            pad = np.repeat(chunk[-1:], batch_size - len(chunk), axis=0)
            labels = np.asarray(pred.executor(
                np.concatenate([chunk, pad])))[:len(sub)]
        else:
            labels = np.asarray(pred.executor(chunk))
        col[sub] = labels.astype(np.int8)
    return col


def run_query(corpus: Corpus, *,
              metadata_eq: Mapping[str, object] | None = None,
              binary_preds: Sequence[BinaryPredicate] = (),
              batch_size: int = 64) -> np.ndarray:
    """SELECT image_id WHERE meta = ... AND contains(a) AND contains(b).
    Metadata predicates are applied FIRST (cheap); each binary predicate
    is evaluated ONLY on the rows surviving the metadata filter and every
    earlier binary predicate — never on rows already eliminated."""
    mask = np.ones(len(corpus), bool)
    for col, val in (metadata_eq or {}).items():
        mask &= np.asarray(corpus.metadata[col]) == val
    for pred in binary_preds:
        if not mask.any():
            break
        col = evaluate_predicate(corpus, pred, batch_size, mask=mask)
        mask &= col == 1
    return np.where(mask)[0]
