"""The paper's technique on the LM architectures (DESIGN.md §5), ported
from the reference's ``core/lm_cascade.py``: a *predicate cascade over
language models*.

A contains-concept predicate over text is scored by asking a model to
choose between a YES token and a NO token; P(yes) is the probabilistic
output of Def. 7. A cheap model (small arch, truncated context: the
token-domain analogue of the paper's resolution scaling) answers first;
inputs whose score falls inside (p_low, p_high) fall through to the
trusted model. Thresholds are calibrated per model with the same
Algorithm 1 as the CNN cascades (``core/thresholds``).

As in the reference, every level scores the whole batch and the host
masks the rows that already exited. Scoring runs where each level's
weights lie: on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.thresholds import compute_thresholds
from repro_torch.device import params_device


@dataclass
class LMLevel:
    model: object                    # factory Model
    params: object
    yes_token: int
    no_token: int
    max_context: int | None = None   # truncation = representation knob
    p_low: float | None = None
    p_high: float | None = None


@torch.no_grad()
def lm_predicate_score(level: LMLevel, tokens: np.ndarray, *,
                       device=None) -> np.ndarray:
    """tokens (B, S) -> P(yes) (B,) f32. Uses the last-position logits."""
    dev = params_device(level.params, device)
    t = np.asarray(tokens)
    if level.max_context is not None and t.shape[1] > level.max_context:
        t = t[:, -level.max_context:]
    logits, _, _ = level.model.forward(
        level.params, {"tokens": torch.as_tensor(t, device=dev).long()},
        logits_last_only=True)
    pair = logits[:, -1, [level.yes_token, level.no_token]]
    return torch.softmax(pair.float(), -1)[:, 0].cpu().numpy()


def calibrate(levels: Sequence[LMLevel], tokens, truth,
              prec_target: float = 0.95, *, device=None) -> None:
    """Algorithm 1 per level (the final level keeps None thresholds)."""
    for lvl in levels[:-1]:
        scores = lm_predicate_score(lvl, tokens, device=device)
        lvl.p_low, lvl.p_high = compute_thresholds(
            lambda _: scores, None, truth, prec_target)


def run_lm_cascade(levels: Sequence[LMLevel], tokens, *,
                   device=None) -> tuple:
    """-> (labels (B,), level_used (B,)). Per-batch early exit with the
    same semantics as the CNN cascades."""
    b = tokens.shape[0]
    labels = np.zeros(b, np.int32)
    used = np.full(b, len(levels) - 1, np.int32)
    active = np.ones(b, bool)
    for li, lvl in enumerate(levels):
        if not active.any():
            break
        scores = lm_predicate_score(lvl, tokens, device=device)
        if lvl.p_low is None:                     # the final level
            labels[active] = (scores >= 0.5)[active]
            used[active] = li
            active[:] = False
        else:
            certain = active & ((scores <= lvl.p_low)
                                | (scores >= lvl.p_high))
            labels[certain] = (scores >= lvl.p_high)[certain]
            used[certain] = li
            active &= ~certain
    return labels, used


def expected_cost(levels: Sequence[LMLevel], level_used,
                  infer_s: Sequence[float]) -> float:
    """Mean seconds/query given per-level inference costs: every input
    pays levels 0..used (the cascade cost model of §VI, inference-only)."""
    per = np.cumsum(np.asarray(infer_s))
    return float(per[np.asarray(level_used)].mean())
