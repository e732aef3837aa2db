"""Speculative decoding, ported from the reference's
``serve/speculative.py``: the paper's cascade idea applied to generation
(DESIGN.md §5). A cheap DRAFT model proposes gamma tokens; the TRUSTED
model verifies them in one forward over the sequence; the accepted prefix
advances it. With greedy decoding the output is the trusted model's own
greedy decode, while the trusted model runs once per ~(accepted + 1)
tokens instead of once per token.

Built on the public Model API (``forward``), B = 1 and full-forward
verification, as the reference. Both entry points run where the weights
are: on the card unless the caller passes ``device="cpu"`` (and weights
there). A draft token is an index into the target's embedding table, so
the draft's padded vocabulary may not exceed the target's: on a card an
index past the table is a device-side assert, not a silently clamped
gather.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import params_device


@dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0
    target_calls: int = 0
    draft_calls: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.proposed, 1)


def _last_logits(model, params, seq: list[int], dev) -> torch.Tensor:
    tokens = torch.tensor([seq], dtype=torch.int64, device=dev)
    logits, _, _ = model.forward(params, {"tokens": tokens},
                                 logits_last_only=True)
    return logits[0, -1]


@torch.no_grad()
def generate_greedy(model, params, prompt: np.ndarray, n_tokens: int, *,
                    device=None) -> np.ndarray:
    """Reference: plain greedy decode of ``model`` (B = 1), one full
    forward per token."""
    dev = params_device(params, device)
    seq = [int(t) for t in np.asarray(prompt)]
    out: list[int] = []
    tok = int(torch.argmax(_last_logits(model, params, seq, dev)))
    for _ in range(n_tokens):
        out.append(tok)
        seq.append(tok)
        tok = int(torch.argmax(_last_logits(model, params, seq, dev)))
    return np.array(out, np.int32)


@torch.no_grad()
def generate_speculative(draft, draft_params, target, target_params,
                         prompt: np.ndarray, n_tokens: int, gamma: int = 4,
                         *, device=None) -> tuple[np.ndarray, SpecStats]:
    """Greedy speculative decoding (B = 1, full-forward verification).
    Returns (generated tokens, stats)."""
    dev = params_device(target_params, device)
    params_device(draft_params, dev)
    if draft.cfg.padded_vocab() > target.cfg.padded_vocab():
        raise ValueError(
            f"draft {draft.cfg.name} proposes ids < "
            f"{draft.cfg.padded_vocab()}, past target {target.cfg.name}'s "
            f"{target.cfg.padded_vocab()}-row embedding table")
    stats = SpecStats()
    seq = [int(t) for t in np.asarray(prompt)]
    out: list[int] = []
    while len(out) < n_tokens:
        g = min(gamma, n_tokens - len(out))
        # 1. the draft proposes g tokens autoregressively
        proposals: list[int] = []
        for _ in range(g):
            logits = _last_logits(draft, draft_params, seq + proposals, dev)
            stats.draft_calls += 1
            proposals.append(int(torch.argmax(logits)))
        stats.proposed += g
        # 2. ONE target forward over sequence + proposals scores g+1 slots
        full = torch.tensor([seq + proposals], dtype=torch.int64, device=dev)
        logits, _, _ = target.forward(target_params, {"tokens": full})
        stats.target_calls += 1
        base = len(seq) - 1
        tgt = torch.argmax(logits[0, base:base + g + 1], -1).tolist()
        # 3. accept the longest prefix where draft == target-greedy
        n_acc = 0
        while n_acc < g and proposals[n_acc] == tgt[n_acc]:
            n_acc += 1
        stats.accepted += n_acc
        for t in proposals[:n_acc] + [tgt[n_acc]]:
            if len(out) < n_tokens:
                out.append(t)
                seq.append(t)
    return np.array(out, np.int32), stats
