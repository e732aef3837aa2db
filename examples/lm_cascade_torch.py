"""The LM predicate cascade on the PyTorch/CUDA port (the twin of
lm_cascade_predicate.py): a cheap truncated-context LM (the token-domain
analogue of the paper's resolution scaling) answers contains-token(YES)
queries and only uncertain inputs fall through to the trusted LM.
Thresholds come from the same Algorithm 1 as the CNN cascades.

Both levels are smoke configs (minitron-4b on the last 12 tokens,
deepseek-7b on all 24) trained with BCE on the YES/NO pair by
``train/optimizer``'s AdamW, on the device, through the model's forward
(the flash kernel on a card, its backward the plain version's).

  PYTHONPATH=src python examples/lm_cascade_torch.py [--device cuda]

``--device`` defaults to ``cuda`` and raises without a card; pass
``--device cpu`` to run on the CPU.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.core.lm_cascade import (LMLevel, calibrate,  # noqa: E402
                                         expected_cost, lm_predicate_score,
                                         run_lm_cascade)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.factory import build_model  # noqa: E402
from repro_torch.train.optimizer import (adamw, tree_leaves,  # noqa: E402
                                         tree_unflatten)

YES, NO = 7, 13


def make_task(vocab, n, seq, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (n, seq)).astype(np.int32)
    toks[toks == YES] = YES + 1
    labels = rng.integers(0, 2, n).astype(np.int32)
    for i in np.where(labels == 1)[0]:
        toks[i, rng.integers(0, seq - 1, size=3)] = YES
    return toks, labels


def train_level(arch, toks, labels, steps, dev, seed=0):
    """BCE on the (YES, NO) logits at the last position, AdamW(3e-3),
    batches of 16 drawn from ``seed``, as the reference trains a level."""
    cfg = smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    opt = adamw(3e-3)
    state = opt.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, len(toks), 16)
        tb = torch.as_tensor(toks[idx], device=dev).long()
        yb = torch.as_tensor(labels[idx], device=dev)
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        logits, _, _ = model.forward(params, {"tokens": tb},
                                     logits_last_only=True)
        logp = torch.log_softmax(logits[:, -1, [YES, NO]].float(), -1)
        loss = -torch.where(yb == 1, logp[:, 0], logp[:, 1]).mean()
        grads = torch.autograd.grad(loss, leaves)
        params = tree_unflatten(params, [p.detach() for p in leaves])
        params, state, _ = opt.update(tree_unflatten(params, list(grads)),
                                      state, params)
    return LMLevel(model=model, params=params, yes_token=YES, no_token=NO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    vocab = smoke_config("deepseek-7b").vocab_size
    toks, labels = make_task(vocab, 360, 24)
    print(f"training cheap level (minitron smoke, 12-token context) on "
          f"{dev}...")
    small = train_level("minitron-4b", toks[:200, -12:], labels[:200], 150,
                        dev)
    small.max_context = 12
    print("training trusted level (deepseek-7b smoke, full context)...")
    trusted = train_level("deepseek-7b", toks[:200], labels[:200], 220, dev,
                          seed=1)
    calibrate([small, trusted], toks[200:280], labels[200:280],
              prec_target=0.8, device=dev)
    print(f"calibrated thresholds: p_low={small.p_low:.2f} "
          f"p_high={small.p_high:.2f}")

    ev_t, ev_y = toks[280:], labels[280:]
    preds, used = run_lm_cascade([small, trusted], ev_t, device=dev)
    acc = (preds == ev_y).mean()
    acc_trusted = ((lm_predicate_score(trusted, ev_t, device=dev) >= 0.5)
                   == ev_y).mean()
    cost = expected_cost([small, trusted], used, [1.0, 30.0])
    print(f"\ncascade accuracy {acc:.3f} (trusted-only {acc_trusted:.3f})")
    print(f"routed early: {(used == 0).mean():.0%}; expected cost "
          f"{cost:.1f} units vs trusted-only 31.0 "
          f"({31.0 / cost:.1f}x cheaper)")
    return acc, acc_trusted, used


if __name__ == "__main__":
    main()
