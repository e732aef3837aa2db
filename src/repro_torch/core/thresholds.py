"""Decision thresholds (paper §V-C, Algorithm 1).

``compute_thresholds`` is a line-faithful port of Algorithm 1 including its
quirks (e.g. p_high records ``curThresh`` — the PREVIOUS step — while p_low
records ``currentThresh``; precision uses strict '>' for the positive side
and '>=' for the negative side, exactly as printed).

``compute_thresholds_batch`` vectorizes the sweep over many models at once
(numpy), producing identical results — property-tested against the port.

Semantics: output o >= p_high => accept positive; o <= p_low => accept
negative; otherwise the model is "uncertain" and the cascade falls through
to the next level. Thresholds are chosen per model to maximize recall
subject to precision >= precTarget on the config split (paper: validation
set), independently of any cascade (§V-D).
"""
from __future__ import annotations

import numpy as np

DEFAULT_STEP = 0.05
PRECISION_TARGETS = (0.91, 0.93, 0.95, 0.97, 0.99)


def _precision_recall(labels, truth, thresh, positive: bool):
    """Precision/recall of the 'certain' decision at ``thresh``.
    positive: predictions are o >= thresh claiming label 1;
    negative: predictions are o <= thresh claiming label 0."""
    labels = np.asarray(labels, np.float64)
    truth = np.asarray(truth)
    if positive:
        pred = labels >= thresh
        tp = float(np.sum(pred & (truth == 1)))
        denom_rec = float(np.sum(truth == 1))
    else:
        pred = labels <= thresh
        tp = float(np.sum(pred & (truth == 0)))
        denom_rec = float(np.sum(truth == 0))
    npred = float(np.sum(pred))
    prec = tp / npred if npred else 0.0
    rec = tp / denom_rec if denom_rec else 0.0
    return prec, rec


def compute_thresholds(model_predict, images, truth, prec_target: float,
                       step: float = DEFAULT_STEP):
    """Algorithm 1, line-faithful. model_predict(images) -> scores [0,1].
    Returns (p_low, p_high)."""
    num_steps = int(round(1.0 / step))
    cur_thresh = 0.0
    max_recall_pos = 0.0
    max_recall_neg = 0.0
    p_low, p_high = 0.0, 1.0
    labels = np.asarray(model_predict(images))
    for _ in range(1, num_steps + 1):
        current_thresh = cur_thresh + step
        if current_thresh > 0.5:
            prec_pos, recall_pos = _precision_recall(labels, truth,
                                                     cur_thresh, True)
            if prec_pos > prec_target and recall_pos > max_recall_pos:
                max_recall_pos = recall_pos
                p_high = cur_thresh          # NOTE: previous step (as printed)
        else:
            prec_neg, recall_neg = _precision_recall(labels, truth,
                                                     current_thresh, False)
            if prec_neg >= prec_target and recall_neg > max_recall_neg:
                max_recall_neg = recall_neg
                p_low = current_thresh
        cur_thresh = current_thresh
    return p_low, p_high


def compute_thresholds_batch(scores, truth, prec_targets,
                             step: float = DEFAULT_STEP):
    """Vectorized Algorithm 1 over (n_models, n_images) scores and multiple
    precision targets. Returns p_low/p_high arrays (n_models, n_targets).
    Matches ``compute_thresholds`` exactly (tests/test_thresholds.py)."""
    scores = np.asarray(scores, np.float64)
    truth = np.asarray(truth)
    n_models = scores.shape[0]
    num_steps = int(round(1.0 / step))
    # replicate the faithful port's float accumulation exactly
    grid = np.cumsum(np.full(num_steps, step))
    prev = np.concatenate(([0.0], grid[:-1]))
    pos_mask = grid > 0.5
    # positive sweep evaluates at the PREVIOUS thresh; negative at current
    pos_ts = prev[pos_mask]
    neg_ts = grid[~pos_mask]

    pos1 = truth == 1
    n_pos = max(pos1.sum(), 1)
    n_neg = max((~pos1).sum(), 1)

    def stats(ts, positive):
        # (n_models, n_ts) precision/recall
        if positive:
            pred = scores[:, None, :] >= ts[None, :, None]
            tp = (pred & pos1[None, None, :]).sum(-1).astype(np.float64)
            rec = tp / n_pos
        else:
            pred = scores[:, None, :] <= ts[None, :, None]
            tp = (pred & (~pos1)[None, None, :]).sum(-1).astype(np.float64)
            rec = tp / n_neg
        npred = pred.sum(-1)
        prec = np.divide(tp, npred, out=np.zeros_like(tp),
                         where=npred > 0)
        return prec, rec

    prec_p, rec_p = stats(pos_ts, True)
    prec_n, rec_n = stats(neg_ts, False)

    targets = np.asarray(prec_targets, np.float64)
    p_low = np.zeros((n_models, len(targets)))
    p_high = np.ones((n_models, len(targets)))
    for j, tgt in enumerate(targets):
        ok_p = prec_p > tgt
        ok_n = prec_n >= tgt
        rp = np.where(ok_p, rec_p, -1.0)
        rn = np.where(ok_n, rec_n, -1.0)
        # argmax keeps the FIRST maximum — matches the sequential
        # strictly-greater update in Algorithm 1.
        bi = rp.argmax(1)
        bj = rn.argmax(1)
        has_p = rp.max(1) > 0.0
        has_n = rn.max(1) > 0.0
        p_high[:, j] = np.where(has_p, pos_ts[bi], 1.0)
        p_low[:, j] = np.where(has_n, neg_ts[bj], 0.0)
    return p_low, p_high
