"""Inputs made from the seed repeat, and give the configured shares."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import inputs
from bench.reference import scan_ref

TINY = json.loads((Path(__file__).parent / "tiny.json").read_text())
BIG_SEED = 2 ** 31 + 7


def test_corpus_repeats_per_seed_and_is_dyadic():
    a = inputs.draw_corpus(TINY, BIG_SEED, "cpu")
    assert torch.equal(a, inputs.draw_corpus(TINY, BIG_SEED, "cpu"))
    assert not torch.equal(a, inputs.draw_corpus(TINY, BIG_SEED + 1, "cpu"))
    assert a.shape == (TINY["frames"], TINY["base"], TINY["base"], 3)
    assert torch.equal(a * 256, torch.floor(a * 256))
    assert 0.0 <= a.min() and a.max() < 1.0


def test_cascades_repeat_per_seed():
    corpus = inputs.draw_corpus(TINY, 3, "cpu")
    a = inputs.make_cascades(TINY, corpus, 3)
    b = inputs.make_cascades(TINY, corpus, 3)
    c = inputs.make_cascades(TINY, corpus, 4)
    for x, y, z in zip(a, b, c):
        assert x["thresholds"] == y["thresholds"]
        assert x["thresholds"] != z["thresholds"] or len(
            x["levels"]) == 1
        for lx, ly in zip(x["levels"], y["levels"]):
            assert torch.equal(lx["params"]["out_w"], ly["params"]["out_w"])
            assert torch.equal(lx["params"]["conv"][0]["w"],
                               ly["params"]["conv"][0]["w"])


def test_thresholds_give_the_configured_shares():
    # the calibration sample is the whole tiny corpus, so the reference's
    # shares over it are the configured ones, each predicate's among the
    # rows the earlier ones pass, up to a row of rounding; no row's score
    # lies on a threshold
    corpus = inputs.draw_corpus(TINY, 9, "cpu")
    cascades = inputs.make_cascades(TINY, corpus, 9)
    rows = np.arange(TINY["frames"])
    for pred, casc in zip(TINY["predicates"], cascades):
        labels, reach, margin = scan_ref.cascade_labels(
            corpus, rows, casc["levels"], casc["thresholds"])
        assert abs(labels.mean() - pred["selectivity"]) <= 1.5 / len(rows)
        for d, (a, b) in zip(pred["decide"], zip(reach, reach[1:])):
            assert abs((a - b) / a - d) <= 2.5 / a
        assert margin.min() > 1e-5
        rows = rows[labels == 1]


def test_cuts_fall_between_sample_values():
    vals = [0.1, 0.4, 0.2, 0.3]
    assert inputs.cut(vals, 0.5) == pytest.approx(0.25)
    assert inputs.cut(vals, 0.0) == pytest.approx(0.15)
    assert inputs.cut(vals, 1.0) == pytest.approx(0.35)


def test_camera_rounds_visit_every_camera_once_a_round():
    k = TINY["recordings"]
    it = inputs.rounds(TINY, BIG_SEED)
    seq = [next(it) for _ in range(5 * k)]
    for r in range(5):
        assert sorted(seq[r * k:(r + 1) * k]) == list(range(k))
    it2 = inputs.rounds(TINY, BIG_SEED)
    assert [next(it2) for _ in range(5 * k)] == seq
    meta = inputs.metadata(TINY)["cam"]
    assert np.bincount(meta).tolist() == [TINY["frames"] // k] * k
    assert (np.diff(meta) >= 0).all()
