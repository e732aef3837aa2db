"""The plain reference against hand-worked inputs."""
import numpy as np
import pytest
import torch

from bench.reference import scan_ref


def probe_level(k: float, c: float, res: int = 4) -> dict:
    """A one-channel level whose logit on a constant image of value v is
    k v + c: centre-only 3x3 kernel, ReLU, max-pool, a mean as the dense
    layer, then k and c."""
    w = torch.zeros(3, 3, 1, 1)
    w[1, 1, 0, 0] = 1.0
    flat = (res // 2) ** 2
    return {"res": res, "color": "r", "params": {
        "conv": [{"w": w, "b": torch.zeros(1)}],
        "dense_w": torch.full((flat, 1), 1.0 / flat),
        "dense_b": torch.zeros(1),
        "out_w": torch.tensor([[k]]), "out_b": torch.tensor([c])}}


def constant_frames(values, hw: int = 8) -> torch.Tensor:
    """Frames whose red channel is the given constant, green and blue 0."""
    x = torch.zeros(len(values), hw, hw, 3)
    x[..., 0] = torch.tensor(values)[:, None, None]
    return x


def test_area_pool_and_colours_by_hand():
    x = torch.arange(16.0).reshape(1, 4, 4, 1).repeat(1, 1, 1, 3)
    x[..., 1] *= 2
    pooled = scan_ref.area_pool(x, 2)
    assert pooled[0, :, :, 0].tolist() == [[2.5, 4.5], [10.5, 12.5]]
    assert torch.equal(scan_ref.area_pool(x, 4), x)
    assert scan_ref.project(pooled, "g")[0, :, :, 0].tolist() == \
        [[5.0, 9.0], [21.0, 25.0]]
    assert scan_ref.project(pooled, "rgb").shape == (1, 2, 2, 3)
    gray = scan_ref.project(torch.ones(1, 1, 1, 3), "gray")
    assert gray.item() == pytest.approx(1.0)


def test_cnn_logit_by_hand():
    level = probe_level(3.0, -1.0)
    x = torch.full((2, 4, 4, 1), 0.5)
    x[1] = 0.25
    got = scan_ref.cnn_logits(level["params"], x)
    assert got.tolist() == pytest.approx([0.5, -0.25])


def test_cascade_labels_by_hand():
    # level 0: logit 8v - 4 (score 0.5 at v = 0.5); thresholds at the
    # scores of v = 0.25 and 0.75 decide rows at or beyond them
    lvl0 = probe_level(8.0, -4.0)
    lvl1 = probe_level(-8.0, 3.0)        # score >= 0.5 iff v <= 0.375
    lo, hi = (float(torch.sigmoid(torch.tensor(x)))
              for x in (-2.0, 2.0))
    corpus = constant_frames([0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875])
    labels, reach, margin = scan_ref.cascade_labels(
        corpus, np.arange(7), [lvl0, lvl1], [(lo, hi), (None, None)],
        block=3)
    # v <= 0.25: decided 0; v >= 0.75: decided 1; the middle goes on,
    # where 0.375 scores above 0.5 and 0.5, 0.625 below
    assert labels.tolist() == [0, 0, 1, 0, 0, 1, 1]
    assert reach == [7, 3]
    assert margin.min() >= 0


def test_scan_answer_is_the_and_of_its_cascades():
    corpus = constant_frames([0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875])
    above = {"levels": [probe_level(8.0, -2.0)], "thresholds": [(None, None)]}
    below = {"levels": [probe_level(-8.0, 5.0)], "thresholds": [(None, None)]}
    ids, reach, _ = scan_ref.scan_answer(corpus, np.arange(7),
                                         [above, below], block=2)
    assert ids.tolist() == [1, 2, 3, 4]      # 0.25 <= v <= 0.625
    assert reach == [[7], [6]]
    ids2, _, _ = scan_ref.scan_answer(corpus, np.arange(7), [below, above])
    assert ids2.tolist() == ids.tolist()


def test_tf32_rounds_to_ten_mantissa_bits():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -10, one + 2 ** -11,
                      one + 3 * 2 ** -11, -(one + 3 * 2 ** -11),
                      one + 2 ** -11 + 2 ** -20])
    got = scan_ref.to_tf32(x).tolist()
    assert got == [1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, -(1 + 2 ** -9),
                   1 + 2 ** -10]


def test_control_is_a_lower_precision_of_the_same_scores():
    gen = torch.Generator().manual_seed(5)
    level = {"res": 8, "color": "rgb", "params": {
        "conv": [{"w": torch.randn(3, 3, 3, 8, generator=gen) * 0.3,
                  "b": torch.zeros(8)}],
        "dense_w": torch.randn(128, 16, generator=gen) * 0.1,
        "dense_b": torch.zeros(16),
        "out_w": torch.randn(16, 1, generator=gen),
        "out_b": torch.zeros(1)}}
    corpus = torch.rand(64, 16, 16, 3, generator=gen)
    rows = np.arange(64)
    f32 = scan_ref.level_scores(corpus, rows, level, "f32")
    tf32 = scan_ref.level_scores(corpus, rows, level, "tf32")
    gap = (f32 - tf32).abs().max().item()
    assert 1e-6 < gap < 1e-2
    assert torch.backends.cudnn.allow_tf32 in (True, False)
    with pytest.raises(ValueError):
        with scan_ref.precision_mode("bf16"):
            pass
