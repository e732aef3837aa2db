"""Inputs made from ``--seed``, handed alike to the program and the
reference: the corpus, its metadata column, each cascade's weights and
thresholds, and the order of the queries.

* Corpus: ``frames`` dyadic half-tone ``base`` x ``base`` RGB float32
  frames drawn on the device in blocks: uniform k/256 pixels, then each
  frame's mean colour added and the sum quantised to k/256 again, so
  pooled levels are exact in f32 and random CNNs see coarse structure.
* Metadata: ``cam``, ``recordings`` contiguous runs of equal length.
* Weights: He-style normal draws at the configuration's widths (the
  program's own initialiser draws the same shapes and scales), then each
  level's output layer scaled so its logit has unit spread on a seeded
  calibration sample and shifted so that the last level labels the
  configured share 1.
* Thresholds: quantiles of the reference's scores on that sample, giving
  each level its configured share of decided rows and each predicate its
  configured selectivity, each cut midway between two sample scores so
  that no row of the sample lies on a threshold.
* Queries: camera ids in rounds, each round every camera once in a seeded
  order, so every seed does the same set of work.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import scan_ref
from bench.yardstick import channels

CORPUS_BLOCK = 2048      # frames drawn per call
CALIBRATION_ROWS = 16384


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one named use of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63))


def draw_corpus(cfg: dict, seed: int, device) -> torch.Tensor:
    n, hw = int(cfg["frames"]), int(cfg["base"])
    gen = generator(seed, device, 1)
    corpus = torch.empty((n, hw, hw, 3), dtype=torch.float32, device=device)
    for lo in range(0, n, CORPUS_BLOCK):
        x = torch.randint(0, 256, (min(CORPUS_BLOCK, n - lo), hw, hw, 3),
                          generator=gen, device=device,
                          dtype=torch.int32).to(torch.float32) / 256
        corpus[lo:lo + len(x)] = torch.floor(
            (x + x.mean(dim=(1, 2), keepdim=True)) * 128) / 256
    return corpus


def metadata(cfg: dict) -> dict:
    n, k = int(cfg["frames"]), int(cfg["recordings"])
    if n % k:
        raise ValueError("frames must split into equal recordings")
    return {"cam": np.repeat(np.arange(k), n // k)}


def init_weights(gen: torch.Generator, arch, res: int, chans: int,
                 device) -> dict:
    """HWIO weights of ``arch`` = (conv layers, conv width, dense width):
    normal draws scaled by sqrt(2 / fan-in), zero biases."""
    n_conv, conv_nodes, dense_nodes = arch

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p = {"conv": []}
    c_in, hw = chans, res
    for _ in range(n_conv):
        w = normal(3, 3, c_in, conv_nodes) * (2.0 / (9 * c_in)) ** 0.5
        p["conv"].append({"w": w, "b": torch.zeros(conv_nodes,
                                                   device=device)})
        c_in, hw = conv_nodes, hw // 2
    flat = hw * hw * c_in
    p["dense_w"] = normal(flat, dense_nodes) * (2.0 / flat) ** 0.5
    p["dense_b"] = torch.zeros(dense_nodes, device=device)
    p["out_w"] = normal(dense_nodes, 1) * (1.0 / dense_nodes) ** 0.5
    p["out_b"] = torch.zeros(1, device=device)
    return p


def cut(values, share: float) -> float:
    """A cut below which ``share`` of ``values`` lie, set midway between
    two neighbouring values so that no sample row sits on it."""
    v = np.sort(np.asarray(values, np.float64))
    k = min(max(int(round(share * len(v))), 1), len(v) - 1)
    return float((v[k - 1] + v[k]) / 2)


def make_cascades(cfg: dict, corpus: torch.Tensor, seed: int) -> list:
    """[{"name", "levels": [{"arch", "res", "color", "params"}],
    "thresholds": [(low, high) ..., (None, None)]}] for the predicates of
    ``cfg``, in the configured order. Each is calibrated, level by level,
    on the reference's f32 scores of the sample rows that every earlier
    predicate passes, so each predicate's selectivity holds given the
    ones before it and every seed scans the same amount of work."""
    dev = corpus.device
    gen = generator(seed, dev, 2)
    rng = np.random.default_rng([int(seed) % (2 ** 63), 3])
    rows = np.sort(rng.choice(len(corpus), min(CALIBRATION_ROWS,
                                               len(corpus)), replace=False))
    out = []
    for pred in cfg["predicates"]:
        levels, ths = [], []
        sel = float(pred["selectivity"])
        reach = rows
        for lvl, spec in enumerate(pred["levels"]):
            last = lvl == len(pred["levels"]) - 1
            arch, res, color = (tuple(spec["arch"]), int(spec["res"]),
                                spec["color"])
            p = init_weights(gen, arch, res, channels(color), dev)
            level = {"arch": arch, "res": res, "color": color, "params": p}
            with torch.no_grad(), scan_ref.precision_mode("f32"):
                logit = _logits(corpus, reach, level).cpu().numpy()
                spread = float(logit.std())
                if not spread > 0:
                    raise ValueError(f"{pred['name']} level {lvl}: the "
                                     f"logit does not vary on the sample")
                p["out_w"] /= spread
                p["out_b"] -= cut(_logits(corpus, reach, level).cpu(),
                                  1 - sel if last else 0.5)
                s = scan_ref.level_scores(corpus, reach, level).cpu().numpy()
            levels.append(level)
            if last:
                ths.append((None, None))
                break
            d = float(pred["decide"][lvl])
            lo = scan_ref.f32(cut(s, d * (1 - sel)))
            hi = scan_ref.f32(cut(s, 1 - d * sel))
            ths.append((lo, hi))
            reach = reach[(s > np.float32(lo)) & (s < np.float32(hi))]
        casc = {"name": pred["name"], "levels": levels, "thresholds": ths}
        labels, _, _ = scan_ref.cascade_labels(corpus, rows, levels, ths)
        rows = rows[labels == 1]
        out.append(casc)
    return out


def _logits(corpus, rows, level, block: int = 512) -> torch.Tensor:
    out = []
    for lo in range(0, len(rows), block):
        idx = torch.as_tensor(rows[lo:lo + block], device=corpus.device)
        x = scan_ref.project(scan_ref.area_pool(corpus[idx], level["res"]),
                             level["color"])
        out.append(scan_ref.cnn_logits(level["params"], x))
    return torch.cat(out)


def rounds(cfg: dict, seed: int):
    """Camera ids without end: rounds of every camera once, each round in
    its own seeded order."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 4])
    while True:
        yield from (int(c) for c in rng.permutation(int(cfg["recordings"])))
