"""Synthetic labeled image corpora with *representation-sensitive* class
signal, standing in for the paper's ImageNet predicates (numpy; a copy of
the reference's generators, pinned equal to them by
tests/test_torch_transforms_cnn.py).

Each binary predicate k is parameterized by a color channel c_k and a
spatial frequency f_k. Positive images carry a sinusoidal texture of
frequency f_k in channel c_k (plus clutter); negatives carry clutter only:
low-frequency predicates survive aggressive downscaling while
high-frequency ones need resolution, and the signal lives in ONE channel
so single-channel and grayscale representations differ in accuracy.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PredicateSpec:
    name: str
    channel: int       # 0/1/2
    freq: float        # cycles across the image
    amplitude: float = 1.1


DEFAULT_PREDICATES = (
    PredicateSpec("acorn", 0, 2.0),
    PredicateSpec("ferret", 1, 4.0),
    PredicateSpec("pinwheel", 2, 8.0),
    PredicateSpec("scorpion", 0, 12.0),
    PredicateSpec("wallet", 1, 3.0),
    PredicateSpec("fence", 2, 6.0),
    PredicateSpec("cloak", 0, 5.0),
    PredicateSpec("coho", 1, 10.0),
    PredicateSpec("komondor", 2, 2.5),
    PredicateSpec("amphibian", 0, 7.0),
)


def _clutter(rng, n, hw):
    """Smooth random background clutter (shared by both classes)."""
    small = rng.normal(0.0, 0.8, size=(n, 8, 8, 3))
    k = hw // 8
    big = np.repeat(np.repeat(small, k, axis=1), k, axis=2)
    big += rng.normal(0.0, 0.18, size=(n, hw, hw, 3))
    return big


def make_corpus(spec: PredicateSpec, n: int, hw: int = 64, seed: int = 0,
                augment_flip: bool = False):
    """Balanced corpus: (images (N,hw,hw,3) float32 in [0,1], labels)."""
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode())
                                % 100000)
    labels = np.zeros(n, np.int32)
    labels[: n // 2] = 1
    rng.shuffle(labels)
    x = _clutter(rng, n, hw)
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, size=n)
    theta = rng.uniform(0, np.pi, size=n)
    for i in np.where(labels == 1)[0]:
        g = (np.cos(theta[i]) * xx + np.sin(theta[i]) * yy) / hw
        tex = np.sin(2 * np.pi * spec.freq * g + phase[i])
        x[i, :, :, spec.channel] += spec.amplitude * tex
    x = 0.5 + 0.18 * x
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    if augment_flip:  # paper §VII-A1 left-right flip augmentation
        x = np.concatenate([x, x[:, :, ::-1]], axis=0)
        labels = np.concatenate([labels, labels])
    return x, labels


def make_multi_corpus(specs, n: int, hw: int = 32, seed: int = 0,
                      positive_rate: float = 0.5, quantize: bool = True):
    """One corpus carrying SEVERAL independent predicate signals — the
    multi-predicate query workload: each spec's texture is injected into
    its own random row subset. Returns (images (N,hw,hw,3), labels (N, K)
    int32). quantize rounds pixels to k/256 dyadics (the uint8-sensor
    regime), keeping pyramid derivation bit-exact so engine and naive
    scans select identical rows."""
    rng = np.random.default_rng(seed)
    x = _clutter(rng, n, hw)
    labels = np.zeros((n, len(specs)), np.int32)
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    for k, spec in enumerate(specs):
        pos = rng.random(n) < positive_rate
        labels[:, k] = pos
        phase = rng.uniform(0, 2 * np.pi, size=n)
        theta = rng.uniform(0, np.pi, size=n)
        for i in np.where(pos)[0]:
            g = (np.cos(theta[i]) * xx + np.sin(theta[i]) * yy) / hw
            tex = np.sin(2 * np.pi * spec.freq * g + phase[i])
            x[i, :, :, spec.channel] += spec.amplitude * tex
    x = 0.5 + 0.18 * x
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    if quantize:
        x = (np.floor(x * 256.0).clip(0, 255) / 256.0).astype(np.float32)
    return x, labels


def three_way_split(x, y, seed: int = 0, frac=(0.5, 0.25, 0.25)):
    """train / config(thresholds) / eval — paper §V-A's three splits."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n1 = int(len(x) * frac[0])
    n2 = n1 + int(len(x) * frac[1])
    tr, cf, ev = idx[:n1], idx[n1:n2], idx[n2:]
    return (x[tr], y[tr]), (x[cf], y[cf]), (x[ev], y[ev])
