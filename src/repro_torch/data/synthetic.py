"""Synthetic labeled image corpora with *representation-sensitive* class
signal, standing in for the paper's ImageNet predicates (numpy; a copy of
the reference's generators, pinned equal to them by
tests/test_torch_transforms_cnn.py and tests/test_torch_ingest.py).

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


def make_camera_stream(specs, n_frames: int, hw: int = 32, seed: int = 0,
                       positive_rate: float = 0.5, hold_max: int = 4,
                       jitter: int = 1):
    """Simulated camera stream for the ingest pipeline (engine/ingest.py):
    piecewise-constant scenes. Each DISTINCT scene frame is drawn like a
    ``make_multi_corpus`` row (quantized to k/256 dyadics) and held for a
    random 1..hold_max consecutive frames; held repeats get independent
    per-pixel ±jitter/256 sensor noise — dyadic steps on the dyadic grid,
    so pyramid derivation stays bit-exact (DESIGN.md §3.1) while frames
    within a scene are near- but not bit-identical (what a temporal
    difference detector must tolerate). Scene CHANGES replace the clutter
    and the predicate textures entirely, so cross-scene frame differences
    are orders of magnitude above the jitter — the detector's separation
    margin. Returns (frames (N,hw,hw,3), labels (N,K) int32,
    scene_id (N,) int64); held frames share their scene's labels."""
    rng = np.random.default_rng(seed + 1_000_003)
    holds = []
    while sum(holds) < n_frames:
        holds.append(int(rng.integers(1, max(2, hold_max + 1))))
    scenes_x, scenes_y = make_multi_corpus(specs, len(holds), hw=hw,
                                           seed=seed,
                                           positive_rate=positive_rate,
                                           quantize=True)
    frames = np.empty((n_frames, hw, hw, 3), np.float32)
    labels = np.empty((n_frames, len(specs)), np.int32)
    scene_id = np.empty(n_frames, np.int64)
    t = 0
    for s, hold in enumerate(holds):
        for _ in range(hold):
            if t == n_frames:
                break
            f = scenes_x[s]
            if jitter and t and scene_id[t - 1] == s:
                # held repeat: ±jitter/256 dyadic sensor noise
                delta = rng.integers(-jitter, jitter + 1,
                                     size=f.shape).astype(np.float32)
                f = np.clip(f + delta / 256.0, 0.0, 1.0)
            frames[t] = f
            labels[t] = scenes_y[s]
            scene_id[t] = s
            t += 1
    return frames, labels, scene_id


def make_two_camera_corpus(specs, n: int, hw: int = 32, seed: int = 0,
                           positive_rate: float = 0.4, corr: float = 0.6,
                           dt_max: int = 2, gap: int = 8):
    """Two correlated camera corpora for the cross-corpus temporal join
    workload (engine/algebra.Join, DESIGN.md §15.3): camera A records
    ``n`` frames at (jittered) timestamps ~``gap`` apart; a ``corr``
    fraction of camera B's ``n`` frames are PAIRED with an A frame —
    same predicate label vector, a timestamp within ±``dt_max`` of the
    partner — while the rest carry independent labels at independent
    timestamps. Both cameras render their frames independently
    (separate clutter/phase — two viewpoints of one scene, not pixel
    copies), quantized to k/256 dyadics like ``make_multi_corpus`` so
    engine and naive scans stay bit-exact. Paired rows make a
    ``Join(contains(X), contains(X), delta_t=dt_max)`` non-trivially
    selective: matches exist, but only where the correlation put them.

    Returns ``((frames_a, labels_a, t_a), (frames_b, labels_b, t_b))``
    with labels (N, K) int32 and timestamps (N,) int64, each camera
    sorted by its own timestamps."""
    rng = np.random.default_rng(seed + 7_654_321)
    t_a = (np.arange(n, dtype=np.int64) * gap
           + rng.integers(0, max(gap // 2, 1), size=n))
    lab_a = (rng.random((n, len(specs))) < positive_rate).astype(np.int32)
    paired = rng.random(n) < corr
    lab_b = np.empty_like(lab_a)
    t_b = np.empty(n, np.int64)
    lab_b[paired] = lab_a[paired]
    t_b[paired] = t_a[paired] + rng.integers(-dt_max, dt_max + 1,
                                             size=int(paired.sum()))
    free = ~paired
    lab_b[free] = (rng.random((int(free.sum()), len(specs)))
                   < positive_rate).astype(np.int32)
    # independent timestamps, offset half a gap so free frames rarely
    # fall inside a window by accident (but occasionally do — the join
    # must verify, not assume)
    t_b[free] = (rng.integers(0, n, size=int(free.sum())) * gap
                 + gap // 2)
    out = []
    for cam, (labels, t) in enumerate(((lab_a, t_a), (lab_b, t_b))):
        x = _render_labeled(specs, labels, hw,
                            np.random.default_rng(seed + 31 * (cam + 1)))
        order = np.argsort(t, kind="stable")
        out.append((x[order], labels[order], t[order]))
    return out[0], out[1]


def _render_labeled(specs, labels, hw, rng):
    """Render frames carrying exactly ``labels``'s texture signals —
    the ``make_multi_corpus`` image model with the label draw hoisted
    out (so two cameras can share labels but not pixels)."""
    n = len(labels)
    x = _clutter(rng, n, hw)
    yy, xx = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    for k, spec in enumerate(specs):
        phase = rng.uniform(0, 2 * np.pi, size=n)
        theta = rng.uniform(0, np.pi, size=n)
        for i in np.where(labels[:, k] == 1)[0]:
            g = (np.cos(theta[i]) * xx + np.sin(theta[i]) * yy) / hw
            tex = np.sin(2 * np.pi * spec.freq * g + phase[i])
            x[i, :, :, spec.channel] += spec.amplitude * tex
    x = 0.5 + 0.18 * x
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return (np.floor(x * 256.0).clip(0, 255) / 256.0).astype(np.float32)


def three_way_split(x, y, seed: int = 0, frac=(0.5, 0.25, 0.25)):
    """train / config(thresholds) / eval — paper §V-A's three splits."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n1 = int(len(x) * frac[0])
    n2 = n1 + int(len(x) * frac[1])
    tr, cf, ev = idx[:n1], idx[n1:n2], idx[n2:]
    return (x[tr], y[tr]), (x[cf], y[cf]), (x[ev], y[ev])
