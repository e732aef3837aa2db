"""The port's plain-numpy reference pieces against the JAX package's:
the paper's ALC metric (core/alc), the simple executor-closure query
layer (core/query) and the per-image cascade oracles
(core/cascade.simulate_cascade, cascade_time_naive). They are copies,
so on the same seeded inputs they give the reference's outputs exactly.

Then the mirrors of the reference's own tests of them:
tests/test_cascade.py's vectorized-vs-naive test on the port's dense
evaluator (abs 1e-5 on acc, rel 1e-5 on time, that test's tolerances)
and on its streaming evaluator on the CPU (f32; every cascade kept by a
top-K as large as the space, same tolerances), the ALC tests of
tests/test_transforms_alc_costs.py and
tests/test_substrate.py::test_query_combines_metadata_and_predicates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import alc as jalc  # noqa: E402
from repro.core import cascade as jcascade  # noqa: E402
from repro.core import query as jquery  # noqa: E402
from repro.core.costs import CostProfile as JProfile  # noqa: E402
from repro.core.transforms import Representation as JRep  # noqa: E402
from repro_torch.core import alc, query  # noqa: E402
from repro_torch.core.alc import (average_throughput,  # noqa: E402
                                  best_matching, speedup)
from repro_torch.core.cascade import (cascade_time_naive,  # noqa: E402
                                      evaluate_cascades,
                                      evaluate_cascades_streaming,
                                      simulate_cascade, spec_levels)
from repro_torch.core.costs import CostProfile  # noqa: E402
from repro_torch.core.query import (BinaryPredicate, Corpus,  # noqa: E402
                                    run_query)
from repro_torch.core.thresholds import compute_thresholds_batch  # noqa
from repro_torch.core.transforms import Representation  # noqa: E402

SCENARIOS = ["INFER_ONLY", "ARCHIVE", "ONGOING", "CAMERA"]


def _setup(seed, n_models=4, n_img=60, n_targets=2):
    """tests/test_cascade.py's inputs, for the port (and the same reps
    and profile for the reference)."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, n_img)
    scores = np.clip(truth[None] * rng.uniform(0.3, 0.7, (n_models, 1))
                     + rng.normal(0.25, 0.2, (n_models, n_img)), 0, 1)
    p_low, p_high = compute_thresholds_batch(scores, truth,
                                             [0.9, 0.95][:n_targets])
    reps = [Representation(8 * (1 + i % 3), ["rgb", "gray", "r"][i % 3])
            for i in range(n_models)]
    reps[-1] = Representation(32, "rgb")   # trusted: full rep
    infer = rng.uniform(1e-4, 5e-3, n_models)
    infer[-1] = 0.05                       # trusted is expensive
    profile = CostProfile.modeled({}, list(set(reps)), base_hw=32)
    return scores, truth, p_low, p_high, reps, infer, profile


def _reference_reps(reps):
    jreps = [JRep(r.resolution, r.color) for r in reps]
    return jreps, JProfile.modeled({}, list(set(jreps)), base_hw=32)


# ------------------------------------------- the copies == the reference --
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 3])
def test_oracles_equal_the_reference(scenario, seed):
    scores, truth, p_low, p_high, reps, infer, profile = _setup(seed)
    jreps, jprofile = _reference_reps(reps)
    space = evaluate_cascades(scores, truth, p_low, p_high, reps, infer,
                              profile, scenario, trusted=len(reps) - 1)
    for i in range(len(space)):
        levels = spec_levels(space, i, p_low, p_high)
        got = simulate_cascade(levels, scores, truth)
        want = jcascade.simulate_cascade(levels, scores, truth)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        for pyramid in (True, False):
            assert cascade_time_naive(
                levels, scores, reps, infer, profile, scenario,
                pyramid=pyramid) == jcascade.cascade_time_naive(
                levels, scores, jreps, infer, jprofile, scenario,
                pyramid=pyramid)


@pytest.mark.parametrize("seed", range(4))
def test_alc_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    acc_a, acc_b = rng.uniform(0.5, 1.0, (2, 40))
    thr_a, thr_b = rng.uniform(1.0, 1e4, (2, 40))
    lo, hi = sorted(rng.uniform(0.5, 1.0, 2))
    for name in ("alc", "average_throughput"):
        assert getattr(alc, name)(acc_a, thr_a, lo, hi) == \
            getattr(jalc, name)(acc_a, thr_a, lo, hi)
    assert speedup(acc_a, thr_a, acc_b, thr_b) == \
        jalc.speedup(acc_a, thr_a, acc_b, thr_b)
    assert speedup(acc_a, thr_a, acc_b, thr_b, lo, hi) == \
        jalc.speedup(acc_a, thr_a, acc_b, thr_b, lo, hi)
    for target in (lo, hi, 0.99):
        assert best_matching(acc_a, thr_a, target) == \
            jalc.best_matching(acc_a, thr_a, target)


def test_query_equals_the_reference():
    rng = np.random.default_rng(5)
    imgs = rng.random((50, 4, 4, 3)).astype(np.float32)
    meta = {"cam": np.arange(50) % 3, "city": np.array(["a", "b"] * 25)}
    calls = {"port": [], "reference": []}

    def executor(who, thr):
        def run(x):
            calls[who].append(len(x))
            return (x.mean(axis=(1, 2, 3)) > thr).astype(np.int32)
        return run

    out = {}
    for who, mod in (("port", query), ("reference", jquery)):
        corpus = mod.Corpus(images=imgs, metadata=meta)
        preds = [mod.BinaryPredicate("bright", executor(who, 0.5)),
                 mod.BinaryPredicate("dim", executor(who, 0.45))]
        first = mod.run_query(corpus, metadata_eq={"cam": 0},
                              binary_preds=preds, batch_size=8)
        # a second query reuses the partial virtual columns
        second = mod.run_query(corpus, metadata_eq={"city": "a"},
                               binary_preds=preds, batch_size=8)
        out[who] = (first, second, {k: v.copy() for k, v in
                                    corpus.virtual_columns.items()})
    np.testing.assert_array_equal(out["port"][0], out["reference"][0])
    np.testing.assert_array_equal(out["port"][1], out["reference"][1])
    for k, col in out["reference"][2].items():
        np.testing.assert_array_equal(out["port"][2][k], col)
    assert calls["port"] == calls["reference"]


# ------------------------------------------ tests/test_cascade.py mirror --
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 1])
def test_vectorized_matches_naive(scenario, seed):
    scores, truth, p_low, p_high, reps, infer, profile = _setup(seed)
    space = evaluate_cascades(scores, truth, p_low, p_high, reps, infer,
                              profile, scenario, trusted=len(reps) - 1)
    rng = np.random.default_rng(seed + 7)
    for i in rng.choice(len(space), size=40, replace=False):
        levels = spec_levels(space, int(i), p_low, p_high)
        acc, _ = simulate_cascade(levels, scores, truth)
        t = cascade_time_naive(levels, scores, reps, infer, profile,
                               scenario)
        assert space.acc[i] == pytest.approx(acc, abs=1e-5), \
            (i, space.kind[i])
        assert space.time_s[i] == pytest.approx(t, rel=1e-5), \
            (i, space.kind[i])


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_matches_naive(scenario, seed):
    scores, truth, p_low, p_high, reps, infer, profile = _setup(seed)
    m, t = scores.shape[0], p_low.shape[1]
    n = m + (m * t) * m + (m * t) ** 2
    space = evaluate_cascades_streaming(
        scores, truth, p_low, p_high, reps, infer, profile, scenario,
        trusted=m - 1, chunk=3, keep="topk", top_k=n, device="cpu")
    assert len(space) == space.evaluated == n
    for i in range(len(space)):
        levels = spec_levels(space, i, p_low, p_high)
        acc, _ = simulate_cascade(levels, scores, truth)
        t = cascade_time_naive(levels, scores, reps, infer, profile,
                               scenario)
        assert space.acc[i] == pytest.approx(acc, abs=1e-5), i
        assert space.time_s[i] == pytest.approx(t, rel=1e-5), i


# ------------------------------ tests/test_transforms_alc_costs.py mirror --
def test_alc_rectangle():
    # single point (acc=1, thr=5) over [0, 1] -> area 5
    assert alc.alc([1.0], [5.0], 0.0, 1.0) == pytest.approx(5.0)
    assert average_throughput([1.0], [5.0], 0.0, 1.0) == pytest.approx(5.0)


def test_alc_step():
    acc = [0.5, 1.0]
    thr = [10.0, 2.0]
    # [0,0.5] at 10 fps, (0.5,1.0] at 2 fps
    assert alc.alc(acc, thr, 0.0, 1.0) == pytest.approx(0.5 * 10 + 0.5 * 2)


def test_speedup_identity_and_ratio():
    acc = [0.6, 0.9]
    thr = [8.0, 1.0]
    assert speedup(acc, thr, acc, thr) == pytest.approx(1.0)
    thr2 = [4.0, 0.5]
    assert speedup(acc, thr, acc, thr2) == pytest.approx(2.0)


def test_best_matching():
    acc = np.array([0.95, 0.90, 0.85])
    thr = np.array([1.0, 5.0, 50.0])
    i = best_matching(acc, thr, 0.9)
    assert acc[i] >= 0.9 and thr[i] == 5.0
    assert best_matching(acc, thr, 0.99) is None


# ------------------------------------------ tests/test_substrate.py mirror --
def test_query_combines_metadata_and_predicates():
    rng = np.random.default_rng(0)
    imgs = rng.random((20, 4, 4, 3)).astype(np.float32)
    corpus = Corpus(images=imgs,
                    metadata={"city": np.array(["detroit", "akron"] * 10)})
    pred = BinaryPredicate("bright",
                           lambda x: (x.mean(axis=(1, 2, 3)) > 0.5
                                      ).astype(np.int32))
    ids = run_query(corpus, metadata_eq={"city": "detroit"},
                    binary_preds=[pred])
    bright = imgs.mean(axis=(1, 2, 3)) > 0.5
    expect = [i for i in range(20) if i % 2 == 0 and bright[i]]
    assert list(ids) == expect
    assert "bright" in corpus.virtual_columns  # cached

