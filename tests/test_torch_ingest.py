"""engine/ingest, core/pipeline.build_ingest_pipeline, the ingest index in
engine/planner and the camera-stream generators: the port (device="cpu",
the plain versions) against the JAX reference (on the CPU, its plain
path) on the same seeded frames and the same numpy weights. Sizes are
tests/test_ingest.py's: a 240-frame 32 px stream, chunk 64.

Tolerances: generators, aliases, indexed and candidate masks, decided
columns, IngestStats, thresholds and survivor sets are equal (the small
CNN's thresholds sit in score gaps wider than 4e-5, and on these seeds
no toy score lies within an f32 rounding of a threshold, so the last-bit
differences of the two packages move no label);
frame signatures within 1e-7 (f32 means of the same pixels); stage-0
scores within 1e-5 (f32 CNN/linear heads); engine row sets, measured
recall and planning statistics equal.
"""
import dataclasses
import math
from functools import partial

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TahomaCNNConfig as JCfg  # noqa: E402
from repro.core import executor as jx  # noqa: E402
from repro.core.pipeline import \
    build_ingest_pipeline as j_build  # noqa: E402
from repro.core.transforms import Representation as JRep  # noqa: E402
from repro.core.transforms import color_transform as j_color  # noqa: E402
from repro.core.transforms import materialize_pyramid as j_pyr  # noqa
from repro.data import synthetic as jsyn  # noqa: E402
from repro.engine import ingest as jing  # noqa: E402
from repro.engine import planner as jplan  # noqa: E402
from repro.engine.scan import CompiledCascade as JCascade  # noqa: E402
from repro.engine.scan import ScanEngine as JEngine  # noqa: E402
from repro.engine.scan import naive_scan as j_naive  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.core import executor as tx  # noqa: E402
from repro_torch.core.pipeline import build_ingest_pipeline  # noqa: E402
from repro_torch.core.selector import Selection  # noqa: E402
from repro_torch.core.transforms import Representation  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.engine import planner as tplan  # noqa: E402
from repro_torch.engine.ingest import (CandidateIndex,  # noqa: E402
                                       IngestPipeline, frame_signature,
                                       indexed_execute)
from repro_torch.engine.scan import (CompiledCascade,  # noqa: E402
                                     ScanEngine, naive_scan)
from repro_torch.models import cnn as tcnn  # noqa: E402
from test_query_engine import _toy_cascade as j_toy  # noqa: E402

SPECS = jsyn.DEFAULT_PREDICATES[:3]
N, HW, CHUNK = 240, 32, 64
SCORE_TOL = 1e-5


# ------------------------------------------------------------- cascades ---
def _toy_heads(seed, hw=HW):
    """The reference toy cascade's three linear heads in torch, on the
    same numpy weights (tests/test_query_engine.py:_toy_cascade)."""
    r = np.random.default_rng(seed)
    dims = [(hw // 4) ** 2, (hw // 2) ** 2, hw * hw * 3]
    ws = [torch.from_numpy(r.standard_normal((d, 1)).astype(np.float32))
          for d in dims]

    def mk(i):
        def f(x):
            z = (x.reshape(x.shape[0], -1) - 0.5) @ ws[i]
            return torch.sigmoid(z[:, 0] * 60.0 / math.sqrt(dims[i]))
        return f
    return [mk(0), mk(1), mk(2)]


def toy_pair(concept, seed, hw=HW):
    """(reference CompiledCascade, port CompiledCascade) of one toy
    cascade."""
    jc = j_toy(concept, seed, hw=hw)
    reps = [Representation(r.resolution, r.color) for r in jc.reps]
    tc = CompiledCascade(concept, ("toy", seed), reps, _toy_heads(seed, hw),
                         list(jc.thresholds), cost_s=jc.cost_s,
                         selectivity=jc.selectivity)
    return jc, tc


def _gap_mid(s, lo_q, hi_q):
    """Midpoint of the widest gap between sorted scores inside the
    (lo_q, hi_q) quantile band: a threshold no score lies near."""
    s = np.sort(s)
    a, b = int(len(s) * lo_q), int(len(s) * hi_q)
    k = a + int(np.argmax(np.diff(s[a:b + 1])))
    assert s[k + 1] - s[k] > 4 * SCORE_TOL
    return float((s[k] + s[k + 1]) / 2)


def stage0_pair(concept, seed, frames):
    """A two-level cascade whose level 0 is a small Tahoma CNN (1 conv
    layer, 16 px gray, pooled sizes even) carried across with
    ``params_from_jax``, with its kernel-foldable Stage0 (and int8 copy)
    in both packages, and the toy cascade's 32 px rgb head as its final level.
    Level-0 thresholds sit in wide gaps of the CNN's scores on
    ``frames``."""
    cfg = JCfg(1, 4, 8, input_hw=16, input_channels=1)
    p = jcnn.init_cnn(jax.random.PRNGKey(seed), cfg)
    tp = tcnn.params_from_jax(jax.tree.map(np.asarray, p), "cpu")
    rep = JRep(16, "gray")
    lvl = j_pyr(jax.numpy.asarray(frames), [16])[16]
    s = np.asarray(jcnn.cnn_predict_proba(p, j_color(lvl, "gray")))
    ths = [(_gap_mid(s, 0.2, 0.45), _gap_mid(s, 0.55, 0.8)), (None, None)]
    jt = j_toy(concept, seed)
    jc = JCascade(concept, ("s0", seed), [rep, jt.reps[2]],
                  [partial(jcnn.cnn_predict_proba, p), jt.model_fns[2]],
                  ths, stage0=jx.Stage0(p, rep, jcnn.quantize_cnn(p)))
    trep = Representation(16, "gray")
    tc = CompiledCascade(
        concept, ("s0", seed), [trep, Representation(HW, "rgb")],
        [partial(tcnn.cnn_predict_proba, tp), _toy_heads(seed)[2]],
        ths, stage0=tx.Stage0(tp, trep, tcnn.quantize_cnn(tp)))
    return jc, tc


@pytest.fixture(scope="module")
def stream():
    frames, labels, scene = jsyn.make_camera_stream(SPECS, N, hw=HW, seed=0)
    toy = [toy_pair(c, s) for c, s in [("a", 1), ("b", 2), ("c", 3)]]
    s0 = [stage0_pair("a", 4, frames)] + toy[1:]
    return dict(frames=frames, labels=labels, scene=scene,
                casc={"toy": toy, "stage0": s0})


def _pipes(stream, kind, *, use_kernel=None, **kw):
    pairs = stream["casc"][kind]
    jp = jing.IngestPipeline([j for j, _ in pairs], N, chunk=CHUNK, **kw)
    tp = IngestPipeline([t for _, t in pairs], N, chunk=CHUNK,
                        use_kernel=use_kernel, device="cpu", **kw)
    jp.run(stream["frames"])
    tp.run(stream["frames"])
    return jp, tp, pairs


@pytest.fixture(scope="module")
def built(stream):
    """The toy-cascade index in both packages (pinned threshold)."""
    return _pipes(stream, "toy")


# ---------------------------------------------------------- generators ----
GEN_CASES = [
    ("make_camera_stream", (SPECS, N), dict(hw=HW, seed=0)),
    ("make_camera_stream", (SPECS[:2], 64), dict(hw=16, seed=5, hold_max=1,
                                                jitter=0)),
    ("make_camera_stream", (SPECS, 96), dict(hw=32, seed=2, hold_max=6,
                                             jitter=2, positive_rate=0.3)),
    ("make_two_camera_corpus", (SPECS[:2], 48), dict(hw=16, seed=3, corr=0.7,
                                                     dt_max=2)),
    ("make_two_camera_corpus", (SPECS, 64), dict(hw=32, seed=0)),
]


@pytest.mark.parametrize("name,args,kw", GEN_CASES)
def test_generators_equal_the_reference(name, args, kw):
    got = getattr(tsyn, name)(*args, **kw)
    want = getattr(jsyn, name)(*args, **kw)
    flat_g = jax.tree.leaves(got)
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("res", [8, 5, 64])
def test_frame_signature_matches(stream, res):
    f = stream["frames"][:50]
    np.testing.assert_allclose(frame_signature(f, res),
                               jing.frame_signature(f, res), atol=1e-7,
                               rtol=0)


# ------------------------------------------------------------- the index --
def _assert_same_index(jp, tp, pairs):
    ji, ti = jp.index, tp.index
    assert np.array_equal(ti.alias, ji.alias)
    assert np.array_equal(ti.indexed, ji.indexed)
    assert ti.concepts == ji.concepts
    assert dataclasses.asdict(tp.stats) == dataclasses.asdict(jp.stats)
    assert tp.skip_threshold == jp.skip_threshold
    for c in ji.concepts:
        assert np.array_equal(ti.candidates[c], ji.candidates[c])
        js, ts = ji.scores[c], ti.scores[c]
        assert np.array_equal(np.isnan(ts), np.isnan(js))
        ok = ~np.isnan(js)
        np.testing.assert_allclose(ts[ok], js[ok], atol=SCORE_TOL, rtol=0)
    assert ti.decided.keys() == ji.decided.keys()
    for k in ji.decided.keys():
        assert np.array_equal(ti.decided.column(k), ji.decided.column(k))


INDEX_CASES = [  # cascades, use_kernel, pipeline knobs
    ("toy", None, dict(skip=True)),
    ("toy", None, dict(skip=True, skip_threshold=None)),
    ("toy", None, dict(skip=False, top_k=1, prune_margin=0.5)),
    ("stage0", None, dict(skip=True)),
    ("stage0", True, dict(skip=True, skip_threshold=None, top_k=2)),
    ("stage0", True, dict(skip=True, int8=True)),
]


@pytest.mark.parametrize("kind,use_kernel,kw", INDEX_CASES)
def test_index_equals_the_reference(stream, kind, use_kernel, kw):
    jp, tp, pairs = _pipes(stream, kind, use_kernel=use_kernel, **kw)
    _assert_same_index(jp, tp, pairs)
    scene = stream["scene"]
    # aliases never cross a scene; only references were scored
    assert np.array_equal(scene[tp.index.alias], scene)
    assert tp.stats.stage0_scores == tp.stats.refs * len(pairs)
    if kw.get("skip_threshold", 0.008) is None:
        calib = tp.calib_frames
        assert np.array_equal(tp.index.alias[:calib], np.arange(calib))


def test_calibrate_threshold_equals_the_reference(stream):
    sigs = frame_signature(stream["frames"])
    diffs = np.abs(sigs[1:] - sigs[:-1]).mean(axis=(1, 2))
    rng = np.random.default_rng(0)
    cases = [diffs, diffs[:48], diffs[:7], np.linspace(0.01, 0.02, 30),
             np.concatenate([[0.0, 0.0], 1e-3 * rng.random(20),
                             0.2 + rng.random(6)])]
    for d in cases:
        assert IngestPipeline.calibrate_threshold(d) == \
            jing.IngestPipeline.calibrate_threshold(d)


def test_streaming_granularity_invariant(stream, built):
    _, tp, pairs = built
    ragged = IngestPipeline([t for _, t in pairs], N, chunk=CHUNK,
                            device="cpu")
    ids = np.arange(N)
    frames = stream["frames"]
    for lo, hi in [(0, 7), (7, 64), (64, 65), (65, 200), (200, N)]:
        ragged.ingest(frames[lo:hi], ids[lo:hi])
    assert np.array_equal(ragged.index.alias, tp.index.alias)
    for c in tp.index.concepts:
        assert np.array_equal(ragged.index.candidates[c],
                              tp.index.candidates[c])
    for k in tp.index.decided.keys():
        assert np.array_equal(ragged.index.decided.column(k),
                              tp.index.decided.column(k))


# ------------------------------------------------------- exact and approx -
@pytest.mark.parametrize("kind", ["toy", "stage0"])
def test_exact_mode_rows_equal_cold_naive_and_reference(stream, kind):
    jp, tp, pairs = _pipes(stream, kind)
    frames = stream["frames"]
    jcs, tcs = [j for j, _ in pairs], [t for _, t in pairs]
    plan = tplan.PhysicalPlan("CAMERA", {}, [
        tplan.PlannedPredicate(c, Selection(0, 0.9, 100.0), "toy", 0.1)
        for c in tcs], index=tp.index, index_mode="exact")
    res = indexed_execute(ScanEngine(frames, chunk=32, device="cpu"), plan)
    cold = ScanEngine(frames, chunk=32, device="cpu").execute(tcs)
    assert np.array_equal(res.indices, cold.indices)
    assert np.array_equal(res.indices,
                          naive_scan(frames, tcs, chunk=32, device="cpu"))
    ref = JEngine(frames, chunk=32).execute(jcs).indices
    assert np.array_equal(res.indices, ref)
    assert np.array_equal(ref, j_naive(frames, jcs, chunk=32))
    # the reference's own indexed run evaluates exactly as many rows
    jplanned = jplan.PhysicalPlan("CAMERA", {}, [
        jplan.PlannedPredicate(c, Selection(0, 0.9, 100.0), "toy", 0.1)
        for c in jcs], index=jp.index, index_mode="exact")
    jres = jing.indexed_execute(JEngine(frames, chunk=32), jplanned)
    assert res.stats.rows_evaluated == jres.stats.rows_evaluated
    assert res.stats.rows_evaluated < cold.stats.rows_evaluated


def test_approx_mode_recall_and_survivors_equal(stream, built):
    jp, tp, pairs = built
    ids = np.arange(N)
    tcs, jcs = [t for _, t in pairs], [j for j, _ in pairs]
    for exact in (True, False):
        assert np.array_equal(tp.index.survivors(ids, tcs, exact=exact),
                              jp.index.survivors(ids, jcs, exact=exact))
    for k, c in enumerate(tp.index.concepts):
        truth = stream["labels"][:, k]
        assert tp.index.measured_recall(c, truth) == \
            jp.index.measured_recall(c, truth)
        assert tp.index.measured_recall(c, truth, ids[::3]) == \
            jp.index.measured_recall(c, truth, ids[::3])
    eng = ScanEngine(stream["frames"], chunk=32, device="cpu")
    assert tp.index.seed_store(eng.store, exact=False) == \
        jp.index.seed_store(JEngine(stream["frames"], chunk=32).store,
                            exact=False)


def test_planning_stats_equal(built):
    jp, tp, pairs = built
    for (jc, tc) in pairs:
        for pre in (True, False):
            for base in (0.1, 0.5, 0.9):
                assert tp.index.planning_stats(tc.key, base,
                                               prefilter=pre) == \
                    jp.index.planning_stats(jc.key, base, prefilter=pre)
    assert tp.index.planning_stats(("nope", ()), 0.4) == (1.0, 0.4)
    assert ("nope", ()) not in set(tp.index.decided.keys())


def test_decided_rows_invoke_zero_models(stream, built):
    _, tp, pairs = built
    tcs = [t for _, t in pairs]
    decided_all = np.ones(N, bool)
    for c in tcs:
        decided_all &= tp.index.decided.column(c.key) >= 0
    rows = np.where(decided_all)[0]
    assert len(rows) > 4
    eng = ScanEngine(stream["frames"], chunk=32, device="cpu")
    tp.index.seed_store(eng.store, exact=True)
    res = eng.scan_rows(tcs, rows)
    assert res.stats.rows_evaluated == 0 and res.stats.chunks == 0
    assert all(s.batches == 0 for s in res.stats.stages)


# ------------------------------------------------------------- planner ----
def test_plan_carries_index_and_explains_it(built):
    jp, tp, pairs = built
    mk = [(tplan, tp, [t for _, t in pairs]),
          (jplan, jp, [j for j, _ in pairs])]
    txt = []
    for mod, pipe, cs in mk:
        plan = mod.PhysicalPlan("CAMERA", {}, [
            mod.PlannedPredicate(c, Selection(0, 0.9, 100.0), "toy", 0.1)
            for c in cs], index=pipe.index, index_mode="approx")
        txt.append([ln for ln in plan.explain(n_rows=N).splitlines()
                    if "ingest index:" in ln])
    assert txt[0] == txt[1] and len(txt[0]) == 1
    assert "skip-aliased" in txt[0][0]


def test_plan_query_rejects_unknown_index_mode():
    with pytest.raises(ValueError, match="index mode"):
        tplan.plan_query({}, tplan.QuerySpec(metadata_eq={}, predicates=[]),
                         index_mode="fuzzy")


def test_ingest_factory(built):
    _, _, pairs = built
    tcs = [t for _, t in pairs]
    pipe = build_ingest_pipeline({c.concept: c for c in tcs}, N, chunk=32,
                                 skip=False, device="cpu")
    assert isinstance(pipe, IngestPipeline)
    assert [c.concept for c in pipe.cascades] == ["a", "b", "c"]
    pipe = build_ingest_pipeline(tcs, N, chunk=32, skip_threshold=None,
                                 calib_frames=24, top_k=2, device="cpu")
    ref = j_build([j for j, _ in pairs], N, chunk=32, skip_threshold=None,
                  calib_frames=24, top_k=2)
    for attr in ("chunk", "skip", "skip_threshold", "calib_frames",
                 "skip_res", "int8"):
        assert getattr(pipe, attr) == getattr(ref, attr)
    assert pipe.index.top_k == ref.index.top_k == 2
    # entry points run on the card unless the caller asks for the CPU
    if torch.cuda.is_available():
        assert IngestPipeline(tcs, N).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            IngestPipeline(tcs, N)


# ----------------------------------------------------------- persistence --
def test_candidate_index_roundtrip(tmp_path, built):
    _, tp, pairs = built
    tcs = [t for _, t in pairs]
    token = (float(N), 0.25)
    p = tmp_path / "index.npz"
    tp.index.save(p, token)
    back = CandidateIndex.load(p, token)
    ids = np.arange(N)
    for exact in (True, False):
        assert np.array_equal(back.survivors(ids, tcs, exact=exact),
                              tp.index.survivors(ids, tcs, exact=exact))
    for k in tp.index.decided.keys():
        assert np.array_equal(back.decided.column(k),
                              tp.index.decided.column(k))
    assert back.cascade_keys == tp.index.cascade_keys
    for c in tp.index.concepts:
        assert np.array_equal(back.scores[c], tp.index.scores[c],
                              equal_nan=True)
    with pytest.raises(ValueError, match="different corpus"):
        CandidateIndex.load(p, (float(N - 1), 0.25))
