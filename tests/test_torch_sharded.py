"""engine/sharded (the sharded scan engine on shard lanes), sharding/policy
(the row half), launch/mesh (shard devices) and the store's seed/merge:
the port (device="cpu", the plain versions) against the JAX reference (on
the CPU) on the same seeded frames and the same numpy weights. Sizes are
tests/test_sharded_scan.py's: a 210-row 32 px corpus with metadata cam =
row % 2 and rare = row < 5, chunk 64, and the reference's toy cascades a,
b and c; the hot-path, algebra and ingest cases take their reference
tests' sizes.

Tolerances: shard plans, routes, weights, stores, EXPLAIN text, row sets
and per-shard statistics are equal (plans are the same numpy arithmetic;
on these seeds no toy score lies within an f32 rounding of a threshold,
so the last-bit differences of the two packages move no label).
Statistics that differ by design: ``supersteps`` is compared only where
both engines group shards alike (the reference runs min(shards, devices)
shards a group over JAX's devices; the port runs every shard on a lane of
its own), ``n_devices`` counts JAX's forced host devices in the reference
and the one CPU in the port, and ``lanes`` and ``slabs`` are the port's.
"""
import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro.data.synthetic import DEFAULT_PREDICATES  # noqa: E402
from repro.data.synthetic import make_camera_stream  # noqa: E402
from repro.engine import algebra as ja  # noqa: E402
from repro.engine import planner as jplan  # noqa: E402
from repro.engine.ingest import IngestPipeline as JIngest  # noqa: E402
from repro.engine.scan import CompiledCascade as JCascade  # noqa: E402
from repro.engine.scan import ScanEngine as JEngine  # noqa: E402
from repro.engine.scan import VirtualColumnStore as JStore  # noqa: E402
from repro.engine.scan import naive_scan as j_naive  # noqa: E402
from repro.engine.sharded import ShardedScanEngine as JSharded  # noqa: E402
from repro.sharding import policy as jpol  # noqa: E402
from repro_torch.core.pipeline import build_scan_engine  # noqa: E402
from repro_torch.core.selector import Selection  # noqa: E402
from repro_torch.core.transforms import Representation  # noqa: E402
from repro_torch.engine import ShardedScanEngine, pad_rows  # noqa: E402
from repro_torch.engine import algebra as ta  # noqa: E402
from repro_torch.engine import planner as tplan  # noqa: E402
from repro_torch.engine.ingest import IngestPipeline  # noqa: E402
from repro_torch.engine.scan import (CompiledCascade, ScanEngine,  # noqa
                                     VirtualColumnStore)
from repro_torch.engine.sharded import slab_width  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.sharding import policy as tpol  # noqa: E402
from test_fused_hotpath import _dyadic_images  # noqa: E402
from test_fused_hotpath import _linear_cascade as j_linear  # noqa: E402
from test_query_engine import _toy_cascade as j_toy  # noqa: E402
from test_query_engine import _uint8_images  # noqa: E402
from test_torch_algebra import _pairs as algebra_pairs  # noqa: E402
from test_torch_ingest import _toy_heads  # noqa: E402

SHARD_STATS = ("rows_in", "rows_cached", "rows_evaluated", "batches")


# ------------------------------------------------------------- cascades ---
def _twin(jc: JCascade, fns) -> CompiledCascade:
    return CompiledCascade(
        jc.concept, jc.cascade_id,
        [Representation(r.resolution, r.color) for r in jc.reps], fns,
        list(jc.thresholds), cost_s=jc.cost_s, selectivity=jc.selectivity)


def toy(concept, seed, thresholds=None, counters=None):
    """(reference, port) toy cascade (tests/test_query_engine.py's), the
    port's heads on the same numpy weights; ``counters[concept][level]``
    counts each level's invocations in both."""
    jc = j_toy(concept, seed, thresholds)
    fns = _toy_heads(seed)
    if counters is not None:
        def count(fn, li):
            def f(x):
                counters[concept][li] += 1
                return fn(x)
            return f
        jc.model_fns = [count(f, i) for i, f in enumerate(jc.model_fns)]
        fns = [count(f, i) for i, f in enumerate(fns)]
    return jc, _twin(jc, fns)


def linear(concept, seed, resolutions, thresholds, **kw):
    """(reference, port) of tests/test_fused_hotpath.py's linear toy
    cascade (rgb levels at arbitrary resolutions)."""
    jc = j_linear(concept, seed, resolutions, thresholds, **kw)
    r = np.random.default_rng(seed)
    dims = [res * res * 3 for res in resolutions]
    ws = [torch.from_numpy(r.standard_normal((d, 1)).astype(np.float32))
          for d in dims]

    def mk(i):
        def f(x):
            z = (x.reshape(x.shape[0], -1) - 0.5) @ ws[i]
            return torch.sigmoid(z[:, 0] * 60.0 / math.sqrt(dims[i]))
        return f
    return jc, _twin(jc, [mk(i) for i in range(len(resolutions))])


def _split(pairs):
    return [j for j, _ in pairs], [t for _, t in pairs]


def _shard_rows(stats):
    return [[tuple(getattr(s, f) for f in SHARD_STATS) for s in sh.stages]
            for sh in stats.shards]


def _same_shard_stats(t, j):
    """Per-shard per-stage rows, chunks, level rows and level sets equal;
    supersteps where the reference ran every shard in one group."""
    assert _shard_rows(t) == _shard_rows(j)
    assert [s.chunks for s in t.shards] == [s.chunks for s in j.shards]
    assert [s.level_rows for s in t.shards] == \
        [s.level_rows for s in j.shards]
    assert [s.rows_scanned for s in t.shards] == \
        [s.rows_scanned for s in j.shards]
    assert [s.pyramid_levels for s in t.shards] == \
        [s.pyramid_levels for s in j.shards]
    assert t.backend == j.backend
    if j.backend == "lockstep" and j.n_devices >= j.plan.n_shards:
        assert t.supersteps == j.supersteps
    assert t.lanes == (t.plan.n_shards if t.backend == "lockstep" else 1)
    assert t.n_devices == 1          # the one CPU (the reference: JAX's)


@pytest.fixture(scope="module")
def setup():
    imgs = _uint8_images(210, 32, seed=4)
    pairs = [toy("a", 1),
             toy("b", 2, [(0.25, 0.75), (0.3, 0.7), (None, None)]),
             toy("c", 3, [(0.2, 0.8), (0.35, 0.65), (None, None)])]
    jcs, tcs = _split(pairs)
    metadata = {"cam": np.arange(len(imgs)) % 2,
                "rare": (np.arange(len(imgs)) < 5).astype(np.int64)}
    ref = j_naive(imgs, jcs, metadata, {"cam": 0}, chunk=64)
    jres = JEngine(imgs, metadata, chunk=64, jit=False).execute(
        jcs, {"cam": 0})
    assert np.array_equal(jres.indices, ref) and len(ref) > 0
    single = ScanEngine(imgs, metadata, chunk=64, device="cpu").execute(
        tcs, {"cam": 0})
    assert np.array_equal(single.indices, ref)
    return dict(imgs=imgs, jcs=jcs, tcs=tcs, metadata=metadata, ref=ref,
                jres=jres, single=single)


# ------------------------------------------------------ ShardPlan parity --
PLAN_CASES = [  # n_rows, n_shards, strategy, weighted, seed
    (0, 3, "range", False, 0), (1, 1, "hash", True, 1),
    (5, 8, "range", True, 2), (100, 2, "range", False, 3),
    (257, 7, "range", True, 4), (257, 7, "hash", True, 5),
    (300, 16, "hash", False, 6), (64, 4, "hash", False, 7),
]


@pytest.mark.parametrize("n_rows,n_shards,strategy,weighted,seed",
                         PLAN_CASES)
def test_plan_shards_and_route_equal_the_reference(n_rows, n_shards,
                                                   strategy, weighted, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(1000, size=n_rows, replace=False)   # unsorted
    weights = rng.uniform(0.0, 5.0, n_rows) if weighted else None
    got = tpol.plan_shards(ids, n_shards, strategy=strategy, weights=weights)
    want = jpol.plan_shards(ids, n_shards, strategy=strategy,
                            weights=weights)
    assert (got.n_shards, got.strategy) == (want.n_shards, want.strategy)
    assert len(got.shards) == len(want.shards)
    for a, b in zip(got.shards, want.shards):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.weights == want.weights
    assert (got.sizes, got.n_rows, got.balance) == \
        (want.sizes, want.n_rows, want.balance)
    assert np.array_equal(got.all_rows(), want.all_rows())
    assert got.describe() == want.describe()
    assert np.array_equal(tpol.shard_route(ids, n_shards),
                          jpol.shard_route(ids, n_shards))
    assert np.array_equal(tpol._hash_ids(ids), jpol._hash_ids(ids))


def test_validate_and_bad_input_raise_as_the_reference():
    ids = np.arange(10)

    def errors(pol):
        out = []
        dup = pol.ShardPlan(2, "range", (np.arange(5), np.arange(4, 10)),
                            (5.0, 6.0))
        stale = pol.ShardPlan(2, "range", (np.arange(5), np.arange(5, 9)),
                              (5.0, 4.0))
        for call in (lambda: dup.validate(), lambda: stale.validate(ids),
                     lambda: pol.plan_shards(ids, 0),
                     lambda: pol.plan_shards(ids, 2, strategy="modulo"),
                     lambda: pol.shard_route(ids, 0)):
            with pytest.raises(ValueError) as e:
                call()
            out.append(str(e.value))
        return out

    assert errors(tpol) == errors(jpol)
    assert tpol.SHARD_STRATEGIES == jpol.SHARD_STRATEGIES


# ---------------------------------- ShardPlan properties (the mirrors) ---
@settings(max_examples=40, deadline=None)
@given(st.integers(0, 300), st.integers(1, 16),
       st.sampled_from(["range", "hash"]), st.booleans(),
       st.integers(0, 2 ** 31 - 1))
def test_shard_plan_is_exact_partition(n_rows, n_shards, strategy,
                                       weighted, seed):
    """Every row assigned exactly once; shards cover the survivor set."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(1000, size=n_rows, replace=False))
    weights = rng.uniform(0.0, 5.0, n_rows) if weighted else None
    plan = tpol.plan_shards(ids, n_shards, strategy=strategy,
                            weights=weights)
    assert plan.n_shards == n_shards and len(plan.shards) == n_shards
    cat = np.concatenate([s for s in plan.shards])
    assert len(cat) == n_rows
    assert np.array_equal(np.sort(cat), ids)
    for part in plan.shards:
        assert np.array_equal(part, np.sort(part))
    plan.validate(ids)


def test_shard_plan_skew_aware_rebalancing():
    ids = np.arange(100)
    weights = np.where(ids < 10, 100.0, 1.0)
    plan = tpol.plan_shards(ids, 2, strategy="range", weights=weights)
    assert len(plan.shards[0]) < len(plan.shards[1])
    assert plan.balance < 1.2
    uniform = tpol.plan_shards(ids, 2, strategy="range")
    assert [len(s) for s in uniform.shards] == [50, 50]
    perm = np.random.default_rng(0).permutation(100)
    shuffled = tpol.plan_shards(ids[perm], 2, strategy="range",
                                weights=weights[perm])
    for a, b in zip(shuffled.shards, plan.shards):
        assert np.array_equal(a, b)
    assert shuffled.weights == pytest.approx(plan.weights)


def test_shard_plan_hash_is_stable_and_route_agrees():
    ids = np.arange(64)
    a = tpol.plan_shards(ids, 4, strategy="hash")
    b = tpol.plan_shards(ids, 4, strategy="hash")
    route = tpol.shard_route(ids, 4)
    for s, (x, y) in enumerate(zip(a.shards, b.shards)):
        assert np.array_equal(x, y)
        assert np.array_equal(x, ids[route == s])
    with pytest.raises(ValueError):
        tpol.plan_shards(ids, 0)
    with pytest.raises(ValueError):
        tpol.plan_shards(ids, 2, strategy="modulo")


def test_slab_width_and_pad_rows():
    assert [slab_width(n, 256) for n in (1, 16, 17, 100, 129, 256)] == \
        [16, 16, 32, 128, 256, 256]
    assert slab_width(300, 64) == 64
    assert np.array_equal(pad_rows(np.array([4, 9]), 4), [4, 9, 9, 9])


# ------------------------------------------------- store seed and merge --
@settings(max_examples=40, deadline=None)
@given(st.integers(1, 200), st.integers(0, 2 ** 31 - 1))
def test_store_merge_union_never_overwrites(n_rows, seed):
    """Merged store == union of shard stores, a computed entry never
    overwritten, the source untouched — and column for column the
    reference's merge of the same stores."""
    rng = np.random.default_rng(seed)
    cols = {("concept", (0, 1, 2)): (rng.integers(-1, 2, n_rows),
                                     rng.integers(-1, 2, n_rows)),
            ("only-src", (9,)): (None, rng.integers(-1, 2, n_rows))}
    stores = []
    for cls in (VirtualColumnStore, JStore):
        dst, src = cls(n_rows), cls(n_rows)
        for key, (d, s) in cols.items():
            if d is not None:
                dst.column(key)[:] = d
            src.column(key)[:] = s
        dst.merge_from(src)
        stores.append(dst)
    key = ("concept", (0, 1, 2))
    before, src = cols[key]
    got = stores[0].column(key)
    computed = before >= 0
    assert np.array_equal(got[computed], before[computed])
    assert np.array_equal(got[~computed], src[~computed])
    assert np.array_equal(stores[0].column(("only-src", (9,))),
                          cols[("only-src", (9,))][1])
    assert stores[0].keys() == stores[1].keys()
    for k in stores[0].keys():
        assert np.array_equal(stores[0].column(k), stores[1].column(k))


@pytest.mark.parametrize("seed", range(3))
def test_store_seed_from_equals_the_reference(seed):
    """A shard store seeded with its partition's rows holds exactly those
    labels, -1 elsewhere, column for column the reference's seed."""
    rng = np.random.default_rng(seed)
    n = 50
    rows = np.sort(rng.choice(n, size=17, replace=False))
    cols = {(f"c{c}", (c,)): rng.integers(-1, 2, n) for c in range(3)}
    shards = []
    for cls in (VirtualColumnStore, JStore):
        full = cls(n)
        for key, col in cols.items():
            full.column(key)[:] = col
        shard = cls(n)
        shard.seed_from(full, rows)
        shards.append(shard)
    got, want = shards
    assert got.keys() == want.keys() == list(cols)
    for key, col in cols.items():
        assert np.array_equal(got.column(key), want.column(key))
        assert np.array_equal(got.column(key)[rows], col[rows])
        assert (np.delete(got.column(key), rows) == -1).all()


@pytest.mark.parametrize("parallel", [True, False])
def test_merged_store_equals_union_of_shard_work(setup, parallel):
    eng = ShardedScanEngine(setup["imgs"], setup["metadata"], shards=3,
                            chunk=64, device="cpu")
    res = eng.execute(setup["tcs"], {"cam": 0}, parallel=parallel)
    jeng = JSharded(setup["imgs"], setup["metadata"], shards=3, chunk=64,
                    jit=False)
    jeng.execute(setup["jcs"], {"cam": 0}, parallel=parallel)
    for casc, agg in zip(setup["tcs"], res.stats.stages):
        assert eng.store.known_rows(casc.key) == agg.rows_evaluated
        assert agg.rows_evaluated == agg.rows_in - agg.rows_cached
        assert np.array_equal(eng.store.column(casc.key),
                              jeng.store.column(casc.key))


# ------------------------------------------------- differential oracle ---
@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("strategy", ["range", "hash"])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_sharded_differential_oracle(setup, shards, strategy, parallel):
    """Row sets equal to the reference's naive_scan and ScanEngine on both
    backends; the per-shard statistics equal the reference's sharded
    engine's on the same backend."""
    imgs, meta = setup["imgs"], setup["metadata"]
    eng = ShardedScanEngine(imgs, meta, shards=shards, chunk=64,
                            strategy=strategy, device="cpu")
    res = eng.execute(setup["tcs"], {"cam": 0}, parallel=parallel)
    assert np.array_equal(res.indices, setup["ref"])
    assert np.array_equal(res.indices, setup["jres"].indices)
    res.stats.plan.validate(np.where(meta["cam"] == 0)[0])
    jres = JSharded(imgs, meta, shards=shards, chunk=64, strategy=strategy,
                    jit=False).execute(setup["jcs"], {"cam": 0},
                                       parallel=parallel)
    for a, b in zip(res.stats.plan.shards, jres.stats.plan.shards):
        assert np.array_equal(a, b)
    _same_shard_stats(res.stats, jres.stats)
    if parallel:
        # every lane slab at a bucket width; stage 0's are the ingest's
        assert all(b in (16, 32, 64) for _, b in res.stats.slabs)
        assert sum(n for (s, _), n in res.stats.slabs.items() if s == 0) \
            == sum(sh.chunks for sh in res.stats.shards)


def test_shards_exceed_devices_and_uneven_partition(setup):
    """16 shards: the reference runs two groups of 8 over its 8 forced
    devices, the port 16 lanes at once (one superstep a slab step, not
    two); 210/16 is uneven; rows stay exact."""
    imgs, meta = setup["imgs"], setup["metadata"]
    res = ShardedScanEngine(imgs, meta, shards=16, chunk=64,
                            device="cpu").execute(setup["tcs"], {"cam": 0})
    assert np.array_equal(res.indices, setup["ref"])
    assert len(set(res.stats.plan.sizes)) > 1
    assert res.stats.lanes == 16
    jres = JSharded(imgs, meta, shards=16, chunk=64, jit=False).execute(
        setup["jcs"], {"cam": 0})
    _same_shard_stats(res.stats, jres.stats)
    if jres.stats.n_devices < 16:
        assert res.stats.supersteps < jres.stats.supersteps


def test_empty_shards_and_shards_exceeding_survivors(setup):
    imgs, meta = setup["imgs"], setup["metadata"]
    ref = j_naive(imgs, setup["jcs"], meta, {"rare": 1}, chunk=64)
    eng = ShardedScanEngine(imgs, meta, shards=8, chunk=64, device="cpu")
    res = eng.execute(setup["tcs"], {"rare": 1})
    assert np.array_equal(res.indices, ref)
    assert 0 in res.stats.plan.sizes
    for st_, part in zip(res.stats.shards, res.stats.plan.shards):
        if not len(part):
            assert st_.rows_evaluated == 0 and st_.chunks == 0
    none = eng.execute(setup["tcs"], {"cam": 99})
    assert len(none.indices) == 0 and none.stats.rows_evaluated == 0
    assert none.stats.supersteps == 0


def test_sharded_no_duplicate_evaluations_and_cache_hits(setup):
    """Per-stage evaluated rows match the single-shard engine (each row
    evaluated once, on one shard), a same-order re-run invokes the models
    ZERO times and issues no superstep, and a reversed re-plan on another
    shard count is served partly from the merged store — as in the
    reference, on the same counts."""
    imgs, meta = setup["imgs"], setup["metadata"]
    counts = {}
    engines = {}
    for pkg in ("port", "jax"):
        counters = {c: [0, 0, 0] for c in "abc"}
        pairs = [toy("a", 1, counters=counters),
                 toy("b", 2, [(0.25, 0.75), (0.3, 0.7), (None, None)],
                     counters),
                 toy("c", 3, [(0.2, 0.8), (0.35, 0.65), (None, None)],
                     counters)]
        jcs, tcs = _split(pairs)
        if pkg == "port":
            mk = lambda n: ShardedScanEngine(imgs, meta, shards=n,  # noqa
                                             chunk=64, device="cpu")
            cascades = tcs
        else:
            mk = lambda n: JSharded(imgs, meta, shards=n,  # noqa
                                    chunk=64, jit=False)
            cascades = jcs
        eng = mk(3)
        res = eng.execute(cascades, {"cam": 0})
        assert np.array_equal(res.indices, setup["ref"])
        first = {c: list(v) for c, v in counters.items()}
        assert all(v[0] > 0 for v in first.values())
        again = eng.execute(cascades, {"cam": 0})
        assert np.array_equal(again.indices, setup["ref"])
        assert again.stats.rows_evaluated == 0 and again.stats.supersteps == 0
        assert counters == first
        assert all(s.rows_cached == s.rows_in for s in again.stats.stages)
        eng2 = mk(8)
        eng2.store.merge_from(eng.store)
        rres = eng2.execute(cascades[::-1], {"cam": 0})
        assert np.array_equal(rres.indices, setup["ref"])
        assert sum(s.rows_cached for s in rres.stats.stages) > 0
        assert rres.stats.rows_evaluated < res.stats.rows_evaluated
        counts[pkg] = [[(s.rows_in, s.rows_cached, s.rows_evaluated)
                        for s in r.stats.stages] for r in (res, rres)]
        engines[pkg] = res
    single = setup["single"]
    for agg, one in zip(engines["port"].stats.stages, single.stats.stages):
        assert agg.rows_evaluated == one.rows_evaluated
        assert agg.rows_in == one.rows_in
    assert counts["port"] == counts["jax"]


# ------------------------------------------------ planner and factory ----
def test_explain_reports_shard_layout_as_the_reference(setup):
    from repro.core.selector import Selection as JSelection
    imgs, meta = setup["imgs"], setup["metadata"]
    eng = ShardedScanEngine(imgs, meta, shards=4, chunk=64, device="cpu")
    jeng = JSharded(imgs, meta, shards=4, chunk=64, jit=False)
    txt = tplan.PhysicalPlan("CAMERA", {"cam": 0}, [
        tplan.PlannedPredicate(c, Selection(0, 0.9, 100.0), "toy", 0.1)
        for c in setup["tcs"]]).explain(
            n_rows=len(imgs), shard_plan=eng.plan_for(setup["tcs"],
                                                      {"cam": 0}))
    want = jplan.PhysicalPlan("CAMERA", {"cam": 0}, [
        jplan.PlannedPredicate(c, JSelection(0, 0.9, 100.0), "toy", 0.1)
        for c in setup["jcs"]]).explain(
            n_rows=len(imgs), shard_plan=jeng.plan_for(setup["jcs"],
                                                       {"cam": 0}))
    assert txt == want
    assert "sharding: 4 shards (range)" in txt and "balance=" in txt
    for i in range(4):
        assert f"shard {i}:" in txt


def test_build_scan_engine_factory(setup):
    imgs, meta = setup["imgs"], setup["metadata"]
    assert isinstance(build_scan_engine(imgs, meta, device="cpu"),
                      ScanEngine)
    sharded = build_scan_engine(imgs, meta, shards=2, chunk=64,
                                strategy="hash", device="cpu")
    assert isinstance(sharded, ShardedScanEngine)
    assert sharded.strategy == "hash"
    assert np.array_equal(sharded.execute(setup["tcs"], {"cam": 0}).indices,
                          setup["ref"])
    one = build_scan_engine(imgs, meta, shards=1, chunk=64, device="cpu")
    assert isinstance(one, ShardedScanEngine)


def test_shard_devices_round_robin_and_no_card(setup, monkeypatch):
    """On the CPU every shard shares the one CPU; on a host with GPUs the
    shards go round-robin over them (the reference's rule over its
    devices). Without a card the CUDA default raises, as every entry
    point of the port does."""
    assert mesh.host_device_count("cpu") == 1
    assert mesh.shard_devices(5, device="cpu") == [torch.device("cpu")] * 5
    assert mesh.shard_devices(device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh.shard_devices(2)
        with pytest.raises(RuntimeError):
            ShardedScanEngine(setup["imgs"], shards=2)
        with pytest.raises(RuntimeError):
            build_scan_engine(setup["imgs"], shards=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    for flag in ("allow_tf32", "benchmark"):   # resolve_device sets them
        monkeypatch.setattr(torch.backends.cudnn, flag,
                            getattr(torch.backends.cudnn, flag))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    assert mesh.host_device_count() == 3
    devs = mesh.shard_devices(5)
    assert [d.index for d in devs] == [0, 1, 2, 0, 1]
    assert all(d.type == "cuda" for d in devs)
    assert len(mesh.shard_devices()) == 3
    # a bare "cuda" names the current GPU, so a lane given it compares
    # equal to the corpus tensor's device (and gathers from the corpus)
    from repro_torch.engine.sharded import _indexed
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _indexed("cuda") == torch.device("cuda", 1)
    assert _indexed(torch.device("cuda", 2)) == torch.device("cuda", 2)
    assert _indexed("cpu") == torch.device("cpu")


def test_shard_lanes_share_the_device(setup):
    """The port's answer to the reference's lockstep over distinct devices
    (tests/test_sharded_scan.py::test_lockstep_spreads_over_distinct_devices):
    N lanes on one device, every shard in one superstep group."""
    eng = ShardedScanEngine(setup["imgs"], setup["metadata"], shards=8,
                            chunk=64, device="cpu")
    res = eng.execute(setup["tcs"], {"cam": 0})
    assert np.array_equal(res.indices, setup["ref"])
    assert (res.stats.n_devices, res.stats.lanes) == (1, 8)
    assert res.stats.backend == "lockstep" and res.stats.supersteps > 0
    assert len(eng.devices) == 8


# -------------------------------------------------- lazy hot path mirror --
@pytest.fixture(scope="module")
def lazy_setup():
    imgs = _dyadic_images(200, 32, seed=7)
    pairs = [linear("a", 1, [8], [(None, None)], cost_s=1e-4),
             linear("b", 2, [16, 32], [(0.3, 0.7), (None, None)],
                    cost_s=2e-4),
             linear("c", 3, [4, 16], [(0.35, 0.65), (None, None)],
                    cost_s=4e-4)]
    jcs, tcs = _split(pairs)
    metadata = {"cam": np.arange(len(imgs)) % 2}
    jref = JEngine(imgs, metadata, chunk=32, jit=False).execute(
        jcs, {"cam": 0})
    return imgs, jcs, tcs, metadata, jref


@pytest.mark.parametrize("parallel", [True, False])
@pytest.mark.parametrize("shards", [1, 8])
def test_sharded_lazy_bit_identical_and_counters(lazy_setup, shards,
                                                 parallel):
    """Lazy scheduling, both backends: rows equal the serial engines' (the
    port's and the reference's), and the cross-shard level_rows totals
    equal the serial counters on a cold scan."""
    imgs, jcs, tcs, meta, jref = lazy_setup
    ref = ScanEngine(imgs, meta, chunk=32, device="cpu").execute(
        tcs, {"cam": 0})
    assert np.array_equal(ref.indices, jref.indices)
    assert ref.stats.level_rows == jref.stats.level_rows
    eng = ShardedScanEngine(imgs, meta, shards=shards, chunk=32,
                            device="cpu")
    res = eng.execute(tcs, {"cam": 0}, parallel=parallel)
    assert np.array_equal(res.indices, ref.indices)
    assert res.stats.level_rows == ref.stats.level_rows
    jres = JSharded(imgs, meta, shards=shards, chunk=32, jit=False).execute(
        jcs, {"cam": 0}, parallel=parallel)
    _same_shard_stats(res.stats, jres.stats)


def test_monitor_observed_selectivity_feeds_shard_weights(lazy_setup):
    imgs, jcs, tcs, meta, jref = lazy_setup
    eng = ShardedScanEngine(imgs, meta, shards=2, chunk=32, device="cpu")
    jeng = JSharded(imgs, meta, shards=2, chunk=32, jit=False)
    ids = np.where(eng.metadata_mask({"cam": 0}))[0]
    mon = tplan.OnlineReorderer(tcs, min_rows=1)
    mon.observe(tcs[0].key, np.zeros(128, np.int64), marginal=True)
    jmon = jplan.OnlineReorderer(jcs, min_rows=1)
    jmon.observe(jcs[0].key, np.zeros(128, np.int64), marginal=True)
    w_static = eng.row_weights(tcs, ids)
    w_refined = eng.row_weights(tcs, ids, monitor=mon)
    assert np.array_equal(w_static, jeng.row_weights(jcs, ids))
    assert np.array_equal(w_refined, jeng.row_weights(jcs, ids,
                                                      monitor=jmon))
    assert np.allclose(w_refined, tcs[0].cost_s)
    assert w_refined.sum() < w_static.sum()
    plan = eng.plan_for(tcs, ids=ids, monitor=mon)
    jp = jeng.plan_for(jcs, ids=ids, monitor=jmon)
    assert plan.n_shards == 2 and plan.validate(ids) is None
    for a, b in zip(plan.shards, jp.shards):
        assert np.array_equal(a, b)
    res = eng.execute(tcs, {"cam": 0}, monitor=mon)
    assert np.array_equal(res.indices, jref.indices)
    assert mon.n[tcs[0].key] > 128
    assert res.stats.stages[0].rows_evaluated + 128 == mon.n[tcs[0].key]


# ------------------------------------------- algebra and ingest mirrors --
@pytest.mark.parametrize("shards", [1, 8])
def test_sharded_tree_matches_the_reference(shards):
    """tests/test_algebra.py::test_sharded_{one,eight}_shards_matches_naive:
    Or(And(a, Not(b)), c) on cam 0 through execute_tree on a sharded
    engine, against the reference's naive_tree_rows and its engine."""
    from test_torch_algebra import HW, N
    images = _uint8_images(N, HW)
    metadata = {"cam": np.arange(N) % 2,
                "t": np.arange(N, dtype=np.int64) * 3}
    jc, tc = algebra_pairs()
    jt = ja.Or(ja.And(ja.Pred("a"), ja.Not(ja.Pred("b"))), ja.Pred("c"))
    tt = ta.Or(ta.And(ta.Pred("a"), ta.Not(ta.Pred("b"))), ta.Pred("c"))
    want = ja.naive_tree_rows(images, jt, jc, metadata, {"cam": 0},
                              chunk=64)
    jgot = ja.execute_tree(JEngine(images, metadata, chunk=64, jit=False),
                           ja.plan_from_cascades(jt, jc, metadata=metadata,
                                                 metadata_eq={"cam": 0}))
    eng = ShardedScanEngine(images, metadata, shards=shards, chunk=64,
                            device="cpu")
    plan = ta.plan_from_cascades(tt, tc, metadata=metadata,
                                 metadata_eq={"cam": 0})
    got = ta.execute_tree(eng, plan)
    assert np.array_equal(got.indices, want)
    assert np.array_equal(got.indices, jgot.indices)
    assert got.engine_calls == jgot.engine_calls


def _stream_pairs(frames, n, seeds, chunk, **kw):
    """The reference's toy cascades, their port twins and an ingest index
    over ``frames`` in each package."""
    pairs = [toy(c, s) for c, s in seeds]
    jcs, tcs = _split(pairs)
    jp = JIngest(jcs, n, chunk=chunk, **kw)
    tp = IngestPipeline(tcs, n, chunk=chunk, device="cpu", **kw)
    jp.run(frames)
    tp.run(frames)
    return jcs, tcs, jp, tp


@pytest.fixture(scope="module")
def stream():
    """tests/test_ingest.py's stream: 240 frames, toy a, b, c, chunk 64."""
    frames, _, _ = make_camera_stream(DEFAULT_PREDICATES[:3], 240, hw=32,
                                      seed=0)
    jcs, tcs, jp, tp = _stream_pairs(frames, len(frames),
                                     [("a", 1), ("b", 2), ("c", 3)], 64,
                                     skip=True)
    cold = JEngine(frames, chunk=32, jit=False).execute(jcs)
    return frames, jcs, tcs, jp, tp, cold


def test_exact_mode_bit_identical_oracle_sharded(stream):
    """tests/test_ingest.py::test_exact_mode_bit_identical_oracle[8]: exact
    indexed rows on an 8-shard engine == the reference's cold ScanEngine
    == its naive_scan, with fewer rows evaluated than the cold scan."""
    frames, jcs, tcs, jp, tp, cold = stream
    assert np.array_equal(cold.indices, j_naive(frames, jcs, chunk=32))
    eng = ShardedScanEngine(frames, shards=8, chunk=32, device="cpu")
    tp.index.seed_store(eng.store, exact=True)
    surv = tp.index.survivors(np.arange(len(frames)), tcs, exact=True)
    assert np.array_equal(surv, jp.index.survivors(
        np.arange(len(frames)), jcs, exact=True))
    res = eng.execute(tcs, survivors=surv)
    assert np.array_equal(res.indices, cold.indices)
    assert res.stats.rows_evaluated < cold.stats.rows_evaluated


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("shards", [1, 8])
def test_exact_mode_oracle_grid(shards, skip):
    """tests/test_ingest.py::test_exact_mode_oracle_full_grid at its own
    size (150 frames): {shards} x {skip detector}, exact indexed rows on
    the sharded engine == the reference's cold scan == its naive_scan."""
    frames, _, _ = make_camera_stream(DEFAULT_PREDICATES[:3], 150, hw=32,
                                      seed=3)
    jcs, tcs, jp, tp = _stream_pairs(frames, len(frames),
                                     [("a", 11), ("b", 12)], 64, skip=skip)
    cold = JEngine(frames, chunk=32, jit=False).execute(jcs).indices
    assert np.array_equal(cold, j_naive(frames, jcs, chunk=32))
    eng = ShardedScanEngine(frames, shards=shards, chunk=32, device="cpu")
    tp.index.seed_store(eng.store, exact=True)
    surv = tp.index.survivors(np.arange(len(frames)), tcs, exact=True)
    assert np.array_equal(eng.execute(tcs, survivors=surv).indices, cold)


def test_engines_flag_only_stage0_flushes_as_marginal_sharded():
    """tests/test_ingest.py::test_engines_flag_only_stage0_flushes_as_
    marginal[2]: on a 2-shard engine every observe() of the first cascade
    is marginal (the fused ingest slabs), every later one conditional."""
    class Recorder(tplan.OnlineReorderer):
        def __init__(self, cascades):
            super().__init__(cascades, drift_threshold=10.0)
            self.seen = []

        def observe(self, key, labels, *, marginal=False):
            self.seen.append((key, marginal))
            super().observe(key, labels, marginal=marginal)

    imgs = _uint8_images(150, 32, seed=5)
    jcs, tcs = _split([toy("a", 31), toy("b", 32)])
    mon = Recorder(tcs)
    eng = ShardedScanEngine(imgs, shards=2, chunk=32, device="cpu")
    res = eng.execute(tcs, monitor=mon)
    assert np.array_equal(res.indices, j_naive(imgs, jcs, chunk=32))
    by_key = {c.key: {m for k, m in mon.seen if k == c.key} for c in tcs}
    assert by_key[tcs[0].key] == {True}
    assert by_key[tcs[1].key] == {False}
    assert mon.observed(tcs[0].key) is not None
    assert mon.observed(tcs[1].key) is None
    assert mon.conditional(tcs[1].key) is not None


def test_indexed_execute_on_a_sharded_engine(stream):
    """engine/ingest.indexed_execute is duck-typed over the engine: a
    PhysicalPlan carrying the exact index runs unchanged on a sharded
    engine and returns the cold scan's rows."""
    frames, jcs, tcs, jp, tp, cold = stream
    plan = tplan.PhysicalPlan("CAMERA", None, [
        tplan.PlannedPredicate(c, Selection(0, 0.9, 100.0), "toy", 0.1)
        for c in tcs], index=tp.index, index_mode="exact")
    from repro_torch.engine.ingest import indexed_execute
    eng = ShardedScanEngine(frames, shards=4, chunk=32, strategy="hash",
                            device="cpu")
    res = indexed_execute(eng, plan)
    assert np.array_equal(res.indices, cold.indices)
    assert res.stats.rows_evaluated < cold.stats.rows_evaluated
    assert res.stats.lanes == 4
