"""serve/{scheduler,repcache,batcher,service}, engine/scan's repcache hook,
``make_batch_runner`` and ``merge_rows_from``, and
core/pipeline.build_cascade_service: the port (device="cpu", the plain
versions) against the JAX reference (on the CPU, ``jit=False``) on the
same fake-clock request streams, the same seeded frames and the same
numpy weights — the mirror of tests/test_serve_async.py. Sizes are that
file's: a 210-row 32 px corpus, the reference's toy cascades a and b, and
a cascade whose level 0 is a tiny Tahoma CNN carried across with
``params_from_jax`` (tests/test_torch_ingest.py's ``stage0_pair``), so the
from-base flush runs the stage-0 kernel's plain version.

Tolerances: none. Results (labels and typed ``Shed``/``TimedOut``),
delivery order, completion times, every ``ServiceStats`` counter,
``summary()`` (apart from ``devices``, which counts JAX's forced host
devices in the reference and the one CPU here, and ``lanes``, the
port's), deadline-wheel state, repcache statistics and contents, store
columns, corpus tokens and save/load round trips are equal: on these
seeds no score lies within an f32 rounding of a threshold, so the
last-bit differences of the two packages move no label. The reference
service runs on 1, 2 or 8 of JAX's 8 forced host devices
(tests/conftest.py); the port's on as many lanes.
"""
import dataclasses
import inspect
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.engine import planner as jplan  # noqa: E402
from repro.engine.ingest import IngestPipeline as JIngest  # noqa: E402
from repro.engine.scan import ScanEngine as JEngine  # noqa: E402
from repro.engine.scan import VirtualColumnStore as JStore  # noqa: E402
from repro.serve import AsyncCascadeService as JService  # noqa: E402
from repro.serve import CascadeService as JSync  # noqa: E402
from repro.serve import DeadlineWheel as JWheel  # noqa: E402
from repro.serve import ManualClock as JClock  # noqa: E402
from repro.serve import RepresentationCache as JCache  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.serve.repcache import corpus_token as j_token  # noqa: E402
from repro_torch.core.pipeline import (build_cascade_service,  # noqa: E402
                                       build_scan_engine)
from repro_torch.engine import planner as tplan  # noqa: E402
from repro_torch.engine.ingest import IngestPipeline  # noqa: E402
from repro_torch.engine.scan import (ScanEngine,  # noqa: E402
                                     VirtualColumnStore, make_batch_runner)
from repro_torch.serve import (AsyncCascadeService, CascadeService,  # noqa
                               DeadlineWheel, ManualClock,
                               RepresentationCache, Request)
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.repcache import corpus_token  # noqa: E402
from test_query_engine import _uint8_images  # noqa: E402
from test_torch_ingest import stage0_pair  # noqa: E402
from test_torch_sharded import toy  # noqa: E402
from test_torch_slice import SPECS, _pinned, world  # noqa: E402,F401

class JSynced(JService):
    """The reference service, its labels computed by the time it asks
    whether they are ready. JAX dispatches asynchronously, so on a busy
    machine ``is_ready()`` can be False at one poll and True at the next,
    which moves a delivery to another (fake-clock) instant; the port's
    CPU labels are always ready. Only real JAX arrays are waited for:
    the fault plans' proxies (slow, never ready) keep their readiness."""

    def _ready(self, labels):
        inner = getattr(labels, "_labels", labels)
        if isinstance(inner, jax.Array):
            inner.block_until_ready()
        return super()._ready(labels)


J = SimpleNamespace(name="jax", Service=JSynced, Clock=JClock,
                    Request=JRequest, Cache=JCache, Engine=JEngine,
                    kw=dict(jit=False))
T = SimpleNamespace(name="torch", Service=AsyncCascadeService,
                    Clock=ManualClock, Request=Request,
                    Cache=RepresentationCache, Engine=ScanEngine,
                    kw=dict(device="cpu"))
B_THS = [(0.25, 0.75), (0.3, 0.7), (None, None)]


@pytest.fixture(scope="module")
def corpus():
    """The 210-row corpus and {package name: {concept: cascade}}."""
    imgs = _uint8_images(210, 32, seed=4)
    pairs = {"a": toy("a", 1), "b": toy("b", 2, B_THS),
             "s": stage0_pair("s", 5, imgs)}
    return imgs, {"jax": {c: p[0] for c, p in pairs.items()},
                  "torch": {c: p[1] for c, p in pairs.items()}}


def _stream(n, n_rows, seed=3, concepts=("a", "b", "s")):
    """Mixed request stream with repeats: (concept, row) pairs."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n)
    return [(concepts[i % len(concepts)], int(rows[i])) for i in range(n)]


def _result(r):
    """A request's result, comparable across the packages."""
    res = r.result
    if res is None or isinstance(res, int):
        return res
    return type(res).__name__, res.reason


def _serve(pkg, imgs, cascades, stream, *, dt=0.0005, poll=True,
           cache=False, drain=True, **kw):
    """Build ``pkg``'s service on a fake clock and feed it ``stream``,
    advancing the clock by ``dt`` (and polling) after every submit."""
    clk = pkg.Clock()
    svc = pkg.Service(imgs, cascades[pkg.name], clock=clk,
                      repcache=pkg.Cache() if cache else kw.pop(
                          "repcache", None), **pkg.kw, **kw)
    reqs = []
    for i, (c, row) in enumerate(stream):
        r = pkg.Request(i, row)
        svc.submit(c, r)
        reqs.append(r)
        if dt:
            clk.advance(dt)
        if poll:
            svc.poll()
    if drain:
        svc.drain()
    return clk, svc, reqs


def _stats(st):
    d = dataclasses.asdict(st)
    d["latencies"] = list(d["latencies"])
    return d


def _summary(svc):
    return {k: v for k, v in svc.summary().items()
            if k not in ("devices", "lanes")}


def _same_cache(t, j):
    assert t.stats() == j.stats()
    assert list(t._od) == list(j._od)
    got = dict(t.items())
    for k, v in j._od.items():
        assert np.array_equal(got[k], v), k


def _same_store(t, j):
    assert t.keys() == j.keys()
    for k in j.keys():
        assert np.array_equal(t.column(k), j.column(k)), k


def assert_same(t, j):
    """(svc, reqs) of the port and of the reference: equal request for
    request and counter for counter."""
    (tsvc, treqs), (jsvc, jreqs) = t, j
    assert [_result(r) for r in treqs] == [_result(r) for r in jreqs]
    assert [r.t_done for r in treqs] == [r.t_done for r in jreqs]
    assert list(tsvc.delivered) == list(jsvc.delivered)
    assert {c: _stats(s) for c, s in tsvc.stats.items()} == \
        {c: _stats(s) for c, s in jsvc.stats.items()}
    assert _summary(tsvc) == _summary(jsvc)
    assert tsvc.summary()["lanes"] == tsvc.n_shards
    assert (len(tsvc.wheel), tsvc.wheel.stored_entries,
            tsvc.wheel.compactions, tsvc.wheel.next_deadline()) == \
        (len(jsvc.wheel), jsvc.wheel.stored_entries,
         jsvc.wheel.compactions, jsvc.wheel.next_deadline())
    _same_store(tsvc.store, jsvc.store)
    for ts, js in zip(tsvc._shard_stores, jsvc._shard_stores):
        _same_store(ts, js)
    if jsvc.repcache is not None:
        _same_cache(tsvc.repcache, jsvc.repcache)


def _both(imgs, cascades, stream, **kw):
    """The same stream through both packages' services, checked equal;
    returns the port's (svc, reqs)."""
    _, tsvc, treqs = _serve(T, imgs, cascades, stream, **kw)
    _, jsvc, jreqs = _serve(J, imgs, cascades, stream, **kw)
    assert_same((tsvc, treqs), (jsvc, jreqs))
    return tsvc, treqs


def _column(imgs, casc, rows):
    """Labels of ``rows`` under one cascade, from the port's scan."""
    eng = ScanEngine(imgs, chunk=64, device="cpu")
    eng.scan_rows([casc], np.unique(rows))
    return eng.store.column(casc.key)


# ======================================================== scheduler =======
def test_scheduler_is_the_reference_module_verbatim():
    """serve/scheduler.py is pure Python, copied: the two files' code is
    the same text."""
    assert inspect.getsource(tsched) == inspect.getsource(jsched)


def test_manual_clock():
    clk = ManualClock(5.0)
    assert clk() == 5.0
    assert clk.advance(0.25) == 5.25 and clk() == 5.25
    with pytest.raises(ValueError):
        clk.advance(-1.0)


@pytest.mark.parametrize("granularity,horizon", [(0.001, 0.05),
                                                  (0.01, 5.0)])
def test_deadline_wheel_matches_reference_on_random_churn(granularity,
                                                          horizon):
    """schedule / cancel / pop_due / next_deadline in a seeded random mix
    (re-schedules, far-future cancels that force compaction): the same
    due keys in the same order, live counts, stored entries and
    compactions after every operation."""
    rng = np.random.default_rng(7)
    tw, jw = DeadlineWheel(granularity), JWheel(granularity)
    now = 0.0
    for step in range(3000):
        op = rng.integers(0, 10)
        key = ("k", int(rng.integers(0, 40)))
        if op < 5:
            d = now + float(rng.uniform(0, horizon)) \
                + (1e6 if rng.uniform() < 0.2 else 0.0)
            tw.schedule(key, d)
            jw.schedule(key, d)
        elif op < 8:
            tw.cancel(key)
            jw.cancel(key)
        else:
            now += float(rng.uniform(0, horizon / 4))
            assert tw.pop_due(now) == jw.pop_due(now)
        assert (len(tw), tw.stored_entries, tw.compactions,
                tw.next_deadline()) == (len(jw), jw.stored_entries,
                                        jw.compactions, jw.next_deadline())
    assert tw.compactions > 0


def test_deadline_wheel_due_order_and_cancel():
    w = DeadlineWheel(granularity=0.01)
    w.schedule("x", 1.00)
    w.schedule("y", 0.50)
    w.schedule("z", 2.00)
    assert len(w) == 3 and w.next_deadline() == 0.50
    assert w.pop_due(0.49) == []
    assert w.pop_due(1.5) == ["y", "x"]          # deadline order
    w.cancel("z")
    assert w.pop_due(10.0) == [] and len(w) == 0
    assert w.next_deadline() is None


# ============================================ representation cache ========
def _cache_ops(cache, rng_seed=0):
    """One seeded mix of put / get / put_rows / lookup_rows on a cache;
    returns what the reads saw."""
    rng = np.random.default_rng(rng_seed)
    seen = []
    for step in range(300):
        op = rng.integers(0, 4)
        row = int(rng.integers(0, 24))
        if op == 0:
            cache.put(row, 4, rng.random((4, 4, 3)).astype(np.float32))
        elif op == 1:
            got = cache.get(row, 4)
            seen.append(None if got is None else np.asarray(got).copy())
        elif op == 2:
            ids = rng.integers(0, 24, 3)
            cache.put_rows(ids, 8, rng.random((3, 8, 8, 3)).astype(
                np.float32))
        else:
            ids = rng.integers(0, 24, 2)
            got = cache.lookup_rows(ids, [4, 8])
            seen.append(None if got is None else
                        {r: np.asarray(v).copy() for r, v in got.items()})
    return seen


@pytest.mark.parametrize("budget", [192 * 5, 64 << 20])
def test_repcache_matches_reference(budget):
    """The same operations on both caches (a budget that evicts and one
    that does not): the same reads, LRU order, bytes, entries and hit,
    miss, insert and eviction counts."""
    t, j = RepresentationCache(budget), JCache(budget)
    seen_t, seen_j = _cache_ops(t), _cache_ops(j)
    assert len(seen_t) == len(seen_j)
    for a, b in zip(seen_t, seen_j):
        if isinstance(b, dict):
            assert set(a) == set(b)
            assert all(np.array_equal(a[r], b[r]) for r in b)
        else:
            assert (a is None and b is None) or np.array_equal(a, b)
    _same_cache(t, j)
    assert t.nbytes == j.nbytes


def test_repcache_entries_are_copies_and_own_their_storage():
    cache = RepresentationCache()
    block = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    cache.put_rows([10, 11], 4, block)
    block[:] = -1.0                               # caller mutates its block
    got = cache.get(10, 4)
    assert got is not None and float(got[0, 0, 0]) == 0.0
    # a tensor block (a flush's levels) is copied too: no entry is a view
    # into it, and none pins it
    tblock = torch.arange(2 * 4 * 4 * 3, dtype=torch.float32).reshape(
        2, 4, 4, 3)
    cache.put_rows([20, 21], 4, tblock)
    tblock.fill_(-1.0)
    entry = cache.get(21, 4)
    assert float(entry[0, 0, 0]) == 48.0
    # entries are slots of the cache's own slab, not views of a block
    slab = cache._slabs[4].untyped_storage().data_ptr()
    assert slab not in (tblock.untyped_storage().data_ptr(),
                        entry.untyped_storage().data_ptr())
    assert cache.device == torch.device("cpu")
    before = cache.nbytes
    cache.put(10, 4, np.zeros((4, 4, 3), np.float32))
    assert cache.nbytes == before
    assert cache.nbytes == 4 * 4 * 4 * 3 * 4


def test_repcache_lookup_rows_all_or_none_accounting():
    cache = RepresentationCache()
    lvl = np.zeros((4, 4, 3), np.float32)
    cache.put(0, 4, lvl)
    cache.put(1, 4, lvl)
    assert cache.lookup_rows([0, 1, 2], [4]) is None   # row 2 missing
    assert cache.misses == 3 and cache.hits == 0
    cache.put(2, 4, lvl)
    out = cache.lookup_rows([0, 1, 2], [4])
    assert out is not None and out[4].shape == (3, 4, 4, 3)
    assert cache.hits == 3
    with pytest.raises(ValueError):
        RepresentationCache(budget_bytes=0)


@pytest.mark.parametrize("n", [12, 33, 210])
def test_corpus_token_equals_reference(corpus, n):
    """The token of the same pixels: numpy in, a CPU tensor in, and a
    strided tensor in all give the reference's token."""
    imgs = corpus[0][:n]
    want = j_token(imgs)
    assert corpus_token(imgs) == want
    assert corpus_token(torch.from_numpy(imgs.copy())) == want
    padded = torch.zeros((n, 2, 32, 32, 3))
    padded[:, 0] = torch.from_numpy(imgs)
    assert corpus_token(padded[:, 0]) == want
    assert corpus_token(imgs[:-1]) != want


def test_repcache_and_store_save_load_round_trip(tmp_path, corpus):
    """tests/test_ingest.py::test_repcache_roundtrip and the store's
    snapshot, each saved by the port and loaded by both packages (and
    the other way): the same entries, LRU order, bytes and columns; a
    different corpus's token refuses to load."""
    imgs = corpus[0][:12]
    rng = np.random.default_rng(0)
    caches = []
    for pkg_cache, tok in ((RepresentationCache, corpus_token),
                           (JCache, j_token)):
        c = pkg_cache(1 << 20)
        c.bind_corpus(tok(imgs))
        for row in range(12):
            c.put(row, 8, rng.random((8, 8, 3)).astype(np.float32))
        caches.append(c)
    t, _ = caches
    p = tmp_path / "repcache.npz"
    t.save(p)
    for load in (RepresentationCache.load, JCache.load):
        back = load(p, corpus_token(imgs))
        assert list(back._od) == list(t._od) and back.nbytes == t.nbytes
        for row in range(12):
            assert np.array_equal(back.get(row, 8), t.get(row, 8))
        with pytest.raises(ValueError, match="different corpus"):
            load(p, corpus_token(imgs[:-1]))
    pj = tmp_path / "jcache.npz"
    caches[1].save(pj)
    _same_cache(RepresentationCache.load(pj, j_token(imgs)),
                JCache.load(pj, j_token(imgs)))
    # LRU order survives the round trip
    back = RepresentationCache.load(p, corpus_token(imgs))
    t.put(99, 8, np.zeros((8, 8, 3), np.float32))
    back.put(99, 8, np.zeros((8, 8, 3), np.float32))
    assert list(t._od) == list(back._od)
    store = VirtualColumnStore(12)
    store.record(("a", ("toy", 1)), np.array([0, 4]), [1, 0])
    ps = tmp_path / "store.npz"
    store.save(ps, token=corpus_token(imgs))
    for load in (VirtualColumnStore.load, JStore.load):
        _same_store(load(ps, token=j_token(imgs)), store)
        with pytest.raises(ValueError):
            load(ps, token=j_token(imgs[:-1]))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("names", [("a", "b"), ("s", "a")])
def test_scan_engine_repcache_hook_matches_reference(corpus, names, fused):
    """A repcache-backed engine publishes every ingest level, a second
    engine over the same cache skips pyramid materialization on every
    chunk, and both engines and caches equal the reference's: rows,
    chunks, rep_rows_cached, rows per stage, cache contents."""
    imgs, cascades = corpus
    out = {}
    for pkg in (T, J):
        cs = [cascades[pkg.name][c] for c in names]
        cache = pkg.Cache(64 << 20)
        kw = dict(chunk=64, repcache=cache, fused=fused, **pkg.kw)
        r1 = pkg.Engine(imgs, **kw).execute(cs)
        r2 = pkg.Engine(imgs, **kw).execute(cs)
        out[pkg.name] = (r1, r2, cache)
    (t1, t2, tc), (j1, j2, jc) = out["torch"], out["jax"]
    for t, j in ((t1, j1), (t2, j2)):
        assert np.array_equal(t.indices, j.indices)
        assert (t.stats.chunks, t.stats.rep_rows_cached,
                t.stats.rows_scanned) == (j.stats.chunks,
                                          j.stats.rep_rows_cached,
                                          j.stats.rows_scanned)
        assert [dataclasses.asdict(s) for s in t.stats.stages] == \
            [dataclasses.asdict(s) for s in j.stats.stages]
    assert t1.stats.rep_rows_cached == 0 and t1.stats.chunks > 0
    assert t2.stats.rep_rows_cached == t2.stats.rows_scanned
    assert t2.stats.chunks == 0 and tc.hits > 0
    _same_cache(tc, jc)


# ============================= deadline/flush semantics (fake clock) ======
def test_deadline_triggered_partial_flush(corpus):
    """Below batch_size, requests wait for the oldest deadline, then
    flush as ONE bucketed partial batch — in both packages alike."""
    imgs, cascades = corpus
    out = []
    for pkg in (T, J):
        clk, svc, reqs = _serve(pkg, imgs, cascades, [], shards=1,
                                batch_size=16, max_wait_s=0.010,
                                drain=False)
        reqs = [pkg.Request(i, i) for i in range(3)]
        for r in reqs:
            svc.submit("s", r)
        st = svc.stats["s"]
        clk.advance(0.009)
        svc.poll()
        assert st.batches == 0 and all(r.result is None for r in reqs)
        clk.advance(0.002)
        svc.poll()
        assert st.batches == 1 and st.deadline_flushes == 1
        assert st.padded_slots == 16 - 3
        svc.drain()
        out.append((svc, reqs))
    assert_same(*out)
    assert out[0][0].stage0_runs == 1     # the CNN cascade's base flush


def test_full_batch_flushes_and_leftover_keeps_its_deadline(corpus):
    imgs, cascades = corpus
    out = []
    for pkg in (T, J):
        clk, svc, _ = _serve(pkg, imgs, cascades, [], shards=1,
                             batch_size=4, max_wait_s=0.010, drain=False)
        reqs = [pkg.Request(0, 0)]
        svc.submit("a", reqs[0])
        clk.advance(0.004)
        for i in range(1, 6):
            reqs.append(pkg.Request(i, i))
            svc.submit("a", reqs[-1])
        st = svc.stats["a"]
        assert st.size_flushes == 1
        assert svc.wheel.next_deadline() == pytest.approx(0.014)
        clk.advance(0.011)
        svc.poll()
        assert st.deadline_flushes == 1 and st.batches == 2
        svc.drain()
        out.append((svc, reqs))
    assert_same(*out)


def test_in_order_delivery_per_queue(corpus):
    imgs, cascades = corpus
    rows = np.random.default_rng(0).permutation(len(imgs))[:30]
    tsvc, _ = _both(imgs, cascades, [("a", int(r)) for r in rows], dt=0.0,
                    poll=False, shards=1, batch_size=8, max_wait_s=0.010)
    assert list(tsvc.delivered) == sorted(tsvc.delivered)
    assert len(tsvc.delivered) == 30


def test_store_decided_rows_answered_with_zero_invocations(corpus):
    """Re-asked decided rows answer on submit: no batch and no model call
    in either package (python-side call counters)."""
    imgs, _ = corpus
    counts = {}
    out = []
    for pkg in (T, J):
        cnt = {"a": [0, 0, 0]}
        casc = toy("a", 1, counters=cnt)[0 if pkg is J else 1]
        clk = pkg.Clock()
        svc = pkg.Service(imgs, {"a": casc}, clock=clk, shards=1,
                          batch_size=8, max_wait_s=0.010, **pkg.kw)
        first = [pkg.Request(i, i) for i in range(8)]
        for r in first:
            svc.submit("a", r)
        svc.drain()
        calls = list(cnt["a"])
        again = [pkg.Request(100 + i, i) for i in range(8)]
        for r in again:
            svc.submit("a", r)
        assert [r.result for r in again] == [r.result for r in first]
        assert cnt["a"] == calls and calls[0] > 0
        assert svc.stats["a"].store_hits == 8 and \
            svc.stats["a"].batches == 1
        counts[pkg.name] = calls
        out.append((svc, first + again))
    assert counts["torch"] == counts["jax"]
    assert_same(*out)


@pytest.mark.parametrize("late", [False, True])
def test_store_sharing_with_scan_engine(corpus, late):
    """A service over a scan engine's store serves every scan-decided row
    with zero invocations, whether the scan ran before the service was
    built or after (the late write is adopted shard-locally)."""
    imgs, cascades = corpus
    out = []
    for pkg in (T, J):
        eng = pkg.Engine(imgs, chunk=64, **pkg.kw)
        if not late:
            eng.execute([cascades[pkg.name]["a"]])
        clk = pkg.Clock()
        svc = pkg.Service(imgs, cascades[pkg.name], clock=clk, shards=8,
                          batch_size=8, max_wait_s=0.010, store=eng.store,
                          **pkg.kw)
        if late:
            eng.execute([cascades[pkg.name]["a"]])
        reqs = [pkg.Request(i, i * 5) for i in range(32)]
        for r in reqs:
            svc.submit("a", r)
        st = svc.stats["a"]
        assert st.store_hits == 32 and st.batches == 0
        key = cascades[pkg.name]["a"].key
        assert all(svc._shard_stores[svc.shard_of(i * 5)].column(key)[i * 5]
                   >= 0 for i in range(32))
        out.append((svc, reqs))
    assert_same(*out)


def test_merge_rows_from_matches_reference():
    rng = np.random.default_rng(3)
    n, key = 100, ("c", (1,))
    rows = np.array([2, 5, 50, 99])
    vals, src = rng.integers(-1, 2, n), rng.integers(-1, 2, n)
    stores = []
    for Store in (VirtualColumnStore, JStore):
        dst, other = Store(n), Store(n)
        dst.column(key)[:] = vals
        other.column(key)[:] = src
        dst.merge_rows_from(other, rows)
        stores.append(dst)
    _same_store(*stores)
    t = stores[0].column(key)
    outside = np.setdiff1d(np.arange(n), rows)
    assert np.array_equal(t[outside], vals[outside])
    full = VirtualColumnStore(n)
    full.column(key)[:] = vals
    other = VirtualColumnStore(n)
    other.column(key)[:] = src
    full.merge_from(other)
    assert np.array_equal(t[rows], full.column(key)[rows])


def test_service_repcache_from_pyramid_path(corpus):
    """Once a's flushes warmed the rows' pooled levels, b's flushes over
    the same rows run the from-pyramid variant: rep_hit_rows, identical
    labels, and the scan's labels."""
    imgs, cascades = corpus
    rows = list(range(16))
    stream = [("a", r) for r in rows] + [("b", r) for r in rows]
    out = []
    for pkg in (T, J):
        clk, svc, reqs = _serve(pkg, imgs, cascades, stream[:16], dt=0.0,
                                poll=False, cache=True, shards=1,
                                batch_size=8, max_wait_s=0.010)
        assert svc.stats["a"].rep_hit_rows == 0
        more = [pkg.Request(100 + i, r) for i, r in enumerate(rows)]
        for r in more:
            svc.submit("b", r)
        svc.drain()
        assert svc.stats["b"].rep_hit_rows == len(rows)
        out.append((svc, reqs + more))
    assert_same(*out)
    col = _column(imgs, cascades["torch"]["b"], rows)
    assert [r.result for r in out[0][1][16:]] == [int(col[r]) for r in rows]


# ================================================ differential oracle =====
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_async_sync_scan_differential(corpus, shards):
    """The acceptance oracle: the port's AsyncCascadeService equals the
    reference's request for request and counter for counter, and both
    services and the port's sync CascadeService answer the port scan's
    labels, at every shard count; the stream asked again is answered
    entirely from the store."""
    imgs, cascades = corpus
    stream = _stream(150, len(imgs), seed=11)
    tsvc, treqs = _both(imgs, cascades, stream, shards=shards,
                        batch_size=16, max_wait_s=0.002, cache=True)
    cols = {c: _column(imgs, cascades["torch"][c],
                       [r for cc, r in stream if cc == c])
            for c in cascades["torch"]}
    assert [r.result for r in treqs] == [int(cols[c][row])
                                        for c, row in stream]
    # the sync batchers (capacities=None: full-width levels, exact)
    sync = CascadeService.from_cascades(cascades["torch"], batch_size=16,
                                        max_wait_s=1e9, device="cpu")
    jsync = JSync.from_cascades(cascades["jax"], batch_size=16,
                                max_wait_s=1e9, jit=False)
    sreqs, jreqs = [], []
    for i, (c, row) in enumerate(stream):
        sreqs.append(Request(i, imgs[row]))
        jreqs.append(JRequest(i, jnp.asarray(imgs[row])))
        sync.submit(c, sreqs[-1])
        jsync.submit(c, jreqs[-1])
    sync.drain()
    jsync.drain()
    assert [r.result for r in sreqs] == [int(r.result) for r in jreqs] \
        == [r.result for r in treqs]
    assert {c: (s.batches, s.padded_slots) for c, s in sync.stats.items()} \
        == {c: (s.batches, s.padded_slots) for c, s in jsync.stats.items()}
    before = tsvc.summary()
    second = [Request(1000 + i, row) for i, (_, row) in enumerate(stream)]
    for (c, _), r in zip(stream, second):
        tsvc.submit(c, r)
    after = tsvc.summary()
    assert [r.result for r in second] == [r.result for r in treqs]
    assert after["store_hits"] - before["store_hits"] == len(stream)
    assert after["batches"] == before["batches"]


def test_make_batch_runner_keeps_capacities():
    """make_batch_runner runs capped levels exactly as the reference's
    (overflow rows keep level 0's forced decision)."""
    imgs = _uint8_images(64, 32, seed=8)
    jc, tc = toy("a", 1)
    jc.capacities, tc.capacities = [4, 2], [4, 2]
    from repro.engine.scan import make_batch_runner as j_runner
    t = make_batch_runner(tc, 16, device="cpu")
    j = j_runner(jc, 16, jit=False)
    for lo in range(0, 64, 16):
        batch = list(imgs[lo:lo + 16])
        assert t(batch) == j([jnp.asarray(x) for x in batch])


def test_runner_cache_keyed_by_cascade_identity(corpus):
    """Two cascades of one concept (a retrained one, or a ladder rung)
    never share a batch runner: each service answers its own cascade's
    labels, and a laddered service holds one runner per rung's key."""
    imgs, _ = corpus
    v1 = {"a": toy("a", 1)[1]}
    v2 = {"a": toy("a", 7)[1]}
    v2["a"].cascade_id = ("toy", 7)
    rows = list(range(24))

    def serve(cascades):
        svc = AsyncCascadeService(imgs, cascades, shards=1, batch_size=8,
                                  max_wait_s=1e9, device="cpu")
        reqs = [Request(i, r) for i, r in enumerate(rows)]
        for r in reqs:
            svc.submit("a", r)
        svc.drain()
        return svc, [r.result for r in reqs]

    (s1, got1), (s2, got2) = serve(v1), serve(v2)
    c1, c2 = _column(imgs, v1["a"], rows), _column(imgs, v2["a"], rows)
    assert got1 == [int(c1[r]) for r in rows]
    assert got2 == [int(c2[r]) for r in rows]
    assert got1 != got2
    assert {k[0] for k in s1._fns} == {v1["a"].key}
    assert {k[0] for k in s2._fns} == {v2["a"].key}
    laddered = AsyncCascadeService(imgs, v1, shards=1, batch_size=8,
                                   ladders={"a": [v2["a"]]}, device="cpu")
    laddered.warmup()
    assert {k[0] for k in laddered._fns} == {v1["a"].key, v2["a"].key}


def test_repcache_refuses_a_second_corpus(corpus):
    imgs, cascades = corpus
    cache = RepresentationCache()
    ScanEngine(imgs, chunk=64, repcache=cache, device="cpu")
    AsyncCascadeService(imgs.copy(), cascades["torch"], shards=1,
                        repcache=cache, device="cpu")
    AsyncCascadeService(torch.from_numpy(imgs.copy()), cascades["torch"],
                        shards=1, repcache=cache, device="cpu")
    other = _uint8_images(64, 32, seed=99)
    with pytest.raises(ValueError):
        ScanEngine(other, chunk=64, repcache=cache, device="cpu")
    with pytest.raises(ValueError):
        AsyncCascadeService(other, cascades["torch"], shards=1,
                            repcache=cache, device="cpu")


def test_service_observability_is_bounded(corpus):
    imgs, cascades = corpus
    svc = AsyncCascadeService(imgs, cascades["torch"], shards=1,
                              batch_size=8, device="cpu")
    assert svc.delivered.maxlen is not None
    for st in svc.stats.values():
        assert st.latencies.maxlen is not None


def test_factory_builds_both_modes(corpus):
    imgs, cascades = corpus
    svc = build_cascade_service(imgs, cascades["torch"], shards=2,
                                batch_size=8, device="cpu")
    assert isinstance(svc, AsyncCascadeService) and svc.repcache is not None
    assert svc.summary()["lanes"] == 2 and svc.summary()["devices"] == 1
    sync = build_cascade_service(imgs, cascades["torch"], mode="sync",
                                 batch_size=8, device="cpu")
    assert isinstance(sync, CascadeService)
    with pytest.raises(ValueError):
        build_cascade_service(imgs, cascades["torch"], mode="threaded",
                              device="cpu")
    with pytest.raises(ValueError):
        build_cascade_service(imgs, cascades["torch"], mode="sync",
                              queue_limit=4, device="cpu")
    cache = RepresentationCache()
    eng = build_scan_engine(imgs, repcache=cache, device="cpu")
    assert eng.repcache is cache
    svc2 = build_cascade_service(imgs, cascades["torch"], shards=1,
                                 repcache=cache, device="cpu")
    assert svc2.repcache is cache


def test_shard_lanes_dispatch_ahead(corpus):
    """8 shards are 8 lanes, each its own in-flight slot: a burst of one
    full batch per shard parks 8 batches in flight before any delivery
    (the reference on 8 host devices does the same), and the labels are
    the scan's."""
    imgs, cascades = corpus
    out = []
    for pkg in (T, J):
        clk = pkg.Clock()
        svc = pkg.Service(imgs, cascades[pkg.name], clock=clk, shards=8,
                          batch_size=8, max_wait_s=1e9, **pkg.kw)
        by_shard = {s: [] for s in range(8)}
        for row in range(len(imgs)):
            if len(by_shard[svc.shard_of(row)]) < 8:
                by_shard[svc.shard_of(row)].append(row)
        reqs = []
        for rows in by_shard.values():
            for row in rows:
                reqs.append(pkg.Request(len(reqs), row))
                svc.submit("s", reqs[-1])
        assert len(svc._inflight) == 8
        svc.drain()
        out.append((svc, reqs))
    assert_same(*out)
    col = _column(imgs, cascades["torch"]["s"], [r.payload
                                                 for r in out[0][1]])
    assert [r.result for r in out[0][1]] == [int(col[r.payload])
                                            for r in out[0][1]]


def test_warmup_executes_every_lane_rung_width_and_variant(corpus):
    imgs, cascades = corpus
    n = {}
    for pkg in (T, J):
        svc = pkg.Service(imgs, cascades[pkg.name], shards=2, batch_size=32,
                          clock=pkg.Clock(), **pkg.kw)
        n[pkg.name] = svc.warmup()
        assert svc.busy() is False and svc.store.keys() == []
        if pkg is T:
            assert svc.stage0_runs == 2 * 2    # the CNN's base runs
    # 3 cascades x widths {16, 32} x 2 lanes (devices) x 2 variants
    assert n["torch"] == n["jax"] == 24


# ===================================== batcher keying regression ==========
def test_sync_service_keeps_concepts_separate_when_cascade_id_collides():
    hw = 8

    def runner(sign):
        def run(payloads):
            return [int(sign * float(np.asarray(p).mean()) > 0)
                    for p in payloads]
        return run

    shared_id = (0, 3, 1)
    service = CascadeService({"a": runner(+1), "b": runner(-1)},
                             batch_size=4, max_wait_s=1e9,
                             cascade_ids={"a": shared_id, "b": shared_id})
    assert set(service.batchers) == {("a", shared_id), ("b", shared_id)}
    reqs = []
    for i in range(8):
        c = "a" if i % 2 == 0 else "b"
        r = Request(i, np.full((hw, hw, 1), 1.0))
        service.submit(c, r)
        reqs.append((c, r))
    service.drain()
    for c, r in reqs:
        assert int(r.result) == (1 if c == "a" else 0), (c, r.rid)
    assert service.stats["a"].batches == 1 and \
        service.stats["b"].batches == 1


def test_from_cascades_shares_runner_only_for_same_object():
    shared = toy("x", 5)[1]
    other = toy("y", 6)[1]
    other.cascade_id = shared.cascade_id
    svc = CascadeService.from_cascades(
        {"x": shared, "x2": shared, "y": other}, batch_size=4,
        max_wait_s=1e9, device="cpu")
    b = svc.batchers
    kx, kx2, ky = (("x", tuple(shared.cascade_id)),
                   ("x2", tuple(shared.cascade_id)),
                   ("y", tuple(other.cascade_id)))
    assert set(b) == {kx, kx2, ky}
    assert b[kx].run_batch is b[kx2].run_batch
    assert b[kx].run_batch is not b[ky].run_batch


# ======================================================= ingest seeding ===
def test_service_answers_ingest_indexed_rows_with_store_hits():
    """tests/test_ingest.py's service case: a service seeded by an ingest
    index answers the index's decided rows at submit, with no batch, in
    both packages alike (exact and approx seeding)."""
    from repro.data import synthetic as jsyn
    from test_torch_ingest import HW, N, SPECS as ISPECS, toy_pair

    frames, _, _ = jsyn.make_camera_stream(ISPECS, N, hw=HW, seed=0)
    pairs = [toy_pair("a", 1), toy_pair("b", 2)]
    pipes = {"jax": JIngest([p[0] for p in pairs], N, chunk=64),
             "torch": IngestPipeline([p[1] for p in pairs], N, chunk=64,
                                     device="cpu")}
    pipes["jax"].run(frames)
    pipes["torch"].run(frames)
    for exact in (True, False):
        out = []
        for pkg in (T, J):
            pipe = pipes[pkg.name]
            casc = pairs[0][0 if pkg is J else 1]
            col = pipe.index.decided.column(casc.key)
            rows = np.where(col >= 0)[0][:16]
            svc = pkg.Service(frames, {"a": casc}, shards=2,
                              clock=pkg.Clock(), ingest_index=pipe.index,
                              ingest_exact=exact, **pkg.kw)
            reqs = [pkg.Request(i, int(r)) for i, r in enumerate(rows)]
            for r in reqs:
                svc.submit("a", r)
            st = svc.stats["a"]
            assert st.store_hits == len(rows) > 0
            assert st.batches == 0 and st.rows_evaluated == 0
            assert [r.result for r in reqs] == [int(v) for v in col[rows]]
            out.append((svc, reqs))
        assert_same(*out)


# ========================================== joint plan (trained world) ====
def test_joint_plan_labels_identical_async_service(world):
    """tests/test_joint_planner.py::test_joint_plan_labels_identical_async_service
    with costs pinned (each model's FLOPs at 1 GFLOP/s) and no accuracy
    floor, so the plan is the same on every machine and has a level
    below the base. That plan runs a 32 px model first and reads its
    16 px level only in the second cascade, which a lazy scan pools at
    first touch and does not publish; so the scan here is eager
    (``lazy=False``: every level of the plan at ingest, all published).
    The service's flushes then read the scan's levels (repcache hits),
    and both packages answer every request with the single-cascade
    scans' labels."""
    pinned = {n: _pinned(js) for n, js in world["jsys"].items()}
    qx, meta = world["qx"], world["meta"]
    jp = jplan.plan_query(
        {n: p[0] for n, p in pinned.items()},
        jplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
            jplan.PredicateClause(s.name) for s in SPECS]),
        scenario="CAMERA", metadata=meta, joint=True, costing="engine")
    tp = tplan.plan_query(
        {n: p[1] for n, p in pinned.items()},
        tplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
            tplan.PredicateClause(s.name) for s in SPECS]),
        scenario="CAMERA", metadata=meta, joint=True, costing="engine")
    assert [c.key for c in tp.cascades] == [c.key for c in jp.cascades]
    assert set(tp.level_set) - {qx.shape[1]}       # a non-base level
    out = []
    for pkg, plan in ((T, tp), (J, jp)):
        cache = pkg.Cache()
        eng = pkg.Engine(qx, meta, chunk=32, repcache=cache, lazy=False,
                         **pkg.kw)
        eng.execute(plan.cascades, plan.metadata_eq)
        clk = pkg.Clock()
        svc = pkg.Service(qx, {c.concept: c for c in plan.cascades},
                          shards=2, batch_size=16, max_wait_s=1e-4,
                          clock=clk, repcache=cache, **pkg.kw)
        reqs = []
        for i, row in enumerate(range(0, len(qx), 3)):
            for c in plan.cascades:
                reqs.append((c.concept, row, pkg.Request((i, c.concept),
                                                         row)))
                svc.submit(c.concept, reqs[-1][2])
            clk.advance(5e-5)
            svc.poll()
        svc.drain()
        assert cache.hits > 0
        out.append((svc, [r for _, _, r in reqs]))
    assert_same(*out)
    want = {}
    for c in tp.cascades:
        col = np.zeros(len(qx), np.int8)
        col[ScanEngine(qx, meta, chunk=32, device="cpu").execute(
            [c]).indices] = 1
        want[c.concept] = col
    got = out[0][1]
    assert [r.result for r in got] == [
        int(want[c.concept][row]) for row in range(0, len(qx), 3)
        for c in tp.cascades]



def test_compiled_ladder_matches_reference(world):
    """TahomaSystem.compiled_ladder: the same rungs (cascade ids, models'
    resolutions, thresholds) as the reference's for the most accurate
    frontier cascade of each concept, floored and capped alike."""
    for name, js in world["jsys"].items():
        ts = world["tsys"][name]
        jspace, tspace = js.cascade_space("CAMERA"), ts.cascade_space("CAMERA")
        primary = int(np.argmax(jspace.acc))
        for kw in ({}, {"max_rungs": 2}, {"min_accuracy": 0.6}):
            jl = js.compiled_ladder(jspace, primary, concept=name, **kw)
            tl = ts.compiled_ladder(tspace, primary, concept=name, **kw)
            assert [c.key for c in tl] == [c.key for c in jl]
            assert [c.thresholds for c in tl] == [c.thresholds for c in jl]
            assert [[r.name for r in c.reps] for c in tl] == \
                [[r.name for r in c.reps] for c in jl]
            assert all(c.stage0 is not None for c in tl)
        assert len(ts.compiled_ladder(tspace, primary, concept=name)) > 0
