"""Overload and fault hardening of the port's serving layer
(serve/{host,faults,service}, core/selector.degradation_ladder): the port
(device="cpu", the plain versions) against the JAX reference (on the CPU,
``jit=False``) on the same fake-clock streams — the mirror of
tests/test_serve_overload.py, at its sizes (a 180-row 32 px corpus, the
reference's toy cascade a and a cheaper single-level rung), plus the
rules the port keeps: the lane is the unit of dispatch, health and fault
index; only the injector's faults are caught; entry points raise without
a card.

Tolerances: none. Results (labels and typed ``Shed``/``TimedOut``),
delivery order, every counter, ``summary()`` (apart from ``devices`` and
``lanes``), fault counts and the event host's sleep schedule are equal
(tests/test_torch_serve.py says why labels can be). The reference runs
on JAX's 8 forced host devices (tests/conftest.py), the port on as many
lanes.
"""
import copy
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.selector import degradation_ladder as j_ladder  # noqa: E402
from repro.serve import DegradeConfig as JDegrade  # noqa: E402
from repro.serve import EventHost as JHost  # noqa: E402
from repro.serve import FakeTimer as JFakeTimer  # noqa: E402
from repro.serve import FaultInjector as JInjector  # noqa: E402
from repro.serve import FaultPlan as JPlan  # noqa: E402
from repro.serve import ManualClock as JClock  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve.scheduler import DeadlineWheel as JWheel  # noqa: E402
from repro_torch.core.pipeline import build_cascade_service  # noqa: E402
from repro_torch.core.selector import degradation_ladder  # noqa: E402
from repro_torch.serve import (AsyncCascadeService, DegradeConfig,  # noqa
                               DeviceError, EventHost, FakeTimer,
                               FaultInjector, FaultPlan, ManualClock,
                               Request, Shed, TimedOut, is_label)
from repro_torch.serve.scheduler import DeadlineWheel  # noqa: E402
from test_query_engine import _uint8_images  # noqa: E402
from test_torch_serve import (JSynced, _column, _result,  # noqa: E402
                              assert_same)
from test_torch_sharded import toy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
J = SimpleNamespace(name="jax", Service=JSynced, Clock=JClock,
                    Request=JRequest, Degrade=JDegrade, Host=JHost,
                    FakeTimer=JFakeTimer, Injector=JInjector, Plan=JPlan,
                    kw=dict(jit=False))
T = SimpleNamespace(name="torch", Service=AsyncCascadeService,
                    Clock=ManualClock, Request=Request,
                    Degrade=DegradeConfig, Host=EventHost,
                    FakeTimer=FakeTimer, Injector=FaultInjector,
                    Plan=FaultPlan, kw=dict(device="cpu"))


def _cheap(pair):
    """The reference test's strictly cheaper rung: only the coarse
    model, a distinct cascade id."""
    for casc in pair:
        casc.reps = casc.reps[:1]
        casc.model_fns = casc.model_fns[:1]
        casc.thresholds = [(None, None)]
        casc.cascade_id = ("toy-cheap", 21)
    return pair


@pytest.fixture(scope="module")
def corpus():
    imgs = _uint8_images(180, 32, seed=6)
    a, cheap = toy("a", 1), _cheap(toy("a", 21))
    return imgs, {"jax": ({"a": a[0]}, cheap[0]),
                  "torch": ({"a": a[1]}, cheap[1])}


def _svc(pkg, corpus, *, ladder=False, plan=None, **kw):
    imgs, cascades = corpus
    casc, cheap = cascades[pkg.name]
    clk = pkg.Clock()
    kw.setdefault("shards", 1)
    kw.setdefault("batch_size", 8)
    kw.setdefault("max_wait_s", 0.010)
    if ladder:
        kw["ladders"] = {"a": [cheap]}
    if "degrade" in kw:
        kw["degrade"] = pkg.Degrade(**kw["degrade"])
    if plan is not None:
        kw["faults"] = pkg.Injector(pkg.Plan(**copy.deepcopy(plan)),
                                    clock=clk)
    svc = pkg.Service(imgs, casc, clock=clk, **pkg.kw, **kw)
    return clk, svc


def _label_of(corpus, cheap=False):
    imgs, cascades = corpus
    casc = cascades["torch"][1] if cheap else cascades["torch"][0]["a"]
    return _column(imgs, casc, np.arange(len(imgs)))


def _twin(corpus, body, **kw):
    """Run ``body(pkg, clk, svc) -> reqs`` on both packages' services
    built with ``kw``; check them equal; return the port's."""
    out = []
    for pkg in (T, J):
        clk, svc = _svc(pkg, corpus, **kw)
        reqs = body(pkg, clk, svc)
        out.append((svc, reqs))
    assert_same(*out)
    if kw.get("plan") is not None:
        assert out[0][0].summary()["faults_injected"] == \
            out[1][0].summary()["faults_injected"]
    return out[0]


# ================================================= wheel compaction =======
def test_deadline_wheel_compaction_bounds_stale_entries():
    ws = DeadlineWheel(granularity=0.001), JWheel(granularity=0.001)
    for i in range(10_000):
        for w in ws:
            w.schedule("k", 1e6 + i)
            w.cancel("k")
        assert ws[0].stored_entries == ws[1].stored_entries <= \
            DeadlineWheel.COMPACT_MIN + DeadlineWheel.COMPACT_FACTOR + 1
    assert ws[0].compactions == ws[1].compactions > 0
    for w in ws:
        w.schedule("x", 2.0)
        w.schedule("y", 1.0)
        for i in range(1_000):
            w.schedule(f"churn{i % 3}", 1e6 + i)
            w.cancel(f"churn{i % 3}")
        assert w.pop_due(1.5) == ["y"] and w.pop_due(2.5) == ["x"]


# ======================================================= event host =======
def test_host_fires_deadline_without_caller_cooperation(corpus):
    sleeps = {}

    def body(pkg, clk, svc):
        host = pkg.Host(svc, timer=pkg.FakeTimer(), clock=clk)
        reqs = [pkg.Request(i, i) for i in range(3)]
        for r in reqs:
            host.submit("a", r)
        assert host.timer.wakes == 3
        first = host.step()
        assert all(r.result is None for r in reqs)
        clk.advance(0.011)
        assert host.step() is None and host.wait_idle(0) is True
        sleeps[pkg.name] = (first, host.timer.waits, host.steps)
        return reqs

    svc, reqs = _twin(corpus, body, batch_size=16)
    assert sleeps["torch"] == sleeps["jax"]
    assert sleeps["torch"][0] == pytest.approx(0.010)
    assert svc.stats["a"].deadline_flushes == 1
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[i]) for i in range(3)]


def test_host_sleep_tracks_earliest_event(corpus):
    sleeps = {}

    def body(pkg, clk, svc):
        host = pkg.Host(svc, timer=pkg.FakeTimer(), clock=clk)
        reqs = [pkg.Request(0, 0)]
        host.submit("a", reqs[0])
        got = [host.step()]
        clk.advance(0.005)
        got += [host.step(), host.step()]
        clk.advance(0.016)
        got.append(host.step())
        sleeps[pkg.name] = got
        return reqs

    svc, _ = _twin(corpus, body, batch_size=16, max_wait_s=0.020,
                   request_deadline_s=0.050)
    assert sleeps["torch"] == sleeps["jax"]
    assert sleeps["torch"][0] == pytest.approx(0.020)
    assert sleeps["torch"][1] == pytest.approx(0.015)
    assert sleeps["torch"][3] is None


def test_host_threaded_loop_delivers_with_wall_timer(corpus):
    """A real daemon thread parked on the WallTimer serves a sub-batch
    submit end to end with nobody polling; the labels are the scan's.
    The thread is not the one that built the service: each dispatch
    enters its lane explicitly."""
    imgs, cascades = corpus
    svc = AsyncCascadeService(imgs, cascades["torch"][0], shards=2,
                              batch_size=16, max_wait_s=0.002,
                              clock=time.perf_counter, device="cpu")
    reqs = [Request(i, i) for i in range(5)]
    with EventHost(svc) as host:
        for r in reqs:
            host.submit("a", r)
        assert host.wait_idle(10.0) is True
    assert host._thread is None
    assert svc.stats["a"].deadline_flushes >= 1
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[i]) for i in range(5)]
    host2 = build_cascade_service(imgs, cascades["torch"][0], shards=1,
                                  batch_size=16, max_wait_s=0.002,
                                  host=True, device="cpu")
    try:
        r = Request(0, 7)
        host2.submit("a", r)
        assert host2.wait_idle(10.0) is True
    finally:
        host2.stop()
    assert r.result == int(col[7])


# ================================================= admission control ======
def test_queue_limit_sheds_with_typed_result(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(10)]
        for r in reqs:
            svc.submit("a", r)
        assert all(r.result is None for r in reqs[:4])
        assert svc.summary()["queue_depth"] == {"current": 4, "max": 4}
        svc.drain()
        return reqs

    svc, reqs = _twin(corpus, body, batch_size=100, queue_limit=4)
    shed = [r.result for r in reqs[4:]]
    assert all(isinstance(s, Shed) and not is_label(s) and not s
               for s in shed)
    assert shed[0].reason == "queue-full"
    assert svc.stats["a"].shed == 6 and svc.summary()["goodput_requests"] == 4
    col = _label_of(corpus)
    assert [r.result for r in reqs[:4]] == [int(col[i]) for i in range(4)]


def test_degrade_policy_steps_ladder_on_admission_pressure(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(4)]
        for r in reqs:
            svc.submit("a", r)
        assert svc.active_level("a") == 1
        svc.drain()
        return reqs

    svc, _ = _twin(corpus, body, ladder=True, batch_size=100,
                   queue_limit=2, overload="degrade")
    st = svc.stats["a"]
    assert st.shed == 2 and st.degrade_steps == 1 and st.degraded_rows == 2


# ============================================== degradation ladder ========
def test_ladder_degrades_under_depth_and_recovers(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(8)]
        for r in reqs:
            svc.submit("a", r)
        svc.drain()
        assert svc.active_level("a") == 1
        for j, row in enumerate((100, 101)):
            reqs.append(pkg.Request(50 + j, row))
            svc.submit("a", reqs[-1])
            clk.advance(0.011)
            svc.poll()
        assert svc.active_level("a") == 0
        reqs.append(pkg.Request(99, 0))
        svc.submit("a", reqs[-1])
        svc.drain()
        return reqs

    svc, reqs = _twin(corpus, body, ladder=True, batch_size=8,
                      degrade=dict(high_depth=6, low_depth=1,
                                   recover_after=2))
    st = svc.stats["a"]
    assert st.degrade_steps == 1 and st.recover_steps == 1
    # the first 8 and the first calm flush (row 100) ran the rung; the
    # second calm flush stepped back up before it ran
    assert st.degraded_rows == 9 and st.degraded_batches == 2
    cheap = _label_of(corpus, cheap=True)
    prim = _label_of(corpus)
    assert [r.result for r in reqs[:9]] == [int(cheap[r.payload])
                                           for r in reqs[:9]]
    assert [r.result for r in reqs[9:]] == [int(prim[101]), int(prim[0])]
    casc, rung = corpus[1]["torch"][0]["a"], corpus[1]["torch"][1]
    assert (svc.store.column(rung.key)[:8] >= 0).all()
    assert int(svc.store.column(casc.key)[0]) >= 0


def test_degraded_store_hit_while_degraded(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(8)]
        for r in reqs:
            svc.submit("a", r)
        svc.drain()
        batches = svc.stats["a"].batches
        reqs.append(pkg.Request(40, 3))
        svc.submit("a", reqs[-1])
        assert reqs[-1].result in (0, 1)
        assert svc.stats["a"].batches == batches
        return reqs

    svc, _ = _twin(corpus, body, ladder=True, batch_size=8,
                   degrade=dict(high_depth=6, low_depth=0,
                                recover_after=10**9))
    assert svc.stats["a"].store_hits == 1


def test_warmup_covers_ladder_rungs(corpus):
    casc, cheap = corpus[1]["torch"][0]["a"], corpus[1]["torch"][1]
    n = {}
    for pkg in (T, J):
        _, svc = _svc(pkg, corpus, ladder=True)
        n[pkg.name] = svc.warmup(widths=[8])
        if pkg is T:
            assert {k[0] for k in svc._fns} == {casc.key, cheap.key}
    assert n["torch"] == n["jax"] > 0


def test_degradation_ladder_selector_matches_reference():
    rng = np.random.default_rng(4)
    for trial in range(20):
        n = 12
        t = rng.uniform(0.001, 0.2, n)
        space = SimpleNamespace(acc=rng.uniform(0.5, 1.0, n),
                                throughput=1.0 / t, time_s=t)
        for primary in range(n):
            for kw in ({}, {"min_accuracy": 0.75}, {"max_rungs": 2}):
                got = degradation_ladder(space, primary, **kw)
                want = j_ladder(space, primary, **kw)
                assert [(s.index, s.accuracy, s.throughput) for s in got] \
                    == [(s.index, s.accuracy, s.throughput) for s in want]
    space = SimpleNamespace(
        acc=np.array([0.95, 0.90, 0.80, 0.70, 0.60, 0.99]),
        throughput=np.array([10.0, 20.0, 40.0, 80.0, 160.0, 5.0]),
        time_s=np.array([0.10, 0.05, 0.025, 0.0125, 0.00625, 0.2]))
    assert [s.index for s in degradation_ladder(space, 0)] == [1, 2, 3, 4]
    assert degradation_ladder(space, 4) == []


# ================================================== fault injection =======
def _eight(pkg, clk, svc):
    reqs = [pkg.Request(i, i) for i in range(8)]
    for r in reqs:
        svc.submit("a", r)
    svc.drain()
    return reqs


def test_transient_compute_error_is_retried(corpus):
    svc, reqs = _twin(corpus, _eight, plan=dict(transient_errors=1))
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[i]) for i in range(8)]
    st = svc.stats["a"]
    assert st.retries == 1 and st.shed == 0 and st.timeouts == 0
    assert svc.summary()["failed_devices"] == []


def test_device_failure_reroutes_to_another_lane(corpus):
    """A permanently dispatch-failing lane is marked failed and every
    dispatch re-routes to another lane (never to the CPU or a plain
    version: the lanes here are all CPU slots, and the failed lane's
    shard is served by lane 1); labels stay exact."""
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(40)]
        for r in reqs:
            svc.submit("a", r)
        svc.drain()
        return reqs

    svc, reqs = _twin(corpus, body, shards=2, plan=dict(
        fail_dispatch={0: -1}))
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[i]) for i in range(40)]
    summ = svc.summary()
    assert summ["failed_devices"] == [0] and summ["lanes"] == 2
    assert summ["faults_injected"]["dispatch_failures"] == 1
    assert svc._lane_for(0) == 1 and svc._lane_for(1) == 1


def test_dead_lane_batch_timeout_retries_on_healthy(corpus):
    def body(pkg, clk, svc):
        rows0 = [r for r in range(180) if svc.shard_of(r) == 0][:8]
        reqs = [pkg.Request(i, r) for i, r in enumerate(rows0)]
        for r in reqs:
            svc.submit("a", r)
        svc.poll()
        assert all(r.result is None for r in reqs)
        clk.advance(0.060)
        svc.poll()
        return reqs

    svc, reqs = _twin(corpus, body, shards=2, batch_timeout_s=0.050,
                      plan=dict(dead_devices={0}))
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[r.payload]) for r in reqs]
    assert svc.stats["a"].retries == 1 and svc.stats["a"].timeouts == 0
    assert svc.summary()["failed_devices"] == [0]


def test_drain_converts_never_ready_batch_to_timeout(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(8)]
        for r in reqs:
            svc.submit("a", r)
        assert len(svc._inflight) == 1
        clk.advance(0.060)
        svc.drain()
        assert not svc.busy()
        reqs.append(pkg.Request(99, 50))
        svc.submit("a", reqs[-1])
        svc.drain()
        return reqs

    svc, reqs = _twin(corpus, body, batch_timeout_s=0.050,
                      dispatch_retries=0, plan=dict(dead_devices={0}))
    assert all(isinstance(r.result, TimedOut) for r in reqs[:8])
    assert reqs[0].result.reason == "batch-timeout"
    assert isinstance(reqs[-1].result, Shed)
    assert reqs[-1].result.reason == "no-healthy-device"
    assert svc.stats["a"].timeouts == 8


def test_request_deadline_expires_in_queue(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(3)]
        for r in reqs:
            svc.submit("a", r)
        clk.advance(0.008)
        reqs.append(pkg.Request(10, 50))
        svc.submit("a", reqs[-1])
        clk.advance(0.004)
        svc.poll()
        assert reqs[-1].result is None
        assert svc.next_event_time() is not None
        svc.drain()
        return reqs

    svc, reqs = _twin(corpus, body, batch_size=100, max_wait_s=0.100,
                      request_deadline_s=0.010)
    assert all(isinstance(r.result, TimedOut) for r in reqs[:3])
    assert reqs[0].result.reason == "request-deadline"
    assert reqs[-1].result in (0, 1) and svc.stats["a"].expired == 3


def test_slow_lane_delivers_late_but_exact(corpus):
    def body(pkg, clk, svc):
        reqs = [pkg.Request(i, i) for i in range(8)]
        for r in reqs:
            svc.submit("a", r)
        svc.poll()
        assert all(r.result is None for r in reqs)
        clk.advance(0.031)
        svc.poll()
        return reqs

    svc, reqs = _twin(corpus, body, batch_timeout_s=0.100,
                      plan=dict(slow_devices={0: 0.030}))
    col = _label_of(corpus)
    assert [r.result for r in reqs] == [int(col[i]) for i in range(8)]
    assert svc.stats["a"].retries == 0 and svc.stats["a"].timeouts == 0


def test_fault_drill_at_eight_lanes(corpus):
    """The card's drill at unit scale: 8 lanes, lane 3 failing every
    dispatch, lane 5 dead, two transient errors, a batch timeout. Every
    request ends as a label, Shed or TimedOut; labels equal the
    unfaulted run's; lanes 3 and 5 fail; both packages alike."""
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 180, 300)

    def body(pkg, clk, svc):
        reqs = []
        for i, row in enumerate(rows):
            reqs.append(pkg.Request(i, int(row)))
            svc.submit("a", reqs[-1])
            clk.advance(0.001)
            svc.poll()
        clk.advance(1.0)
        svc.poll()
        svc.drain()
        return reqs

    kw = dict(shards=8, batch_size=8, max_wait_s=0.005,
              batch_timeout_s=1e-4)
    svc, reqs = _twin(corpus, body, plan=dict(
        fail_dispatch={3: -1}, dead_devices={5}, transient_errors=2), **kw)
    _, clean = _twin(corpus, body, **kw)
    assert all(is_label(r.result) or isinstance(r.result, (Shed, TimedOut))
               for r in reqs)
    assert all(r.result == c.result for r, c in zip(reqs, clean)
               if is_label(r.result))
    summ = svc.summary()
    assert summ["failed_devices"] == [3, 5]
    assert summ["faults_injected"] == {"dispatch_failures": 1,
                                       "transient_errors": 2,
                                       "slowdowns": 0, "dead_batches": 1}
    assert sum(is_label(r.result) for r in reqs) > 250


# ==================================================== the port's rules ====
def test_an_error_from_a_flush_is_not_caught(corpus):
    """Only the injector's DeviceError / TransientComputeError re-route a
    batch. A RuntimeError raised while a flush runs (as a CUDA error or
    a failed kernel build would be) propagates, nothing is shed, and no
    lane is marked failed."""
    imgs, cascades = corpus
    casc = cascades["torch"][0]["a"]
    calls = []

    def boom(x):
        calls.append(x.shape[0])
        raise RuntimeError("CUDA error: an illegal memory access")
    broken = type(casc)(casc.concept, ("broken",), casc.reps,
                        [boom] + casc.model_fns[1:], casc.thresholds)
    svc = AsyncCascadeService(imgs, {"a": broken}, shards=1, batch_size=8,
                              clock=ManualClock(), device="cpu",
                              faults=FaultInjector(FaultPlan()))
    reqs = [Request(i, i) for i in range(7)]
    for r in reqs:
        svc.submit("a", r)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        svc.submit("a", Request(7, 7))
    assert calls == [8]
    assert svc.summary()["failed_devices"] == []
    assert svc.stats["a"].shed == 0 and svc.stats["a"].retries == 0


def test_only_injected_fault_types_are_caught(corpus):
    """A DeviceError that did not come from the injector's dispatch hook
    (raised by a model while the batch runs) is not taken for a lane
    failure either."""
    imgs, cascades = corpus
    casc = cascades["torch"][0]["a"]

    def dev_err(x):
        raise DeviceError("raised inside the flush")
    broken = type(casc)(casc.concept, ("broken",), casc.reps,
                        [dev_err] + casc.model_fns[1:], casc.thresholds)
    svc = AsyncCascadeService(imgs, {"a": broken}, shards=2, batch_size=1,
                              clock=ManualClock(), device="cpu")
    with pytest.raises(DeviceError):
        svc.submit("a", Request(0, 0))
    assert svc.summary()["failed_devices"] == []


def test_serving_entry_points_raise_without_a_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    imgs, cascades = corpus
    casc = cascades["torch"][0]
    from repro_torch.engine.scan import make_batch_runner
    from repro_torch.serve import CascadeService
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cascade_service(imgs, casc)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_cascade_service(imgs, casc, mode="sync")
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncCascadeService(imgs, casc)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeService.from_cascades(casc, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch_runner(casc["a"], 8)
    assert build_cascade_service(imgs, casc, device="cpu").n_shards == 1


# ==================================== sub-saturation exactness + gauges ===
def test_hardened_knobs_do_not_change_sub_saturation_labels(corpus):
    stream = [int(r) for r in np.random.default_rng(5).integers(0, 180, 60)]

    def body(pkg, clk, svc):
        reqs = []
        for i, row in enumerate(stream):
            reqs.append(pkg.Request(i, row))
            svc.submit("a", reqs[-1])
            svc.poll()
        svc.drain()
        return reqs

    _, plain = _twin(corpus, body, batch_size=8)
    svc, hard = _twin(corpus, body, ladder=True, batch_size=8,
                      queue_limit=10**6, batch_timeout_s=1e9,
                      request_deadline_s=1e9,
                      degrade=dict(high_depth=10**6), plan={})
    assert [_result(r) for r in hard] == [_result(r) for r in plain]
    summ = svc.summary()
    assert summ["shed"] == summ["expired"] == summ["timeouts"] == 0
    assert summ["degraded_rows"] == 0 and summ["retries"] == 0
    assert summ["active_levels"] == {"a": 0}


def test_summary_percentiles_and_gauges(corpus):
    def body(pkg, clk, svc):
        reqs = []
        for i in range(20):
            reqs.append(pkg.Request(i, i))
            svc.submit("a", reqs[-1])
            clk.advance(0.001)
        svc.drain()
        return reqs

    svc, _ = _twin(corpus, body, batch_size=8)
    summ = svc.summary()
    lat = summ["latency_ms"]
    assert 0.0 <= lat["p50"] <= lat["p95"] <= lat["p99"]
    assert summ["queue_depth"]["current"] == 0
    assert summ["in_flight"] == {"current": 0, "max": 1}
    assert summ["goodput_requests"] == 20


def test_typed_results_are_falsy_and_comparable():
    assert not Shed() and not TimedOut()
    assert Shed("x") == Shed("x") and Shed("x") != Shed("y")
    assert not is_label(Shed()) and not is_label(TimedOut())
    assert not is_label(None)
    assert is_label(0) and is_label(1)


def test_serve_cascade_torch_example_runs_on_the_cpu():
    """examples/serve_cascade_torch.py at 60 requests on the CPU: every
    request served, every label naive_scan's."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "examples/serve_cascade_torch.py", "--device",
         "cpu", "--requests", "60"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(r"^served 60 mixed requests in ", out.stdout, re.M)
    assert "identical labels vs naive_scan: True (0 of 60 differ)" in \
        out.stdout
