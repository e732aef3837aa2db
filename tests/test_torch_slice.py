"""The port's query path as a whole (core/pipeline, core/cascade,
core/selector, engine/planner, engine/scan) against the JAX reference, on
one tiny JAX-trained system per concept whose bank crosses over entry by
entry (nothing is retrained). Trained like tests/test_query_engine.py:
2 concepts, 32 px, steps=30.

Tolerances: score matrices within atol 1e-5 (f32 CNNs); the dense
evaluator is the same numpy code, so spaces are equal exactly; the
streaming evaluator (f32 on the device) keeps the same surviving
cascades with acc/time within 1e-6; plans pick the same cascade ids in
the same order; engine row sets and per-level row counts are identical.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import TahomaCNNConfig as JCfg  # noqa: E402
from repro.core.pipeline import initialize_system  # noqa: E402
from repro.core.transforms import Representation as JRep  # noqa: E402
from repro.data.synthetic import (DEFAULT_PREDICATES, make_corpus,  # noqa
                                  make_multi_corpus, three_way_split)
from repro.engine import algebra as jalg  # noqa: E402
from repro.engine import ingest as jing  # noqa: E402
from repro.engine import planner as jplan  # noqa: E402
from repro.engine.scan import ScanEngine as JEngine  # noqa: E402
from repro_torch.configs.base import TahomaCNNConfig as TCfg  # noqa: E402
from repro_torch.core.costs import CostProfile  # noqa: E402
from repro_torch.core.pipeline import (ModelBank, ModelEntry,  # noqa: E402
                                       TahomaSystem, build_scan_engine,
                                       system_from_bank)
from repro_torch.core.transforms import Representation  # noqa: E402
from repro_torch.engine import algebra as talg  # noqa: E402
from repro_torch.engine import ingest as ting  # noqa: E402
from repro_torch.engine import planner as tplan  # noqa: E402
from repro_torch.engine.scan import (ScanEngine, VirtualColumnStore,  # noqa
                                     naive_scan)
from repro_torch.engine.sharded import ShardedScanEngine  # noqa: E402
from repro_torch.models.cnn import params_from_jax  # noqa: E402

SPECS = DEFAULT_PREDICATES[:2]


def _port_bank(jbank):
    return ModelBank([
        ModelEntry(e.name, TCfg(**dataclasses.asdict(e.arch)),
                   Representation(e.rep.resolution, e.rep.color),
                   params_from_jax(jax.tree.map(np.asarray, e.params),
                                   "cpu"), e.trusted)
        for e in jbank.entries], device="cpu")


def _port_system(js):
    """A port system over the reference system's eval scores, thresholds
    and measured inference costs (one score matrix for both)."""
    bank = _port_bank(js.bank)
    profile = CostProfile.modeled(js.infer_s, list(set(bank.reps)),
                                  base_hw=js.profile.base_hw)
    return TahomaSystem(bank, js.p_low, js.p_high, dict(js.infer_s),
                        profile, js.eval_scores, js.eval_truth, js.targets)


@pytest.fixture(scope="module")
def world():
    reps = [JRep(8, "gray"), JRep(16, "gray"), JRep(32, "rgb")]
    jsys, tsys, splits = {}, {}, {}
    for spec in SPECS:
        x, y = make_corpus(spec, 160, hw=32, seed=0)
        tr, cf, ev = three_way_split(x, y, seed=1)
        jsys[spec.name] = initialize_system(tr, cf, ev, [JCfg(1, 8, 16)],
                                            reps, steps=30)
        tsys[spec.name] = _port_system(jsys[spec.name])
        splits[spec.name] = (cf, ev)
    qx, _ = make_multi_corpus(SPECS, 128, hw=32, seed=5, positive_rate=0.4)
    meta = {"cam": np.arange(len(qx)) % 2}
    return dict(jsys=jsys, tsys=tsys, splits=splits, qx=qx, meta=meta)


def _ids(space):
    return list(zip(space.kind.tolist(), space.i1.tolist(),
                    space.i2.tolist()))


def _query(world, min_acc=False):
    clauses = []
    for s in SPECS:
        acc = None
        if min_acc:
            sp = world["jsys"][s.name].cascade_space("CAMERA")
            acc = float(np.quantile(sp.acc, 0.9))
        clauses.append((s.name, acc))
    return (jplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
                jplan.PredicateClause(n, min_accuracy=a) for n, a in clauses]),
            tplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
                tplan.PredicateClause(n, min_accuracy=a)
                for n, a in clauses]))


# --------------------------------------------------------- pipeline -------
@pytest.mark.parametrize("concept", [s.name for s in SPECS])
def test_system_from_bank_matches_reference(world, concept):
    js = world["jsys"][concept]
    cf, ev = world["splits"][concept]
    ts = system_from_bank(world["tsys"][concept].bank, cf, ev,
                          infer_s=js.infer_s)
    np.testing.assert_allclose(ts.eval_scores, js.eval_scores, atol=1e-5,
                               rtol=0)
    assert np.array_equal(ts.p_low, js.p_low)
    assert np.array_equal(ts.p_high, js.p_high)
    assert ts.profile.transform_s == js.profile.transform_s
    assert ts.bank.names == js.bank.names
    assert ts.bank.trusted_index == js.bank.trusted_index


# --------------------------------------------------------- cascade space --
@pytest.mark.parametrize("scenario", ["CAMERA", "ARCHIVE"])
@pytest.mark.parametrize("concept", [s.name for s in SPECS])
def test_dense_space_identical(world, concept, scenario):
    js = world["jsys"][concept].cascade_space(scenario)
    ts = world["tsys"][concept].cascade_space(scenario)
    assert _ids(js) == _ids(ts)
    assert np.array_equal(js.acc, ts.acc)
    assert np.array_equal(js.time_s, ts.time_s)


@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("concept", [s.name for s in SPECS])
def test_streaming_space_matches(world, concept, kernel):
    js = world["jsys"][concept].cascade_space("CAMERA", streaming=True,
                                              chunk=4)
    ts = world["tsys"][concept].cascade_space(
        "CAMERA", streaming=True, chunk=4, use_kernel_matmul=kernel)
    assert js.evaluated == ts.evaluated
    assert set(_ids(js)) == set(_ids(ts))
    order_j, order_t = np.lexsort((js.i2, js.i1, js.kind)), \
        np.lexsort((ts.i2, ts.i1, ts.kind))
    np.testing.assert_allclose(ts.acc[order_t], js.acc[order_j], atol=1e-6)
    np.testing.assert_allclose(ts.time_s[order_t], js.time_s[order_j],
                               atol=1e-6)


# --------------------------------------------------------- planner --------
@pytest.mark.parametrize("min_acc", [False, True])
@pytest.mark.parametrize("joint", [False, True])
def test_plan_picks_same_cascades_in_same_order(world, joint, min_acc):
    jq, tq = _query(world, min_acc)
    jp = jplan.plan_query(world["jsys"], jq, joint=joint,
                          metadata=world["meta"])
    tp = tplan.plan_query(world["tsys"], tq, joint=joint,
                          metadata=world["meta"])
    assert [c.key for c in jp.cascades] == [c.key for c in tp.cascades]
    assert [p.description for p in jp.predicates] == \
        [p.description for p in tp.predicates]
    assert tp.estimated_cost_per_row() == \
        pytest.approx(jp.estimated_cost_per_row(), rel=1e-12)
    txt = tp.explain(n_rows=len(world["qx"]), base_hw=32)
    assert "PHYSICAL PLAN" in txt
    assert all(f"contains({s.name})" in txt for s in SPECS)


def test_later_slices_raise_not_implemented(world):
    """Expression trees, ingest indexes, the sharded engine and the
    representation cache are ported: nothing here refuses any more (the
    name is kept)."""
    _, tq = _query(world)
    tree = talg.And(talg.Pred(SPECS[0].name), talg.Not(talg.Pred(
        SPECS[1].name)))
    assert isinstance(tplan.plan_query(world["tsys"],
                                       tplan.QuerySpec(where=tree)),
                      talg.TreePlan)
    index = ting.CandidateIndex(len(world["qx"]), [])
    plan = tplan.plan_query(world["tsys"], tq, index=index)
    assert isinstance(plan, tplan.PhysicalPlan) and plan.index is index
    assert isinstance(build_scan_engine(world["qx"], shards=2, device="cpu"),
                      ShardedScanEngine)
    from repro.serve.repcache import corpus_token as j_token
    from repro_torch.serve import RepresentationCache
    cache = RepresentationCache()
    eng = ScanEngine(world["qx"], repcache=cache, device="cpu")
    assert eng.repcache is cache and cache._corpus == j_token(world["qx"])


# --------------------------------------------------------- scan engine ----
SCAN_CASES = [  # fused, lazy, int8, use_kernel, monitor
    (True, True, False, None, False), (True, True, True, None, False),
    (True, True, False, True, False), (True, True, True, True, False),
    (False, True, False, None, False), (True, False, False, None, False),
    (True, True, False, None, True),
]


@pytest.mark.parametrize("fused,lazy,int8,use_kernel,monitor", SCAN_CASES)
def test_scan_engine_matches_reference(world, fused, lazy, int8,
                                       use_kernel, monitor):
    jq, tq = _query(world)
    jp = jplan.plan_query(world["jsys"], jq, joint=True)
    tp = tplan.plan_query(world["tsys"], tq, joint=True)
    qx, meta = world["qx"], world["meta"]
    jeng = JEngine(qx, meta, chunk=32, fused=fused, lazy=lazy, int8=int8)
    teng = build_scan_engine(qx, meta, chunk=32, fused=fused, lazy=lazy,
                             int8=int8, use_kernel=use_kernel, device="cpu")
    jmon = jplan.OnlineReorderer.from_plan(jp, min_rows=8) \
        if monitor else None
    tmon = tplan.OnlineReorderer.from_plan(tp, min_rows=8) \
        if monitor else None
    jr = jeng.execute(jp.cascades, jp.metadata_eq, monitor=jmon)
    tr = teng.execute(tp.cascades, tp.metadata_eq, monitor=tmon)
    assert np.array_equal(jr.indices, tr.indices)
    assert jr.stats.level_rows == tr.stats.level_rows
    assert [s.rows_evaluated for s in jr.stats.stages] == \
        [s.rows_evaluated for s in tr.stats.stages]
    assert tr.stats.pyramid_levels == jr.stats.pyramid_levels
    ref = naive_scan(qx, tp.cascades, meta, tp.metadata_eq, chunk=32,
                     int8=int8 and fused, device="cpu")
    assert np.array_equal(tr.indices, ref)
    # a re-planned rerun is answered from the virtual columns
    again = teng.execute(tp.cascades, tp.metadata_eq)
    assert np.array_equal(again.indices, tr.indices)
    assert again.stats.rows_evaluated == 0


def _pinned(js):
    """The reference system priced by each model's FLOPs at 1 GFLOP/s
    instead of its measured wall-clock costs (which flip the plan between
    machines), and its port twin."""
    from repro.core.costs import CostProfile as JProfile
    from repro.models.cnn import cnn_flops
    infer = {e.name: cnn_flops(e.arch) / 1e9 for e in js.bank.entries}
    jp = dataclasses.replace(
        js, infer_s=infer, space_cache={}, dec_cache={},
        profile=JProfile.modeled(infer, list(set(js.bank.reps)),
                                 base_hw=js.profile.base_hw))
    return jp, _port_system(jp)


@pytest.mark.parametrize("shards", [1, 8])
def test_joint_plan_rows_identical_sharded(world, shards):
    """tests/test_joint_planner.py::test_joint_plan_rows_identical_sharded
    with pinned costs and no accuracy floor (on this world the reference
    test's floor of 0.6 plans single 32 px models): the joint plan (the
    reference's cascades, with a level below the base) on a sharded
    engine returns the serial engines' rows, and every shard that scanned
    rows reports the plan's level set plus the base."""
    pinned = {n: _pinned(js) for n, js in world["jsys"].items()}
    qx, meta = world["qx"], world["meta"]
    clauses = [(s.name, None) for s in SPECS]
    jp = jplan.plan_query(
        {n: p[0] for n, p in pinned.items()},
        jplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
            jplan.PredicateClause(n, min_accuracy=a) for n, a in clauses]),
        scenario="CAMERA", metadata=meta, joint=True, costing="engine")
    tp = tplan.plan_query(
        {n: p[1] for n, p in pinned.items()},
        tplan.QuerySpec(metadata_eq={"cam": 0}, predicates=[
            tplan.PredicateClause(n, min_accuracy=a) for n, a in clauses]),
        scenario="CAMERA", metadata=meta, joint=True, costing="engine")
    assert [c.key for c in tp.cascades] == [c.key for c in jp.cascades]
    assert set(tp.level_set) - {qx.shape[1]}       # a non-base level
    ref = ScanEngine(qx, meta, chunk=32, device="cpu").execute(
        tp.cascades, tp.metadata_eq)
    jref = JEngine(qx, meta, chunk=32).execute(jp.cascades, jp.metadata_eq)
    assert np.array_equal(ref.indices, jref.indices)
    eng = ShardedScanEngine(qx, meta, shards=shards, chunk=32, device="cpu")
    res = eng.execute(tp.cascades, tp.metadata_eq)
    assert np.array_equal(res.indices, ref.indices)
    for sh in res.stats.shards:
        if sh.rows_scanned:
            assert set(sh.pyramid_levels) == \
                set(tp.level_set) | {qx.shape[1]}


def test_virtual_column_store_round_trip(tmp_path):
    store = VirtualColumnStore(6)
    store.record(("a", (1, 2, 3)), np.array([0, 4]), [1, 0])
    path = tmp_path / "store.npz"
    store.save(path, token=(6.0, 1.5))
    back = VirtualColumnStore.load(path, token=(6.0, 1.5))
    assert back.keys() == store.keys()
    assert np.array_equal(back.column(("a", (1, 2, 3))),
                          store.column(("a", (1, 2, 3))))
    with pytest.raises(ValueError):
        VirtualColumnStore.load(path, token=(7.0,))


# ------------------------------------------------ expression trees --------
WHERE_TREES = [
    lambda m, a, b: m.Or(m.And(m.Pred(a), m.Not(m.Pred(b))), m.Pred(b)),
    lambda m, a, b: m.Not(m.Or(m.Pred(a), m.Pred(b))),
    lambda m, a, b: m.And(m.Pred(a), m.Or(m.Pred(b), m.Not(m.Pred(a)))),
    lambda m, a, b: m.Join(m.Pred(a), m.Not(m.Pred(b)), delta_t=4),
]


def _plan_shape(node):
    if node.op == "pred":
        return ("pred", node.cascade.key, node.negated, node.description,
                node.est_sel, node.est_cost, node.index_cached)
    return (node.op, node.est_sel, node.est_cost,
            tuple(_plan_shape(c) for c in node.children))


@pytest.mark.parametrize("case", range(len(WHERE_TREES)))
def test_where_plan_matches_reference(world, case):
    """plan_query(where=) picks the same cascades, negations and child
    order as the reference, with the same estimates and EXPLAIN; the
    port's tree executor returns the reference's rows."""
    a, b = (s.name for s in SPECS)
    qx, meta = world["qx"], dict(world["meta"],
                                 t=np.arange(len(world["qx"])) * 3)
    join = case == len(WHERE_TREES) - 1
    md = (meta, meta) if join else meta
    tp = tplan.plan_query(world["tsys"], tplan.QuerySpec(
        where=WHERE_TREES[case](talg, a, b)), metadata=md)
    jp = jplan.plan_query(world["jsys"], jplan.QuerySpec(
        where=WHERE_TREES[case](jalg, a, b)), metadata=md)
    if join:
        assert tp.build_side == jp.build_side
        assert tp.est_pairs == jp.est_pairs
        sides = [(tp.left, jp.left), (tp.right, jp.right)]
    else:
        sides = [(tp, jp)]
    for t, j in sides:
        assert _plan_shape(t.root) == _plan_shape(j.root)
    assert tp.explain() == jp.explain()
    if join:
        res = talg.execute_join((ScanEngine(qx, meta, chunk=32, device="cpu"),
                                 ScanEngine(qx, meta, chunk=32, device="cpu")),
                                tp)
        ref = jalg.execute_join((JEngine(qx, meta, chunk=32),
                                 JEngine(qx, meta, chunk=32)), jp)
        assert np.array_equal(res.pairs, ref.pairs)
    else:
        res = talg.execute_tree(ScanEngine(qx, meta, chunk=32, device="cpu"),
                                tp)
        ref = jalg.execute_tree(JEngine(qx, meta, chunk=32), jp)
        assert np.array_equal(res.indices, ref.indices)


# --------------------------------------------------------- ingest index ---
@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("joint", [False, True])
def test_index_plan_matches_reference(world, joint, mode):
    """Plan, ingest the corpus with the plan's cascades (the trained
    stage-0 CNN is the anchor's real rung, weights via params_from_jax),
    re-plan with index=: the same cascades and order as the reference,
    the same EXPLAIN ingest line, and indexed_execute's rows."""
    jq, tq = _query(world, min_acc=True)
    qx, meta = world["qx"], world["meta"]
    jp0 = jplan.plan_query(world["jsys"], jq, joint=joint)
    tp0 = tplan.plan_query(world["tsys"], tq, joint=joint)
    assert [c.key for c in jp0.cascades] == [c.key for c in tp0.cascades]
    jpipe = jing.IngestPipeline(jp0.cascades, len(qx), chunk=32)
    tpipe = ting.IngestPipeline(tp0.cascades, len(qx), chunk=32,
                                device="cpu")
    jpipe.run(qx)
    tpipe.run(qx)
    assert dataclasses.asdict(tpipe.stats) == dataclasses.asdict(jpipe.stats)
    for k in jpipe.index.decided.keys():
        assert np.array_equal(tpipe.index.decided.column(k),
                              jpipe.index.decided.column(k))
    jp = jplan.plan_query(world["jsys"], jq, joint=joint,
                          index=jpipe.index, index_mode=mode)
    tp = tplan.plan_query(world["tsys"], tq, joint=joint,
                          index=tpipe.index, index_mode=mode)
    assert [c.key for c in jp.cascades] == [c.key for c in tp.cascades]
    assert tp.estimated_cost_per_row() == \
        pytest.approx(jp.estimated_cost_per_row(), rel=1e-12)
    assert tp.index_mode == mode and tp.index is tpipe.index
    line = [ln for ln in tp.explain(n_rows=len(qx)).splitlines()
            if "ingest index:" in ln]
    assert line == [ln for ln in jp.explain(n_rows=len(qx)).splitlines()
                    if "ingest index:" in ln] and len(line) == 1
    tres = ting.indexed_execute(ScanEngine(qx, meta, chunk=32,
                                           device="cpu"), tp)
    jres = jing.indexed_execute(JEngine(qx, meta, chunk=32), jp)
    assert np.array_equal(tres.indices, jres.indices)
    if mode == "exact":
        cold = ScanEngine(qx, meta, chunk=32, device="cpu").execute(
            tp.cascades, tp.metadata_eq)
        assert np.array_equal(tres.indices, cold.indices)
