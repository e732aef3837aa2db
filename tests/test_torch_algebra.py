"""engine/algebra (boolean expression trees, temporal joins) and the
QuerySpec.where path of engine/planner: the port (device="cpu", the
plain versions) against the JAX reference (on the CPU) on the same
seeded frames and the same numpy weights. Sizes are
tests/test_algebra.py's: a 160-row 32 px corpus with metadata cam = row
% 2 and t = 3 row, chunk 64, and the toy cascades a (cheap, rare), b
and c (expensive, common).

Tolerances: normalized trees, child orders, plan trees, EXPLAIN text,
row sets and join pairs are equal (on these seeds no toy score lies
within an f32 rounding of a threshold, so the last-bit differences of
the two packages move no label); cost estimates are the same float64
numpy arithmetic and equal.
"""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.costs import DecomposedCost as JDec  # noqa: E402
from repro.data.synthetic import DEFAULT_PREDICATES  # noqa: E402
from repro.engine import algebra as ja  # noqa: E402
from repro.engine.ingest import CandidateIndex as JIndex  # noqa: E402
from repro.engine.scan import ScanEngine as JEngine  # noqa: E402
from repro_torch.core.costs import DecomposedCost  # noqa: E402
from repro_torch.data.synthetic import make_two_camera_corpus  # noqa: E402
from repro_torch.engine import algebra as ta  # noqa: E402
from repro_torch.engine import planner as tplan  # noqa: E402
from repro_torch.engine.ingest import CandidateIndex  # noqa: E402
from repro_torch.engine.scan import ScanEngine  # noqa: E402
from test_query_engine import _uint8_images  # noqa: E402
from test_torch_ingest import toy_pair  # noqa: E402

CONCEPTS = ("a", "b", "c")
N, HW = 160, 32


def _pairs():
    anno = {"a": (1e-4, 0.2), "b": (2e-4, 0.5), "c": (4e-4, 0.7)}
    jc, tc = {}, {}
    for i, c in enumerate(CONCEPTS):
        j, t = toy_pair(c, i + 1)
        jc[c] = dataclasses.replace(j, cost_s=anno[c][0],
                                    selectivity=anno[c][1])
        tc[c] = dataclasses.replace(t, cost_s=anno[c][0],
                                    selectivity=anno[c][1])
    return jc, tc


@pytest.fixture(scope="module")
def setup():
    images = _uint8_images(N, HW)
    metadata = {"cam": np.arange(N) % 2,
                "t": np.arange(N, dtype=np.int64) * 3}
    jc, tc = _pairs()
    fn_cache: dict = {}
    jfn_cache: dict = {}
    masks = {}
    for c, casc in tc.items():
        rows = ta.naive_tree_rows(images, ta.Pred(c), tc, chunk=64,
                                  device="cpu", _fn_cache=fn_cache)
        m = np.zeros(N, bool)
        m[rows] = True
        masks[c] = m
    return dict(images=images, metadata=metadata, jc=jc, tc=tc,
                masks=masks, fn_cache=fn_cache, jfn_cache=jfn_cache)


def _random_tree(rng, mod, depth=3):
    kind = rng.integers(0, 4) if depth > 0 else 0
    if kind == 0:
        return mod.Pred(str(rng.choice(list(CONCEPTS))))
    if kind == 1:
        return mod.Not(_random_tree(rng, mod, depth - 1))
    kids = [_random_tree(rng, mod, depth - 1)
            for _ in range(int(rng.integers(2, 4)))]
    return mod.And(*kids) if kind == 2 else mod.Or(*kids)


def _trees(seed, depth=3):
    """The same random tree built from each package's node classes."""
    return (_random_tree(np.random.default_rng(seed), ta, depth),
            _random_tree(np.random.default_rng(seed), ja, depth))


def _mask_eval(tree, masks, n):
    if isinstance(tree, ta.Pred):
        return masks[tree.concept]
    if isinstance(tree, ta.Not):
        return ~_mask_eval(tree.child, masks, n)
    out = np.ones(n, bool) if isinstance(tree, ta.And) else np.zeros(n, bool)
    for c in tree.children:
        m = _mask_eval(c, masks, n)
        out = (out & m) if isinstance(tree, ta.And) else (out | m)
    return out


def _shape(node):
    """A plan tree as nested tuples: op, leaf cascade key and negation,
    estimates."""
    if node.op == "pred":
        return ("pred", node.cascade.key, node.negated, node.est_sel,
                node.est_cost, node.index_cached)
    return (node.op, node.est_sel, node.est_cost,
            tuple(_shape(c) for c in node.children))


# ------------------------------------------------------- normalize -------
@pytest.mark.parametrize("seed", range(6))
def test_normalize_equals_the_reference(seed):
    t, j = _trees(seed, depth=4)
    nt, nj = ta.normalize(t), ja.normalize(j)
    assert repr(nt) == repr(nj)
    assert ta.normalize(nt) == nt                 # idempotent
    rng = np.random.default_rng(seed)
    for _ in range(8):
        masks = {c: rng.random(1) < 0.5 for c in CONCEPTS}
        assert bool(_mask_eval(t, masks, 1)[0]) == \
            bool(_mask_eval(nt, masks, 1)[0])


def test_normalize_units():
    a, b, c = ta.Pred("a"), ta.Pred("b"), ta.Pred("c")
    assert ta.normalize(ta.Not(ta.Not(a))) == a
    assert ta.normalize(ta.Not(ta.And(a, b))) == ta.Or(ta.Not(a), ta.Not(b))
    assert ta.normalize(ta.And(ta.And(a, b), c)) == ta.And(a, b, c)
    assert ta.normalize(ta.And(a)) == a
    with pytest.raises(TypeError):
        ta.normalize(ta.Join(a, b, delta_t=1.0))


# -------------------------------------------------------- ordering -------
@pytest.mark.parametrize("op", ["and", "or"])
def test_order_children_equals_the_reference(op):
    rng = np.random.default_rng(7)
    for n in [2, 3, 5, 6, 9]:
        vals = [(float(rng.uniform(0.05, 0.95)), float(rng.uniform(0.1, 10)))
                for _ in range(n)]
        tk = [ta.PlanNode("pred", est_sel=s, est_cost=c) for s, c in vals]
        jk = [ja.PlanNode("pred", est_sel=s, est_cost=c) for s, c in vals]
        got = [tk.index(k) for k in ta.order_children(op, list(tk))]
        want = [jk.index(k) for k in ja.order_children(op, list(jk))]
        assert got == want
        if n <= 6:
            best = min(ta._chain_cost(op, list(p))
                       for p in itertools.permutations(tk))
            assert ta._chain_cost(op, [tk[i] for i in got]) == \
                pytest.approx(best)


def test_decomposed_cost_scaled_equals_the_reference():
    for f in (0.0, 0.37, 1.0):
        got = DecomposedCost(2.0, {8: 0.5, 16: 1.5, -1: 0.25}).scaled(f)
        want = JDec(2.0, {8: 0.5, 16: 1.5, -1: 0.25}).scaled(f)
        assert got.infer_s == want.infer_s and got.rep_s == want.rep_s
        assert got.levels == want.levels
        assert got.total_s == want.total_s


# ----------------------------------------- differential oracle (tree) ----
@pytest.mark.parametrize("seed", range(8))
def test_random_trees_equal_reference_and_naive(setup, seed):
    images, metadata = setup["images"], setup["metadata"]
    t, j = _trees(1000 + seed)
    eq = {"cam": 0} if np.random.default_rng(seed).random() < 0.5 else None
    ref = ja.execute_tree(JEngine(images, metadata, chunk=64),
                          ja.plan_from_cascades(j, setup["jc"],
                                                metadata=metadata,
                                                metadata_eq=eq)).indices
    naive = ta.naive_tree_rows(images, t, setup["tc"], metadata, eq,
                               chunk=64, device="cpu",
                               _fn_cache=setup["fn_cache"])
    assert np.array_equal(naive, ref)
    assert np.array_equal(ja.naive_tree_rows(images, j, setup["jc"],
                                             metadata, eq, chunk=64,
                                             _fn_cache=setup["jfn_cache"]),
                          ref)
    for optimize in (True, False):
        plan = ta.plan_from_cascades(t, setup["tc"], metadata=metadata,
                                     metadata_eq=eq, optimize=optimize)
        jp = ja.plan_from_cascades(j, setup["jc"], metadata=metadata,
                                   metadata_eq=eq, optimize=optimize)
        assert _shape(plan.root) == _shape(jp.root)
        res = ta.execute_tree(ScanEngine(images, metadata, chunk=64,
                                         device="cpu"), plan)
        assert np.array_equal(res.indices, ref)


def test_naive_tree_rows_equals_the_reference(setup):
    images, metadata = setup["images"], setup["metadata"]
    t = ta.And(ta.Pred("a"), ta.Not(ta.And(ta.Pred("b"),
                                           ta.Not(ta.Pred("c")))))
    j = ja.And(ja.Pred("a"), ja.Not(ja.And(ja.Pred("b"),
                                           ja.Not(ja.Pred("c")))))
    got = ta.naive_tree_rows(images, t, setup["tc"], metadata, {"cam": 0},
                             chunk=64, device="cpu")
    want = ja.naive_tree_rows(images, j, setup["jc"], metadata, {"cam": 0},
                              chunk=64)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.where(
        _mask_eval(t, setup["masks"], N) & (metadata["cam"] == 0))[0])


# ------------------------------------------------------ index seeding ----
def test_index_seeding_equal_rows_fewer_evaluations(setup):
    images, metadata, masks = setup["images"], setup["metadata"], \
        setup["masks"]
    tidx = CandidateIndex(N, list(setup["tc"].values()))
    jidx = JIndex(N, list(setup["jc"].values()))
    rng = np.random.default_rng(11)
    for c in ("a", "b"):
        decided = np.where(rng.random(N) < 0.6)[0]
        lab = masks[c][decided].astype(np.int8)
        tidx.decided.record(setup["tc"][c].key, decided, lab)
        jidx.decided.record(setup["jc"][c].key, decided, lab)
    t = ta.Or(ta.And(ta.Pred("a"), ta.Pred("b")), ta.Not(ta.Pred("c")))
    j = ja.Or(ja.And(ja.Pred("a"), ja.Pred("b")), ja.Not(ja.Pred("c")))
    ref = np.where(_mask_eval(t, masks, N))[0]
    cold = ta.execute_tree(ScanEngine(images, metadata, chunk=64,
                                      device="cpu"),
                           ta.plan_from_cascades(t, setup["tc"],
                                                 metadata=metadata))
    plan = ta.plan_from_cascades(t, setup["tc"], metadata=metadata,
                                 index=tidx)
    jplan_ = ja.plan_from_cascades(j, setup["jc"], metadata=metadata,
                                   index=jidx)
    assert _shape(plan.root) == _shape(jplan_.root)
    seeded = ta.execute_tree(ScanEngine(images, metadata, chunk=64,
                                        device="cpu"), plan)
    jres = ja.execute_tree(JEngine(images, metadata, chunk=64), jplan_)
    assert np.array_equal(cold.indices, ref)
    assert np.array_equal(seeded.indices, ref)
    assert np.array_equal(jres.indices, ref)
    assert seeded.rows_evaluated < cold.rows_evaluated
    assert (seeded.engine_calls, seeded.rows_evaluated) == \
        (jres.engine_calls, jres.rows_evaluated)
    assert plan.explain(n_rows=N) == jplan_.explain(n_rows=N)
    assert "index" in plan.explain(n_rows=N).lower()


# ---------------------------------------------------------- joins --------
@pytest.mark.parametrize("seed", range(6))
def test_temporal_hash_join_equals_nested_loop(seed):
    rng = np.random.default_rng(seed)
    nl, nr = int(rng.integers(0, 12)), int(rng.integers(0, 12))
    integer = seed % 2 == 0          # the generator's int64 timestamps
    tl = (rng.integers(0, 40, 16) if integer else rng.uniform(0, 40, 16))
    tr = (rng.integers(0, 40, 16) if integer else rng.uniform(0, 40, 16))
    ids_l = rng.choice(16, nl, replace=False).astype(np.int64)
    ids_r = rng.choice(16, nr, replace=False).astype(np.int64)
    delta = int(rng.integers(1, 6)) if integer else \
        float(rng.uniform(0.1, 6.0))
    got = ta.temporal_hash_join(ids_l, tl, ids_r, tr, delta)
    assert np.array_equal(got, ta.naive_join_pairs((ids_l, tl), (ids_r, tr),
                                                   delta))
    assert np.array_equal(got, ja.temporal_hash_join(ids_l, tl, ids_r, tr,
                                                     delta))


@pytest.fixture(scope="module")
def cameras():
    (xa, _, ta_), (xb, _, tb) = make_two_camera_corpus(
        DEFAULT_PREDICATES[:3], 96, hw=HW, seed=1)
    return (xa, {"t": ta_}), (xb, {"t": tb})


JOIN_TREES = [
    lambda m: m.Join(m.Pred("a"), m.Or(m.Pred("b"), m.Not(m.Pred("c"))),
                     delta_t=3),
    lambda m: m.Join(m.Pred("a"), m.Pred("a"), delta_t=2),
    lambda m: m.Join(m.And(m.Pred("b"), m.Pred("c")), m.Pred("a"),
                     delta_t=2),
    lambda m: m.Join(m.And(m.Pred("a"), m.Not(m.Pred("a"))), m.Pred("b"),
                     delta_t=3),
]


@pytest.mark.parametrize("case", range(len(JOIN_TREES)))
def test_join_pairs_equal_the_reference(setup, cameras, case):
    (xa, ma), (xb, mb) = cameras
    t, j = JOIN_TREES[case](ta), JOIN_TREES[case](ja)
    fn_cache = setup["fn_cache"]
    rows_l = ta.naive_tree_rows(xa, t.left, setup["tc"], chunk=64,
                                device="cpu", _fn_cache=fn_cache)
    rows_r = ta.naive_tree_rows(xb, t.right, setup["tc"], chunk=64,
                                device="cpu", _fn_cache=fn_cache)
    naive = ta.naive_join_pairs((rows_l, ma["t"]), (rows_r, mb["t"]),
                                t.delta_t)
    jplan_ = ja.plan_from_cascades(j, setup["jc"], metadata=(ma, mb))
    ref = ja.execute_join((JEngine(xa, ma, chunk=64),
                           JEngine(xb, mb, chunk=64)), jplan_)
    assert np.array_equal(naive, ref.pairs)
    for optimize in (True, False):
        plan = ta.plan_from_cascades(t, setup["tc"], metadata=(ma, mb),
                                     optimize=optimize)
        assert plan.build_side == (jplan_.build_side if optimize else 0)
        res = ta.execute_join((ScanEngine(xa, ma, chunk=64, device="cpu"),
                               ScanEngine(xb, mb, chunk=64, device="cpu")),
                              plan)
        assert res.pairs.dtype == np.int64
        assert np.array_equal(res.pairs, ref.pairs)
        if optimize:
            assert plan.window_kept == jplan_.window_kept
            assert plan.explain() == jplan_.explain()


# --------------------------------------------------------- explain -------
def test_explain_renders_annotated_tree(setup):
    images, metadata = setup["images"], setup["metadata"]
    t = ta.And(ta.Pred("a"), ta.Or(ta.Pred("b"), ta.Not(ta.Pred("c"))))
    j = ja.And(ja.Pred("a"), ja.Or(ja.Pred("b"), ja.Not(ja.Pred("c"))))
    plan = ta.plan_from_cascades(t, setup["tc"], metadata=metadata,
                                 metadata_eq={"cam": 0})
    jp = ja.plan_from_cascades(j, setup["jc"], metadata=metadata,
                               metadata_eq={"cam": 0})
    txt = plan.explain(n_rows=N)
    assert txt == jp.explain(n_rows=N)
    assert "ALGEBRA PLAN" in txt and "NOT contains(c)" in txt
    assert "└─" in txt
    ta.execute_tree(ScanEngine(images, metadata, chunk=64, device="cpu"),
                    plan)
    ja.execute_tree(JEngine(images, metadata, chunk=64), jp)
    after = plan.explain(n_rows=N)
    assert "actual" in after
    strip = [ln.split("  actual")[0] for ln in after.splitlines()]
    assert strip == [ln.split("  actual")[0]
                     for ln in jp.explain(n_rows=N).splitlines()]
    acts = [ln.split("  actual ")[1].split("]")[0]
            for ln in after.splitlines() if "actual" in ln]
    assert acts == [ln.split("  actual ")[1].split("]")[0]
                    for ln in jp.explain(n_rows=N).splitlines()
                    if "actual" in ln]


# ------------------------------------------------- QuerySpec.where seams --
def test_where_refusals():
    tree = ta.Pred("a")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tplan.plan_query({}, tplan.QuerySpec(
            where=tree, predicates=[tplan.PredicateClause("a")]))
    with pytest.raises(ValueError, match="exact"):
        tplan.plan_query({}, tplan.QuerySpec(where=tree), index=object(),
                         index_mode="approx")
    with pytest.raises(ValueError, match="index mode"):
        tplan.plan_query({}, tplan.QuerySpec(where=tree), index_mode="x")
