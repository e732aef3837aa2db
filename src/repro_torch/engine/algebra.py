"""Relational query algebra over the scan engines (DESIGN.md §15), in
numpy over the port's engine calls.

The planner (engine/planner.py) optimizes CONJUNCTIVE predicate chains —
Tahoma's query model. This module generalizes the query surface to full
boolean expression trees plus cross-corpus temporal joins, as a layer
ABOVE the existing engines rather than a new executor:

* **Logical nodes** — ``Pred`` / ``And`` / ``Or`` / ``Not`` compose
  arbitrarily; ``Join(left, right, delta_t)`` (root only) asks for frame
  pairs from two corpora within ``delta_t`` of each other that each
  satisfy their side's tree ("cam A and cam B both see X within Δt").

* **Normalization** — ``normalize`` rewrites to negation normal form:
  double negations cancel, De Morgan pushes every ``Not`` down to a
  leaf, same-op children flatten. A negated LEAF is executable: the
  scan records the cascade's label for every candidate row into the
  engine's ``VirtualColumnStore`` int8 column, and the decided-**0**
  rows of that column are exactly ¬Pred — so NOT costs one ordinary
  cascade evaluation, shares its virtual column with the positive
  predicate, and stays bit-exact.

* **Cost-based rewriting** — every plan node carries an estimated
  selectivity (P(true), independence across leaves) and an expected
  cost per candidate row derived from the same ``DecomposedCost`` /
  ``estimate_selectivity`` machinery the conjunctive planner uses.
  Child ordering short-circuits: AND children by the classical rank
  cost/(1−sel) ascending; OR children by the INVERTED rank cost/sel
  ascending — an OR branch stops on the first TRUE, so the most
  selective (rarely-true) branch belongs LAST (by De Morgan an OR chain
  is an AND chain over complements: rank c/(1−(1−s)) = c/s; proof
  sketch in DESIGN.md §15.2). Small fan-outs are ordered exhaustively
  against the exact chain-cost function, which also prices
  shared-pyramid savings inside runs of positive leaves. Joins choose
  the cheap side first and push the temporal window down as a
  prefilter on the expensive side (§15.3).

* **Execution** — ``execute_tree`` lowers each maximal run of positive
  leaves under an AND onto ONE ``ScanEngine.execute`` call (shared
  pyramid, lazy materialization, virtual columns — all reused), and
  combines branch survivor sets with numpy mask algebra: AND threads
  survivors left-to-right, OR evaluates each branch only on rows no
  earlier branch accepted. Per-row label independence makes every
  evaluation order return the same row set (differential-tested against
  ``naive_tree_rows``, the per-row oracle, in
  tests/test_torch_algebra.py). On a card a concept's stage 0 is scored
  by the fused kernel where its cascade leads an engine call and by
  ``models/cnn`` elsewhere; the two agree within f32 tolerance, so a
  row whose scores straddle a threshold may differ between orders and
  from the oracle. ``execute_join`` evaluates the
  planned build side, prefilters the probe side to rows within
  ``delta_t`` of a surviving build timestamp (semantics-preserving:
  rows outside every window can never join), then verifies pairs with
  a temporal hash join on binned timestamps.

``TreePlan.explain`` / ``JoinPlan.explain`` render the annotated
relational-algebra tree — per-node estimated cost, selectivity and
cardinality, and (after execution) actual row counts next to the
estimates.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.costs import DecomposedCost
from repro_torch.core.selector import select
from repro_torch.engine.scan import CompiledCascade, naive_scan


# ------------------------------------------------------ logical nodes ----
@dataclass(frozen=True)
class Pred:
    """contains_object(<concept>) leaf with the user's constraint."""
    concept: str
    min_accuracy: float | None = None
    min_throughput: float | None = None


@dataclass(frozen=True)
class Not:
    child: object


class _NaryOp:
    __slots__ = ("children",)

    def __init__(self, *children):
        if not children:
            raise ValueError(f"{type(self).__name__} needs >= 1 child")
        self.children = tuple(children)

    def __repr__(self):
        inner = ", ".join(map(repr, self.children))
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other):
        return type(other) is type(self) and other.children == self.children

    def __hash__(self):
        return hash((type(self).__name__, self.children))


class And(_NaryOp):
    """Variadic conjunction."""


class Or(_NaryOp):
    """Variadic disjunction."""


@dataclass(frozen=True)
class Join:
    """Cross-corpus temporal join (ROOT node only): pairs (a, b) with a
    from the left corpus satisfying ``left``, b from the right corpus
    satisfying ``right``, and |t_a − t_b| <= delta_t on the named
    metadata timestamp columns."""
    left: object
    right: object
    delta_t: float
    left_time: str = "t"
    right_time: str = "t"


# ------------------------------------------------------- normalization ---
def normalize(tree):
    """Negation normal form: double negations cancel, De Morgan pushes
    NOT to the leaves, nested same-op children flatten, single-child
    And/Or collapse. Pure boolean-algebra rewrites — row-set preserving
    (property-tested in tests/test_torch_algebra.py). Idempotent."""
    if isinstance(tree, Pred):
        return tree
    if isinstance(tree, Not):
        inner = tree.child
        if isinstance(inner, Not):                      # ¬¬x = x
            return normalize(inner.child)
        if isinstance(inner, And):                      # ¬(a∧b) = ¬a∨¬b
            return normalize(Or(*[Not(c) for c in inner.children]))
        if isinstance(inner, Or):                       # ¬(a∨b) = ¬a∧¬b
            return normalize(And(*[Not(c) for c in inner.children]))
        if isinstance(inner, Pred):
            return tree
        raise TypeError(f"cannot negate {inner!r}")
    if isinstance(tree, (And, Or)):
        cls = type(tree)
        flat = []
        for c in tree.children:
            c = normalize(c)
            if type(c) is cls:
                flat.extend(c.children)
            else:
                flat.append(c)
        return flat[0] if len(flat) == 1 else cls(*flat)
    if isinstance(tree, Join):
        raise TypeError("Join may only appear at the root of a query "
                        "tree (plan_expression handles it there)")
    raise TypeError(f"not an expression node: {tree!r}")


# ----------------------------------------------------------- plan tree ---
@dataclass
class PlanNode:
    """One annotated relational-algebra node. ``est_*`` are planner
    estimates (per candidate row); ``rows_in``/``rows_out``/``seconds``
    are actuals filled in by ``execute_tree``."""
    op: str                                  # 'pred' | 'and' | 'or'
    children: list = field(default_factory=list)
    # pred leaves
    cascade: CompiledCascade | None = None
    negated: bool = False
    selection: object | None = None
    description: str = ""
    decomposed: DecomposedCost | None = None
    index_cached: float = 0.0    # fraction answered from seeded columns
    # annotations
    est_sel: float = 1.0
    est_cost: float = 0.0        # expected seconds per candidate row
    # actuals
    rows_in: int | None = None
    rows_out: int | None = None
    seconds: float | None = None

    def clear_actuals(self) -> None:
        self.rows_in = self.rows_out = self.seconds = None
        for c in self.children:
            c.clear_actuals()

    def leaves(self) -> list["PlanNode"]:
        if self.op == "pred":
            return [self]
        return [l for c in self.children for l in c.leaves()]


@dataclass
class TreePlan:
    """Physical plan for one boolean expression tree over ONE corpus.
    The tree-algebra sibling of planner.PhysicalPlan; ``explain()`` is
    the tree renderer the conjunctive plan's EXPLAIN grew into."""
    scenario: str
    metadata_eq: dict
    root: PlanNode
    meta_selectivity: float | None = None
    index: object | None = None     # engine/ingest.CandidateIndex
    optimized: bool = True

    @property
    def cascades(self) -> list:
        """Distinct cascades, in leaf order."""
        seen, out = set(), []
        for leaf in self.root.leaves():
            if leaf.cascade.key not in seen:
                seen.add(leaf.cascade.key)
                out.append(leaf.cascade)
        return out

    def cascade_map(self) -> dict:
        """concept -> cascade, for the naive per-row oracle. Refuses
        trees that bind one concept to two different cascades (the
        oracle's mask cache is keyed by concept)."""
        out = {}
        for leaf in self.root.leaves():
            prev = out.setdefault(leaf.cascade.concept, leaf.cascade)
            if prev.key != leaf.cascade.key:
                raise ValueError(
                    f"concept {leaf.cascade.concept!r} planned with two "
                    "different cascades; per-concept oracle undefined")
        return out

    def clear_actuals(self) -> None:
        self.root.clear_actuals()

    def estimated_cost_per_row(self) -> float:
        return self.root.est_cost

    def explain(self, n_rows: int | None = None) -> str:
        lines = [f"ALGEBRA PLAN  scenario={self.scenario}"
                 f"  metadata_eq={self.metadata_eq or {}}"
                 + ("" if self.optimized else "  [UNOPTIMIZED]")]
        if self.meta_selectivity is not None:
            lines.append(f"  metadata selectivity ~{self.meta_selectivity:.2f}")
        if self.index is not None:
            lines.append("  index: seeds engine store with exact "
                         "decided labels (prefilter unsound under "
                         "OR/NOT — seeding only)")
        est_in = float(n_rows) if n_rows is not None else (
            float(self.root.rows_in) if self.root.rows_in is not None
            else None)
        _render_node(self.root, lines, "", "", est_in)
        return "\n".join(lines)


def _node_label(node: PlanNode) -> str:
    if node.op == "pred":
        neg = "NOT " if node.negated else ""
        return f"{neg}contains({node.cascade.concept})"
    return node.op.upper()


def _render_node(node: PlanNode, lines: list, pad: str, branch: str,
                 est_in: float | None) -> None:
    card = ""
    if est_in is not None:
        card = f"  rows~{est_in:.0f}->{est_in * node.est_sel:.0f}"
    act = ""
    if node.rows_in is not None:
        act = f"  actual {node.rows_in}->{node.rows_out}"
    detail = (f"  [sel={node.est_sel:.2f}"
              f" cost/row={node.est_cost * 1e6:.1f}us{card}{act}]")
    extra = ""
    if node.op == "pred" and node.description:
        extra = f"  {node.description}"
        if node.index_cached:
            extra += f"  (index answers {node.index_cached:.0%})"
    lines.append(f"{pad}{branch}{_node_label(node)}{detail}{extra}")
    child_pad = pad + ("" if not branch else
                       ("   " if branch.startswith("└") else "│  "))
    # estimated input cardinality per child under short-circuit order
    frac = 1.0
    for i, c in enumerate(node.children):
        child_in = None if est_in is None else est_in * frac
        glyph = "└─ " if i == len(node.children) - 1 else "├─ "
        _render_node(c, lines, child_pad, glyph, child_in)
        frac *= c.est_sel if node.op == "and" else (1.0 - c.est_sel)


@dataclass
class JoinPlan:
    """Root-level cross-corpus temporal join plan: two TreePlans, the
    window, and the cost-chosen build side (evaluated first, its
    surviving timestamps prefilter the probe side)."""
    left: TreePlan
    right: TreePlan
    delta_t: float
    time_cols: tuple                 # (left_col, right_col)
    build_side: int                  # 0 = left evaluated first
    est_pairs: float = 0.0
    est_cost_s: float = 0.0          # expected total seconds, both sides
    window_kept: int | None = None   # probe candidates after pushdown
    actual_pairs: int | None = None

    def explain(self, n_rows: tuple | None = None) -> str:
        build = "left" if self.build_side == 0 else "right"
        act = ("" if self.actual_pairs is None
               else f"  actual pairs={self.actual_pairs}")
        kept = ("" if self.window_kept is None
                else f"  probe window kept={self.window_kept}")
        lines = [
            f"JOIN  |t_left - t_right| <= {self.delta_t:g}"
            f"  on ({self.time_cols[0]}, {self.time_cols[1]})",
            f"  build side={build} (cheap side first)"
            f"  est pairs~{self.est_pairs:.0f}"
            f"  est cost~{self.est_cost_s * 1e3:.1f}ms{kept}{act}",
        ]
        nl, nr = (None, None) if n_rows is None else n_rows
        lines.append("├─ LEFT")
        lines.extend("│  " + ln for ln in
                     self.left.explain(nl).splitlines())
        lines.append("└─ RIGHT")
        lines.extend("   " + ln for ln in
                     self.right.explain(nr).splitlines())
        return "\n".join(lines)


# -------------------------------------------------------- plan builder ---
def _meta_sel(metadata_eq, metadata) -> float | None:
    if not metadata_eq or metadata is None:
        return None
    mask = np.ones(len(next(iter(metadata.values()))), bool)
    for col, val in metadata_eq.items():
        mask &= np.asarray(metadata[col]) == val
    return float(mask.mean())


def _plan_leaf(systems: Mapping, pred: Pred, negated: bool, *,
               scenario: str, max_level: int, index) -> PlanNode:
    system = systems[pred.concept]
    space = system.cascade_space(scenario, max_level=max_level)
    sel = select(space, min_accuracy=pred.min_accuracy,
                 min_throughput=pred.min_throughput)
    casc = system.compiled_cascade(space, sel.index, concept=pred.concept)
    dec = system.decomposed_cost(space, sel.index, scenario,
                                 dense_levels=True)
    frac, cost, cached = casc.selectivity, dec.total_s, 0.0
    if index is not None:
        eval_frac, frac = index.planning_stats(casc.key, frac,
                                               prefilter=False)
        cached = 1.0 - eval_frac
        cost *= eval_frac
    return PlanNode(
        "pred", cascade=casc, negated=negated, selection=sel,
        description=space.describe(sel.index, system.bank.names,
                                   system.targets),
        decomposed=dec, index_cached=cached,
        est_sel=(1.0 - frac) if negated else frac, est_cost=cost)


def _chain_cost(op: str, ordered: Sequence[PlanNode]) -> float:
    """Expected seconds per candidate row of evaluating ``ordered``
    children with short-circuiting. AND stops at the first FALSE (later
    children pay only on survivors, Π sel); OR stops at the first TRUE
    (later children pay only on rejects, Π (1−sel)). Runs of positive
    leaves under an AND execute as one engine call sharing a pyramid,
    so their representation charges are priced marginally
    (DecomposedCost.marginal_s); any other child is its own engine call
    and the materialized-level set resets."""
    total, p = 0.0, 1.0
    mat: set = set()
    for node in ordered:
        in_run = (op == "and" and node.op == "pred" and not node.negated
                  and node.decomposed is not None)
        if in_run:
            c = node.decomposed.marginal_s(mat) * (1.0 - node.index_cached)
            mat = mat | node.decomposed.levels
        else:
            c, mat = node.est_cost, set()
        total += p * c
        p *= node.est_sel if op == "and" else (1.0 - node.est_sel)
    return total


_EXHAUSTIVE_LIMIT = 6


def order_children(op: str, kids: list) -> list:
    """Cost-based short-circuit ordering of one node's children. Small
    fan-outs are ordered exhaustively against ``_chain_cost`` (which
    also sees shared-pyramid savings inside positive-leaf runs); larger
    ones greedily by rank — AND: cost/(1−sel) ascending (the classical
    conjunctive rank), OR: cost/sel ascending (the INVERTED rank: a
    branch short-circuits on TRUE, so the most selective branch goes
    last — DESIGN.md §15.2)."""
    if len(kids) <= _EXHAUSTIVE_LIMIT:
        best = min(itertools.permutations(range(len(kids))),
                   key=lambda p: (_chain_cost(op, [kids[i] for i in p]), p))
        return [kids[i] for i in best]

    def rank(node):
        miss = (1.0 - node.est_sel) if op == "and" else node.est_sel
        r = node.est_cost / miss if miss > 0 else float("inf")
        return (r, node.est_cost)
    return sorted(kids, key=rank)


def _plan_node(systems, tree, *, scenario, max_level, index,
               optimize) -> PlanNode:
    if isinstance(tree, Pred):
        return _plan_leaf(systems, tree, False, scenario=scenario,
                          max_level=max_level, index=index)
    if isinstance(tree, Not):        # NNF: child is a Pred
        return _plan_leaf(systems, tree.child, True, scenario=scenario,
                          max_level=max_level, index=index)
    op = "and" if isinstance(tree, And) else "or"
    kids = [_plan_node(systems, c, scenario=scenario, max_level=max_level,
                       index=index, optimize=optimize)
            for c in tree.children]
    if optimize:
        kids = order_children(op, kids)
    sels = [k.est_sel for k in kids]
    prod = float(np.prod(sels)) if op == "and" \
        else float(np.prod([1.0 - s for s in sels]))
    return PlanNode(op, children=kids,
                    est_sel=prod if op == "and" else 1.0 - prod,
                    est_cost=_chain_cost(op, kids))


def plan_expression(systems, tree, *, scenario: str = "CAMERA",
                    max_level: int = 3, metadata=None, metadata_eq=None,
                    index=None, optimize: bool = True):
    """Compile a boolean expression tree (or a root ``Join``) into an
    annotated, cost-ordered physical plan. ``systems``: concept ->
    TahomaSystem (shared by both join sides). For a ``Join`` root,
    ``metadata``/``metadata_eq`` are (left, right) pairs and the
    metadata must hold the join's timestamp columns; the cheap side
    (estimated per-row cost × candidate rows) becomes the build side.
    ``index`` (engine/ingest.CandidateIndex) conditions leaf cost and
    selectivity on its decided columns and makes ``execute_tree`` seed
    the engine store — exact labels only, no row pruning (pruning
    decided-0 rows is unsound under OR/NOT). ``optimize=False`` keeps
    the user's child order and makes ``execute_tree`` evaluate every
    child on its node's full input (the benchmark baseline)."""
    if isinstance(tree, Join):
        metas = metadata or (None, None)     # {} (the QuerySpec
        eqs = metadata_eq or (None, None)     # default) means absent
        left = plan_expression(systems, tree.left, scenario=scenario,
                               max_level=max_level, metadata=metas[0],
                               metadata_eq=eqs[0], index=None,
                               optimize=optimize)
        right = plan_expression(systems, tree.right, scenario=scenario,
                                max_level=max_level, metadata=metas[1],
                                metadata_eq=eqs[1], index=None,
                                optimize=optimize)
        return _plan_join(tree, left, right, metas, optimize=optimize)
    root = _plan_node(systems, normalize(tree), scenario=scenario,
                      max_level=max_level, index=index, optimize=optimize)
    return TreePlan(scenario, dict(metadata_eq or {}), root,
                    _meta_sel(metadata_eq, metadata), index=index,
                    optimized=optimize)


def _side_stats(plan: TreePlan, meta, time_col: str):
    t = np.asarray(meta[time_col], np.float64)
    n = len(t)
    meta_frac = plan.meta_selectivity if plan.meta_selectivity is not None \
        else 1.0
    cand = n * meta_frac
    surv = cand * plan.root.est_sel
    span = max(float(t.max() - t.min()), 1.0) if n else 1.0
    return cand, surv, span, cand * plan.root.est_cost


def _plan_join(tree: Join, left: TreePlan, right: TreePlan, metas, *,
               optimize: bool) -> JoinPlan:
    if metas[0] is None or metas[1] is None:
        raise ValueError("Join planning needs (left, right) metadata "
                         "holding the timestamp columns")
    cl, sl, spl, costl = _side_stats(left, metas[0], tree.left_time)
    cr, sr, spr, costr = _side_stats(right, metas[1], tree.right_time)
    w = 2.0 * float(tree.delta_t)
    # pushdown: after the build side survives, the probe side only
    # evaluates rows inside some window — expected kept fraction
    cov_r = min(1.0, sl * w / spr)     # probe=right if build=left
    cov_l = min(1.0, sr * w / spl)
    cost_left_first = costl + costr * cov_r
    cost_right_first = costr + costl * cov_l
    build = 0 if (cost_left_first <= cost_right_first or not optimize) \
        else 1
    est_pairs = sl * min(1.0, w / spr) * sr if sr else 0.0
    return JoinPlan(left, right, float(tree.delta_t),
                    (tree.left_time, tree.right_time), build,
                    est_pairs=est_pairs,
                    est_cost_s=min(cost_left_first, cost_right_first))


def plan_from_cascades(tree, cascades: Mapping, *, metadata=None,
                       metadata_eq=None, index=None,
                       optimize: bool = True) -> TreePlan:
    """Build a TreePlan (or JoinPlan for a ``Join`` root) from
    pre-compiled cascades (concept -> CompiledCascade) instead of
    trained systems — leaf estimates come from the cascade's own
    ``cost_s``/``selectivity`` fields. The tests' and benchmarks'
    entry point; ``plan_expression`` is the trained-system twin. For a
    Join root, ``metadata``/``metadata_eq`` are (left, right) pairs."""
    if isinstance(tree, Join):
        metas = metadata or (None, None)     # {} (the QuerySpec
        eqs = metadata_eq or (None, None)     # default) means absent
        left = plan_from_cascades(tree.left, cascades, metadata=metas[0],
                                  metadata_eq=eqs[0], optimize=optimize)
        right = plan_from_cascades(tree.right, cascades,
                                   metadata=metas[1], metadata_eq=eqs[1],
                                   optimize=optimize)
        return _plan_join(tree, left, right, metas, optimize=optimize)

    def build(t) -> PlanNode:
        if isinstance(t, (Pred, Not)):
            pred = t.child if isinstance(t, Not) else t
            casc = cascades[pred.concept]
            frac, cost, cached = casc.selectivity, casc.cost_s, 0.0
            if index is not None:
                eval_frac, frac = index.planning_stats(casc.key, frac,
                                                       prefilter=False)
                cached = 1.0 - eval_frac
                cost *= eval_frac
            neg = isinstance(t, Not)
            return PlanNode("pred", cascade=casc, negated=neg,
                            index_cached=cached,
                            est_sel=(1.0 - frac) if neg else frac,
                            est_cost=cost)
        op = "and" if isinstance(t, And) else "or"
        kids = [build(c) for c in t.children]
        if optimize:
            kids = order_children(op, kids)
        sels = [k.est_sel for k in kids]
        prod = float(np.prod(sels)) if op == "and" \
            else float(np.prod([1.0 - s for s in sels]))
        return PlanNode(op, children=kids,
                        est_sel=prod if op == "and" else 1.0 - prod,
                        est_cost=_chain_cost(op, kids))

    root = build(normalize(tree))
    return TreePlan("CAMERA", dict(metadata_eq or {}), root,
                    _meta_sel(metadata_eq, metadata), index=index,
                    optimized=optimize)


# ------------------------------------------------------------ executor ---
@dataclass
class AlgebraResult:
    indices: np.ndarray
    plan: TreePlan
    engine_calls: int = 0
    rows_evaluated: int = 0       # cascade rows actually run (not cached)
    seconds: float = 0.0


@dataclass
class JoinResult:
    pairs: np.ndarray             # (n, 2) int64 (left_row, right_row)
    plan: JoinPlan
    left: AlgebraResult | None = None
    right: AlgebraResult | None = None
    seconds: float = 0.0


def _count(ctr: dict, res) -> None:
    ctr["calls"] += 1
    stats = getattr(res, "stats", None)
    stages = getattr(stats, "stages", None) or []
    ctr["rows"] += int(sum(s.rows_evaluated for s in stages))


def _scan_run(engine, leaves: list, ids: np.ndarray, ctr: dict) \
        -> np.ndarray:
    """One engine call for a maximal run of positive leaves: shared
    pyramid, masked later stages, virtual columns — the existing
    conjunctive hot path."""
    t0 = time.perf_counter()
    if not len(ids):
        out = ids
        stage_rows = [0] * (len(leaves) + 1)
    else:
        res = engine.execute([l.cascade for l in leaves], None,
                             survivors=ids)
        _count(ctr, res)
        out = np.asarray(res.indices, np.int64)
        stages = res.stats.stages
        stage_rows = [s.rows_in for s in stages] + [len(out)]
    dt = time.perf_counter() - t0
    for j, leaf in enumerate(leaves):
        leaf.rows_in, leaf.rows_out = stage_rows[j], stage_rows[j + 1]
        leaf.seconds = dt if j == 0 else 0.0
    return out


def _eval_leaf(engine, node: PlanNode, ids: np.ndarray, ctr: dict) \
        -> np.ndarray:
    if not len(ids):
        return ids
    res = engine.execute([node.cascade], None, survivors=ids)
    _count(ctr, res)
    if not node.negated:
        return np.asarray(res.indices, np.int64)
    # the scan decided EVERY candidate row (evaluated or cache-served);
    # the cascade's int8 virtual column now holds 0 exactly on ¬Pred
    return engine.store.rows_with_label(node.cascade.key, ids, 0)


def _run_groups(children: list) -> list:
    """Maximal runs of consecutive positive pred leaves (one engine
    call each); every other child is its own singleton group."""
    groups, run = [], []
    for c in children:
        if c.op == "pred" and not c.negated:
            run.append(c)
        else:
            if run:
                groups.append(run)
                run = []
            groups.append([c])
    if run:
        groups.append(run)
    return groups


def _eval_node(engine, node: PlanNode, ids: np.ndarray, opt: bool,
               ctr: dict) -> np.ndarray:
    t0 = time.perf_counter()
    node.rows_in = int(len(ids))
    if node.op == "pred":
        out = _eval_leaf(engine, node, ids, ctr)
    elif node.op == "and":
        if opt:
            cur = ids
            for group in _run_groups(node.children):
                if len(group) > 1 or (group[0].op == "pred"
                                      and not group[0].negated):
                    cur = _scan_run(engine, group, cur, ctr)
                else:
                    cur = _eval_node(engine, group[0], cur, opt, ctr)
            out = cur
        else:
            out = ids
            for c in node.children:
                out = np.intersect1d(out,
                                     _eval_node(engine, c, ids, opt, ctr))
    elif node.op == "or":
        if opt:
            remaining, hits = ids, []
            for c in node.children:
                acc = _eval_node(engine, c, remaining, opt, ctr)
                hits.append(acc)
                remaining = np.setdiff1d(remaining, acc)
            out = (np.sort(np.concatenate(hits)) if hits
                   else ids[:0])
        else:
            out = ids[:0]
            for c in node.children:
                out = np.union1d(out,
                                 _eval_node(engine, c, ids, opt, ctr))
    else:
        raise ValueError(f"unknown plan op {node.op!r}")
    out = np.sort(np.asarray(out, np.int64))
    node.rows_out = int(len(out))
    node.seconds = time.perf_counter() - t0
    return out


def execute_tree(engine, plan: TreePlan, *, optimize: bool | None = None,
                 within: np.ndarray | None = None) -> AlgebraResult:
    """Evaluate a TreePlan against a scan engine.
    ``optimize`` overrides the plan's mode: True short-circuits (each
    child sees only the rows earlier siblings left undecided) and
    lowers positive-leaf runs onto single engine calls; False evaluates
    every child on its node's full input and mask-combines at the end
    (the unoptimized baseline). Both return the same row set — per-row
    label independence (on a card, up to the threshold-boundary rows the
    module docstring names). ``within`` restricts the candidate rows
    (the join executor's window pushdown). Fills per-node actuals the
    EXPLAIN renderer shows."""
    opt = plan.optimized if optimize is None else optimize
    plan.clear_actuals()
    t0 = time.perf_counter()
    if plan.index is not None:
        plan.index.seed_store(engine.store, exact=True)
    ids = np.where(engine.metadata_mask(plan.metadata_eq))[0] \
        .astype(np.int64)
    if within is not None:
        ids = np.intersect1d(ids, np.asarray(within, np.int64))
    ctr = {"calls": 0, "rows": 0}
    out = _eval_node(engine, plan.root, ids, opt, ctr)
    return AlgebraResult(out, plan, ctr["calls"], ctr["rows"],
                         time.perf_counter() - t0)


# ------------------------------------------------------- temporal join ---
def temporal_hash_join(ids_left, t_left, ids_right, t_right,
                       delta: float) -> np.ndarray:
    """Exact band join |t_l − t_r| <= delta as a hash join on binned
    timestamps: the smaller side hashes into width-``delta`` buckets,
    the larger probes its own bucket ± 1 (a window of width 2·delta
    spans at most 3 consecutive buckets) and verifies the band exactly.
    Returns (n, 2) int64 (left_row, right_row) pairs, lexicographically
    sorted — bit-comparable with the naive nested loop."""
    ids_l = np.asarray(ids_left, np.int64)
    ids_r = np.asarray(ids_right, np.int64)
    tl = np.asarray(t_left, np.float64)
    tr = np.asarray(t_right, np.float64)
    if not len(ids_l) or not len(ids_r):
        return np.empty((0, 2), np.int64)
    width = float(delta) if delta > 0 else 1.0
    flip = len(ids_l) > len(ids_r)          # hash the smaller side
    b_ids, b_t = (ids_r, tr) if flip else (ids_l, tl)
    p_ids, p_t = (ids_l, tl) if flip else (ids_r, tr)
    table: dict = {}
    for i, t in zip(b_ids, b_t[b_ids]):
        table.setdefault(int(np.floor(t / width)), []).append(i)
    out = []
    for j, t in zip(p_ids, p_t[p_ids]):
        k = int(np.floor(t / width))
        for kk in (k - 1, k, k + 1):
            for i in table.get(kk, ()):
                ti = b_t[i]
                if abs(t - ti) <= delta:
                    out.append((j, i) if flip else (i, j))
    if not out:
        return np.empty((0, 2), np.int64)
    pairs = np.asarray(out, np.int64)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]


def execute_join(engines, plan: JoinPlan, *,
                 optimize: bool | None = None) -> JoinResult:
    """Evaluate a JoinPlan against (left_engine, right_engine). With
    optimization, the planned build (cheap) side runs first and the
    probe side's candidates are pushed down to rows within ``delta_t``
    of a surviving build timestamp — exact, because a row outside every
    window can never appear in a pair. ``optimize=False`` evaluates
    both sides in full (the baseline); the pairs are the same."""
    t0 = time.perf_counter()
    eng_l, eng_r = engines
    opt = (plan.left.optimized if optimize is None else optimize)
    tl = np.asarray(eng_l.metadata[plan.time_cols[0]], np.float64)
    tr = np.asarray(eng_r.metadata[plan.time_cols[1]], np.float64)
    plan.window_kept = None
    if opt:
        sides = ((eng_l, plan.left, tl), (eng_r, plan.right, tr))
        (b_eng, b_plan, b_t) = sides[plan.build_side]
        (p_eng, p_plan, p_t) = sides[1 - plan.build_side]
        b_res = execute_tree(b_eng, b_plan, optimize=True)
        # window pushdown: probe candidates within delta of a surviving
        # build timestamp
        cand = np.where(p_eng.metadata_mask(p_plan.metadata_eq))[0]
        bt = np.sort(b_t[b_res.indices])
        if len(bt):
            pos = np.searchsorted(bt, p_t[cand])
            near_r = np.take(bt, np.minimum(pos, len(bt) - 1))
            near_l = np.take(bt, np.maximum(pos - 1, 0))
            keep = (np.abs(near_r - p_t[cand]) <= plan.delta_t) | \
                   (np.abs(near_l - p_t[cand]) <= plan.delta_t)
            window = cand[keep]
        else:
            window = cand[:0]
        plan.window_kept = int(len(window))
        p_res = execute_tree(p_eng, p_plan, optimize=True, within=window)
        res_l, res_r = ((b_res, p_res) if plan.build_side == 0
                        else (p_res, b_res))
    else:
        res_l = execute_tree(eng_l, plan.left, optimize=False)
        res_r = execute_tree(eng_r, plan.right, optimize=False)
    pairs = temporal_hash_join(res_l.indices, tl, res_r.indices, tr,
                               plan.delta_t)
    plan.actual_pairs = int(len(pairs))
    return JoinResult(pairs, plan, res_l, res_r,
                      time.perf_counter() - t0)


# ------------------------------------------------------- naive oracle ----
def naive_tree_rows(images, tree, cascades: Mapping, metadata=None,
                    metadata_eq=None, *, chunk: int = 64, device=None,
                    _fn_cache: dict | None = None) -> np.ndarray:
    """The per-row differential oracle: every DISTINCT leaf concept runs
    its own naive full scan (engine/scan.naive_scan — no sharing, no
    masking, no short-circuit), then the ORIGINAL un-rewritten tree is
    evaluated as pure boolean mask algebra per row. The engine path
    (normalize → order → execute_tree) returns the same rows for every
    tree (tests/test_torch_algebra.py); on a card, a leaf that leads an
    engine call scores its stage 0 in the fused kernel and naive_scan
    in plain PyTorch, so a row whose two scores straddle a threshold
    can differ. ``device`` defaults to the images' tensor device, else
    ``cuda``."""
    n = len(images)
    mask0 = np.ones(n, bool)
    for col, val in (metadata_eq or {}).items():
        mask0 &= np.asarray(metadata[col]) == val
    masks: dict = {}

    def concept_mask(concept: str) -> np.ndarray:
        if concept not in masks:
            rows = naive_scan(images, [cascades[concept]], chunk=chunk,
                              device=device, _fn_cache=_fn_cache)
            m = np.zeros(n, bool)
            m[rows] = True
            masks[concept] = m
        return masks[concept]

    def ev(t) -> np.ndarray:
        if isinstance(t, Pred):
            return concept_mask(t.concept)
        if isinstance(t, Not):
            return ~ev(t.child)
        if isinstance(t, And):
            m = np.ones(n, bool)
            for c in t.children:
                m &= ev(c)
            return m
        if isinstance(t, Or):
            m = np.zeros(n, bool)
            for c in t.children:
                m |= ev(c)
            return m
        raise TypeError(f"not a row-wise expression node: {t!r}")

    return np.where(ev(tree) & mask0)[0].astype(np.int64)


def naive_join_pairs(left, right, delta: float) -> np.ndarray:
    """Nested-loop reference for the temporal join: ``left``/``right``
    are (row_ids, timestamps) per side; every id pair within the band
    is emitted, lexicographically sorted."""
    (ids_l, tl), (ids_r, tr) = left, right
    out = [(int(a), int(b)) for a in ids_l for b in ids_r
           if abs(float(tl[a]) - float(tr[b])) <= delta]
    if not out:
        return np.empty((0, 2), np.int64)
    return np.asarray(sorted(out), np.int64)
