"""Logical→physical query planner (DESIGN.md §4.1, §11; paper Fig. 2,
§IV–VI).

A content-based query = metadata equality predicates AND N
contains-object predicates. The planner turns that LOGICAL query into a
PHYSICAL plan, in one of two modes:

**Independent** (``joint=False``, the PR-2 planner):

1. per predicate, pick ONE cascade from the concept's Pareto frontier
   under the current CostProfile / deployment scenario (core/selector),
   honoring the clause's accuracy/throughput constraint;
2. estimate each selected cascade's per-row cost (the §VI expected
   seconds/image of the evaluated space) and selectivity (positive
   fraction simulated over the cached eval scores — core/selector);
3. order the binary predicates by the classical rank
   cost / (1 - selectivity), ascending — the optimal order for
   independent AND predicates: it minimizes
   Σ_k cost_k · Π_{j<k} selectivity_j
   (NoScope / probabilistic-predicates style predicate ordering).

**Joint** (``joint=True``, DESIGN.md §11): the scan engine materializes
ONE shared representation pyramid per chunk covering the union of every
selected cascade's levels, so per-predicate standalone costing
double-charges every shared level. Joint planning selects the cascade
SET across all predicates instead: per-predicate Pareto frontiers are
the candidate pools (core/selector.select_candidates), each candidate
carries a decomposed cost (core/costs.DecomposedCost: inference
separated from per-pyramid-level representation handling), and the
search minimizes ``joint_scan_cost`` — shared pyramid levels priced
ONCE, at the survival fraction of the first predicate that touches them;
later predicates pay only their MARGINAL representation cost. The
independent selection is always a member of the search space, so the
joint plan never prices worse than the independent plan (property-tested
in tests/test_joint_planner.py, with a brute-force oracle on tiny
spaces).

Ownership: the planner owns WHAT runs (cascade set, pyramid level set,
predicate order) and hands the engine CompiledCascades; engine/scan.py
owns HOW (chunking, the shared pyramid materialization of exactly
``PhysicalPlan.level_set``, buffering, virtual columns). ``explain()``
prints the EXPLAIN-style physical plan including per-predicate
shared-representation savings. ``OnlineReorderer`` is the planner's
mid-scan hook: the engine feeds observed per-flush selectivities back
and the hook re-orders surviving predicates when the estimates drift —
bit-identical row sets by per-row label independence (DESIGN.md §11.3).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.costs import FULL_LOAD, DecomposedCost
from repro_torch.core.selector import (Selection, estimate_selectivity, select,
                                 select_candidates)
from repro_torch.engine.scan import CompiledCascade


@dataclass
class PredicateClause:
    """Logical contains_object(<concept>) with the user's constraint."""
    concept: str
    min_accuracy: float | None = None
    min_throughput: float | None = None


@dataclass
class QuerySpec:
    """SELECT frames WHERE metadata_eq AND contains(c1) AND ... .

    ``where`` generalizes the conjunctive ``predicates`` list to a full
    boolean expression tree (engine/algebra: And/Or/Not/Pred, or a
    root Join; DESIGN.md §15). When set, ``plan_query`` compiles it via
    the tree algebra instead and returns a TreePlan/JoinPlan —
    ``predicates`` must then be empty."""
    metadata_eq: dict = field(default_factory=dict)
    predicates: list = field(default_factory=list)   # [PredicateClause]
    where: object | None = None                      # algebra expression


@dataclass
class PlannedPredicate:
    cascade: CompiledCascade
    selection: Selection
    description: str      # human-readable cascade (space.describe)
    rank: float           # cost / (1 - selectivity); plan order key
    # joint-plan extras (None/() on independent plans): the §VI cost
    # split, the rep cost NOT covered by earlier predicates' levels, and
    # the pyramid levels inherited from them (DESIGN.md §11)
    decomposed: DecomposedCost | None = None
    marginal_rep_s: float | None = None
    shared_levels: tuple = ()


@dataclass
class PhysicalPlan:
    scenario: str
    metadata_eq: dict
    predicates: list      # [PlannedPredicate] in execution order
    meta_selectivity: float | None = None
    joint: bool = False   # cascade set chosen by the joint optimizer
    costing: str = "paper"   # joint costing mode: 'engine' prices the
    #                          scan paths' full-width (dense) level
    #                          execution with LAZY first-touch level
    #                          materialization (engine/scan
    #                          .level_schedule); 'paper' the §VI
    #                          per-image walk
    # ingest-time candidate-concept index (engine/ingest.CandidateIndex)
    # consulted as a metadata-like pre-filter (DESIGN.md §14). index_mode
    # 'exact' prunes only on ingest decisions the query-time cascade
    # would repeat (own-pixel confident stage-0 labels); 'approx' also
    # trusts skip-aliases and candidate pruning at the index's
    # measured-recall knob.
    index: object | None = None
    index_mode: str = "exact"

    @property
    def cascades(self) -> list:
        return [p.cascade for p in self.predicates]

    @property
    def level_set(self) -> tuple:
        """Union of pyramid resolutions the plan's cascades touch,
        descending — exactly the per-chunk materialization set the scan
        engine builds (engine/scan.stage_needs adds the raw base)."""
        return tuple(sorted({r.resolution for p in self.predicates
                             for r in p.cascade.reps}, reverse=True))

    def estimated_cost_per_row(self) -> float:
        """Expected engine seconds per metadata-surviving row. Joint
        plans price shared pyramid levels once (joint_scan_cost), at
        the survival fraction of the first stage touching them — the
        engine's LAZY first-touch materialization (dense_reps=False);
        independent plans keep the standalone per-cascade sum."""
        if self.joint and all(p.decomposed is not None
                              for p in self.predicates):
            return joint_scan_cost(
                [p.decomposed for p in self.predicates],
                [p.cascade.selectivity for p in self.predicates],
                dense_reps=False)
        return expected_scan_cost(
            [p.cascade.cost_s for p in self.predicates],
            [p.cascade.selectivity for p in self.predicates])

    def materialization_schedule(self, base_hw: int) -> dict:
        """Non-base pyramid level -> the stage that first materializes
        it under the engine's lazy schedule (engine/scan
        .level_schedule): 0 for chunk-ingest levels (the first
        cascade's own resolutions), s >= 1 for levels first-touch
        derived inside stage s's flush. The measured counterpart is
        ScanStats.level_rows: on a cold scan, an ingest level is pooled
        for every scanned row and a first-touch level for exactly the
        rows its stage evaluates."""
        from repro_torch.engine.scan import level_schedule
        ingest, _, derive = level_schedule(self.cascades, base_hw, True)
        out = {r: 0 for r in ingest}
        for s, res in enumerate(derive):
            for r in res:
                out[r] = s
        return out

    def expected_level_rows(self, n_rows: int, base_hw: int) -> dict:
        """Estimated per-level materialization counts for a COLD scan
        of ``n_rows`` metadata-surviving rows: level -> expected rows
        pooled. Ingest levels are charged for every scanned row; a
        first-touch level for the estimated survivors reaching its
        stage. The measured counterpart is ScanStats.level_rows
        (rendered side by side by ``explain(actual=...)``)."""
        sched = self.materialization_schedule(base_hw)
        survive = [1.0]
        for p in self.predicates:
            survive.append(survive[-1]
                           * min(max(p.cascade.selectivity, 0.0), 1.0))
        return {r: n_rows * survive[s] for r, s in sched.items()}

    def index_prefilter(self, ids: np.ndarray) -> np.ndarray:
        """The metadata-like ingest-index pre-filter (DESIGN.md §14):
        of the metadata-surviving ``ids``, the rows a scan must still
        evaluate. Rows the index already decided 0 for any planned
        predicate — or, in 'approx' mode, rows whose candidate set
        excludes a planned concept — are dropped here and their
        cascades never run. No-op (all ids survive) without an index."""
        ids = np.asarray(ids, np.int64)
        if self.index is None:
            return ids
        return self.index.survivors(ids, self.cascades,
                                    exact=self.index_mode == "exact")

    def unshared_cost_per_row(self) -> float:
        """The SAME cascades and order priced without representation
        sharing (every predicate pays its standalone cost, in this
        plan's costing mode) — the baseline of explain()'s
        shared-representation savings. Under engine costing the
        unshared rep charges are at probability 1 per predicate while
        the joint pricing charges marginal rep costs at the (<= 1)
        survival fraction of the first touch, so savings are always
        >= 0."""
        sels = [p.cascade.selectivity for p in self.predicates]
        if self.joint and self.costing == "engine" and \
                all(p.decomposed is not None for p in self.predicates):
            return (sum(p.decomposed.rep_total_s
                        for p in self.predicates)
                    + expected_scan_cost(
                        [p.decomposed.infer_s for p in self.predicates],
                        sels))
        return expected_scan_cost(
            [p.cascade.cost_s if p.decomposed is None
             else p.decomposed.total_s for p in self.predicates], sels)

    def explain(self, n_rows: int | None = None, *,
                base_hw: int | None = None, actual=None) -> str:
        """EXPLAIN-style physical plan: predicate order, chosen cascade,
        estimated cost + selectivity per predicate, totals. Joint plans
        additionally print, per predicate, the pyramid levels it touches
        (``levels=``), the levels inherited from earlier predicates
        (``shared=``), and its marginal vs standalone representation
        cost — plus a summary line with the plan-wide
        shared-representation savings and the pyramid level set the
        engine touches. With ``base_hw`` (the corpus base resolution)
        the plan also prints the lazy materialization schedule
        (which stage first touches each level) and the estimated
        per-level row counts; ``actual`` (a ScanStats /
        ShardedScanStats from executing this plan, or a bare
        ``level_rows`` dict) renders measured counts side by side —
        estimated-vs-actual agreement is the engine-costing contract
        (DESIGN.md §13)."""
        lines = [f"PHYSICAL PLAN  scenario={self.scenario}  "
                 f"binary predicates={len(self.predicates)}"
                 + (f"  [joint, {self.costing} costing]"
                    if self.joint else "")]
        meta = " AND ".join(f"{k} == {v!r}"
                            for k, v in (self.metadata_eq or {}).items())
        if meta:
            sel = ("" if self.meta_selectivity is None
                   else f"   (est. selectivity {self.meta_selectivity:.2f})")
            lines.append(f"  metadata: {meta}{sel}")
        if self.index is not None:
            lines.append("  ingest index: "
                         + self.index.describe(
                             self.cascades,
                             exact=self.index_mode == "exact"))
        survive = 1.0
        for i, p in enumerate(self.predicates, 1):
            c = p.cascade
            lines.append(
                f"  {i}. contains({c.concept})  cascade[{c.cascade_id}] "
                f"{p.description}")
            lines.append(
                f"     acc={p.selection.accuracy:.3f}  "
                f"cost/row={c.cost_s * 1e6:.1f}us  "
                f"sel={c.selectivity:.2f}  rank={p.rank * 1e6:.1f}us  "
                f"rows reaching: {survive:.2f}")
            if p.decomposed is not None:
                d = p.decomposed
                lvl = ",".join(str(r) for r in
                               sorted(set(d.rep_s) - {FULL_LOAD},
                                      reverse=True))
                sh = (",".join(str(r) for r in p.shared_levels)
                      if p.shared_levels else "-")
                marg = (d.rep_total_s if p.marginal_rep_s is None
                        else p.marginal_rep_s)
                lines.append(
                    f"     levels={{{lvl}}}  shared={{{sh}}}  rep/row "
                    f"marginal {marg * 1e6:.1f}us vs standalone "
                    f"{d.rep_total_s * 1e6:.1f}us  "
                    f"infer/row {d.infer_s * 1e6:.1f}us")
            survive *= c.selectivity
        naive = sum(p.cascade.cost_s if p.decomposed is None
                    else p.decomposed.total_s for p in self.predicates)
        eng = self.estimated_cost_per_row()
        lines.append(f"  est. cost/row {eng * 1e6:.1f}us (engine, ordered+"
                     f"masked) vs {naive * 1e6:.1f}us (per-predicate full "
                     f"scans){f'  [{naive / eng:.1f}x]' if eng else ''}")
        if self.joint:
            unshared = self.unshared_cost_per_row()
            saved = unshared - eng
            ratio = f"  [{unshared / eng:.2f}x]" if eng else ""
            lines.append(
                f"  shared-representation savings: {saved * 1e6:.1f}us/row"
                f" — joint {eng * 1e6:.1f}us vs unshared "
                f"{unshared * 1e6:.1f}us{ratio}; pyramid level set "
                f"{{{','.join(str(r) for r in self.level_set)}}} "
                f"materialized once per chunk")
        if n_rows is not None:
            m = self.meta_selectivity if self.meta_selectivity is not None \
                else 1.0
            lines.append(f"  est. rows: {n_rows} scanned -> "
                         f"{n_rows * m:.0f} past metadata -> "
                         f"{n_rows * m * survive:.0f} returned")
        if base_hw is not None:
            sched = self.materialization_schedule(base_hw)
            if sched:
                lines.append(
                    "  lazy level schedule: " + ", ".join(
                        f"{r}@" + ("ingest" if s == 0
                                   else f"stage{s + 1}")
                        for r, s in sorted(sched.items(), reverse=True)))
                lr = (actual if actual is None or isinstance(actual, dict)
                      else actual.level_rows)
                if n_rows is not None or lr is not None:
                    m = (self.meta_selectivity
                         if self.meta_selectivity is not None else 1.0)
                    est = (self.expected_level_rows(
                        int(round(n_rows * m)), base_hw)
                        if n_rows is not None else {})
                    parts = []
                    for r in sorted(set(est) | set(lr or {}),
                                    reverse=True):
                        e = f"{est[r]:.0f} est" if r in est else "? est"
                        a = (f" -> {int((lr or {}).get(r, 0))} actual"
                             if lr is not None else "")
                        parts.append(f"{r}: {e}{a}")
                    lines.append("  level rows: " + "; ".join(parts))
        return "\n".join(lines)


# ----------------------------------------------------------- ordering -----
def predicate_rank(cost: float, selectivity: float) -> float:
    """The ordering key cost / (1 - selectivity): expected spend per unit
    of filtering. A predicate that filters nothing (selectivity 1) ranks
    infinite and goes last. The SAME value is stored on
    PlannedPredicate.rank and shown by EXPLAIN."""
    s = min(max(float(selectivity), 0.0), 1.0)
    denom = 1.0 - s
    return float(cost) / denom if denom > 0.0 else float("inf")


def order_predicates(costs, selectivities) -> list[int]:
    """Optimal evaluation order for independent AND predicates: ascending
    predicate_rank (ties: cheaper first). Greedy-exchange argument:
    swapping adjacent out-of-rank predicates never decreases
    Σ_k c_k · Π_{j<k} s_j — verified against brute force in
    tests/test_query_engine.py."""
    rank = np.array([predicate_rank(c, s)
                     for c, s in zip(costs, selectivities)])
    return list(np.lexsort((np.asarray(costs, np.float64), rank)))


def expected_scan_cost(costs, selectivities, order=None) -> float:
    """Expected per-row cost of an AND chain evaluated in ``order``:
    predicate k only runs on rows surviving 1..k-1."""
    if order is None:
        order = range(len(costs))
    total, p = 0.0, 1.0
    for i in order:
        total += p * float(costs[i])
        p *= min(max(float(selectivities[i]), 0.0), 1.0)
    return total


# ------------------------------------------- shared-representation cost ---
def joint_scan_cost(decs: Sequence[DecomposedCost], selectivities,
                    order=None, *, dense_reps: bool = False) -> float:
    """Expected per-row cost of an AND chain under shared-representation
    pricing (DESIGN.md §11): predicate k pays its inference plus only
    the pyramid levels NO earlier predicate materialized — each shared
    level is priced once. With ``dense_reps=False`` a level is charged
    at the survival fraction of the first predicate touching it (the
    §VI-style rule); with disjoint level sets this reduces exactly to
    ``expected_scan_cost`` of the standalone totals and never exceeds
    it for any fixed (set, order). With lazy scheduling
    (engine/scan.level_schedule, the engines' default) the scan paths
    materialize each later-stage-only level at first touch BY
    SURVIVORS, so the survival-weighted rule prices exactly what they
    pay — 'engine' costing uses it too. ``dense_reps=True`` charges
    each first-touched level at probability 1 instead, pricing the
    EAGER (``lazy=False``) engine, which materializes the full union
    pyramid at chunk ingest for every scanned row; it is kept as the
    reference/benchmark-baseline pricing."""
    if order is None:
        order = range(len(decs))
    total, p = 0.0, 1.0
    mat: set = set()
    for i in order:
        d = decs[i]
        rep_w = 1.0 if dense_reps else p
        total += p * d.infer_s + rep_w * d.marginal_rep_s(mat)
        mat |= d.levels
        p *= min(max(float(selectivities[i]), 0.0), 1.0)
    return total


def order_predicates_shared(decs: Sequence[DecomposedCost],
                            selectivities, *,
                            exhaustive_limit: int = 6,
                            dense_reps: bool = False) -> list[int]:
    """Evaluation order under shared-representation pricing. Marginal
    rep cost depends on what earlier predicates materialized, so the
    adjacent-exchange argument behind ``order_predicates`` no longer
    applies; for k <= ``exhaustive_limit`` (every realistic query) the
    k! orders are searched exactly — cheap, since ``joint_scan_cost``
    is O(k x levels). Longer chains fall back to the greedy
    marginal-rank rule: repeatedly take the remaining predicate with
    the smallest marginal_cost / (1 - selectivity), accumulating its
    levels into the materialized set (ties: cheaper marginal cost,
    then original position)."""
    k = len(decs)
    if k <= exhaustive_limit:
        best = min(itertools.permutations(range(k)),
                   key=lambda o: (joint_scan_cost(decs, selectivities, o,
                                                  dense_reps=dense_reps),
                                  o))
        return list(best)
    order: list[int] = []
    mat: set = set()
    remaining = list(range(k))
    while remaining:
        pick = min(remaining,
                   key=lambda i: (predicate_rank(decs[i].marginal_s(mat),
                                                 selectivities[i]),
                                  decs[i].marginal_s(mat), i))
        order.append(pick)
        remaining.remove(pick)
        mat |= decs[pick].levels
    return order


# ------------------------------------------------------------ planning ----
def _meta_selectivity(spec: QuerySpec, metadata) -> float | None:
    if metadata is None or not spec.metadata_eq:
        return None
    mask = np.ones(len(next(iter(metadata.values()))), bool)
    for col, val in spec.metadata_eq.items():
        mask &= np.asarray(metadata[col]) == val
    return float(mask.mean())


def plan_query(systems: Mapping, spec: QuerySpec, *,
               scenario: str = "CAMERA", max_level: int = 3,
               metadata: Mapping[str, np.ndarray] | None = None,
               joint: bool = False, costing: str = "engine",
               max_combos: int = 20000, index=None,
               index_mode: str = "exact") -> PhysicalPlan:
    """systems: concept -> TahomaSystem (core/pipeline.py) holding the
    trained grid + cached evaluated spaces. metadata: the corpus metadata
    columns, if available, to estimate the metadata selectivity shown in
    EXPLAIN. ``joint=True`` selects the cascade SET across predicates
    under shared-representation costing (see module docstring; the
    search enumerates at most ``max_combos`` frontier combinations,
    trimming pools cheapest-standalone-first beyond that but always
    retaining the independent selection, which caps the search while
    preserving the never-worse guarantee). ``costing`` (joint only):
    'engine' (default) prices cascades as the scan paths execute them —
    full-width DENSE levels (core/costs.decompose_cascade_cost
    dense_levels) — so the optimizer minimizes what the engine actually
    pays; 'paper' keeps the §VI reach-weighted per-image walk (whose
    totals equal CascadeSpace.time_s). ``index`` attaches an ingest-time
    candidate-concept index (engine/ingest.CandidateIndex) the plan
    consults as a metadata-like pre-filter (PhysicalPlan.index_prefilter,
    DESIGN.md §14); ``index_mode`` is 'exact' (only ingest decisions the
    query-time cascade repeats prune; skip-aliased rows are re-verified)
    or 'approx' (skip-aliases + candidate pruning at the index's
    measured-recall knob). A ``spec.where`` tree compiles through
    engine/algebra.plan_expression into a TreePlan/JoinPlan. Returns the
    ordered PhysicalPlan."""
    if index_mode not in ("exact", "approx"):
        raise ValueError(f"unknown index mode {index_mode!r}")
    if getattr(spec, "where", None) is not None:
        # boolean expression tree / cross-corpus join: compile through
        # the tree algebra (engine/algebra, DESIGN.md §15). The index
        # conditions leaf costing and seeds stores (exact labels only —
        # decided-0 pruning is unsound under OR/NOT, so 'approx'
        # prefiltering does not apply to trees).
        from repro_torch.engine.algebra import plan_expression
        if spec.predicates:
            raise ValueError("QuerySpec.where and QuerySpec.predicates "
                             "are mutually exclusive")
        if index is not None and index_mode != "exact":
            raise ValueError("expression trees support index_mode="
                             "'exact' only (seeding, no pruning)")
        return plan_expression(systems, spec.where, scenario=scenario,
                               max_level=max_level, metadata=metadata,
                               metadata_eq=spec.metadata_eq, index=index)
    if joint and spec.predicates:
        if costing not in ("engine", "paper"):
            raise ValueError(f"unknown costing mode {costing!r}")
        plan = _plan_query_joint(systems, spec, scenario=scenario,
                                 max_level=max_level, metadata=metadata,
                                 costing=costing, max_combos=max_combos,
                                 index=index)
        plan.index, plan.index_mode = index, index_mode
        return plan
    planned = []
    for clause in spec.predicates:
        system = systems[clause.concept]
        space = system.cascade_space(scenario, max_level=max_level)
        sel = select(space, min_accuracy=clause.min_accuracy,
                     min_throughput=clause.min_throughput)
        casc = system.compiled_cascade(space, sel.index,
                                       concept=clause.concept)
        planned.append(PlannedPredicate(
            casc, sel,
            space.describe(sel.index, system.bank.names, system.targets),
            predicate_rank(casc.cost_s, casc.selectivity)))

    order = order_predicates([p.cascade.cost_s for p in planned],
                             [p.cascade.selectivity for p in planned])
    planned = [planned[i] for i in order]
    return PhysicalPlan(scenario, dict(spec.metadata_eq), planned,
                        _meta_selectivity(spec, metadata),
                        index=index, index_mode=index_mode)


def _plan_query_joint(systems: Mapping, spec: QuerySpec, *,
                      scenario: str, max_level: int, metadata,
                      costing: str, max_combos: int,
                      index=None) -> PhysicalPlan:
    """Joint cascade-set selection (DESIGN.md §11.2). Candidate pools =
    per-predicate constrained Pareto frontiers; each candidate carries
    (Selection, DecomposedCost, selectivity). The search prices every
    pool combination at its best order (order_predicates_shared) under
    joint_scan_cost, starting from the independent selection as the
    incumbent and replacing it only on strict improvement — so the
    returned plan NEVER prices worse than the independent plan, and a
    brute-force oracle over (set x order) matches it on small spaces
    (tests/test_joint_planner.py). A clause WITHOUT an explicit
    min_accuracy keeps the independent rule's promise (most accurate
    qualifying cascade): its pool is just the independent pick, and only
    ordering + shared-level pricing remain to optimize for it.

    ``index`` (engine/ingest.CandidateIndex, DESIGN.md §14.5) makes the
    search cost candidates against INDEX-REDUCED cardinality: a
    candidate whose cascade key the index holds decided labels for is
    priced at its undecided-row fraction (DecomposedCost.scaled — rows
    the seeded store answers cost nothing) with its selectivity
    conditioned on the exact-mode prefilter survivors
    (CandidateIndex.planning_stats). Candidates the index never scored
    keep full-corpus pricing, so the never-worse guarantee holds within
    the indexed costing."""
    clauses = spec.predicates
    spaces, pools, ind_pos = [], [], []
    for clause in clauses:
        system = systems[clause.concept]
        space = system.cascade_space(scenario, max_level=max_level)
        ind = select(space, min_accuracy=clause.min_accuracy,
                     min_throughput=clause.min_throughput)
        if clause.min_accuracy is not None:
            cands = select_candidates(space,
                                      min_accuracy=clause.min_accuracy,
                                      min_throughput=clause.min_throughput)
        else:
            # no explicit accuracy floor: the independent rule promises
            # the most accurate (qualifying) cascade — the joint search
            # must not trade that accuracy away for cost, so the pool
            # collapses to the independent pick and only the ORDER and
            # the shared-level pricing remain to optimize
            cands = [ind]
        entries = []
        for s in cands:
            dec = system.decomposed_cost(space, s.index, scenario,
                                         dense_levels=costing == "engine")
            frac = estimate_selectivity(space, s.index, system.eval_scores,
                                        system.p_low, system.p_high)
            if index is not None:
                # price this candidate against the rows the index leaves
                # for it (its cascade key, computed without compiling)
                key = (clause.concept, (int(space.kind[s.index]),
                                        int(space.i1[s.index]),
                                        int(space.i2[s.index])))
                eval_frac, frac = index.planning_stats(key, frac,
                                                       prefilter=True)
                dec = dec.scaled(eval_frac)
            entries.append((s, dec, frac))
        spaces.append(space)
        pools.append(entries)
        ind_pos.append(next(j for j, (s, _, _) in enumerate(entries)
                            if s.index == ind.index))

    pools, ind_pos = _trim_pools(pools, ind_pos, max_combos)
    # dense_reps=False in BOTH costing modes: the engines' lazy
    # first-touch schedule charges each level at the survival fraction
    # of the stage that first touches it (level_schedule); 'engine'
    # costing differs from 'paper' in the per-level execution pricing
    # (dense_levels above), not in the rep-charge weighting
    best_combo, best_order, _ = search_joint(
        [[(dec, frac) for _, dec, frac in entries] for entries in pools],
        tuple(ind_pos), dense_reps=False)

    planned = []
    mat: set = set()
    for pos in best_order:
        clause, system, space = clauses[pos], systems[clauses[pos].concept], \
            spaces[pos]
        sel, dec, frac = pools[pos][best_combo[pos]]
        casc = system.compiled_cascade(space, sel.index,
                                       concept=clause.concept)
        marg = dec.marginal_rep_s(mat)
        shared = tuple(sorted((set(dec.rep_s) & mat) - {FULL_LOAD},
                              reverse=True))
        planned.append(PlannedPredicate(
            casc, sel,
            space.describe(sel.index, system.bank.names, system.targets),
            predicate_rank(dec.infer_s + marg, casc.selectivity),
            decomposed=dec, marginal_rep_s=marg, shared_levels=shared))
        mat |= dec.levels
    return PhysicalPlan(scenario, dict(spec.metadata_eq), planned,
                        _meta_selectivity(spec, metadata), joint=True,
                        costing=costing)


def search_joint(pools, incumbent: tuple, *, dense_reps: bool = False,
                 order_budget: int = 200_000):
    """Exhaustive joint cascade-set search. ``pools``: one list of
    (DecomposedCost, selectivity) candidates per predicate;
    ``incumbent``: the tuple of pool positions holding the independent
    selection. Every pool combination is priced at its best order
    (order_predicates_shared) under joint_scan_cost; the incumbent is
    replaced only on STRICT improvement, so the result never prices
    worse than the independent plan. Returns (combo, order, cost) —
    oracle-tested against a full (set x order) enumeration in
    tests/test_joint_planner.py.

    Cost bound: pricing every combo at its exhaustive best order is
    O(n_combos x k!) Python-loop evaluations — fine for the 2-4
    predicate queries here, minutes at k=6 x max_combos pools. When
    that product exceeds ``order_budget``, combos are ranked with the
    greedy marginal-rank order instead and only the winner (and the
    incumbent) get the exhaustive ordering — the set choice becomes
    heuristic at that scale (the pools are already trimmed anyway) but
    the never-worse guarantee is preserved because the incumbent is
    always priced at its exhaustive best order."""
    import math

    k = len(pools)
    n_combos = 1
    for p in pools:
        n_combos *= len(p)
    exhaustive_orders = n_combos * math.factorial(k) <= order_budget

    def combo_cost(combo, exact):
        decs = [pools[i][j][0] for i, j in enumerate(combo)]
        sels = [pools[i][j][1] for i, j in enumerate(combo)]
        order = order_predicates_shared(
            decs, sels, dense_reps=dense_reps,
            exhaustive_limit=6 if exact else 0)
        return joint_scan_cost(decs, sels, order,
                               dense_reps=dense_reps), order

    best_combo = tuple(incumbent)
    best_cost, best_order = combo_cost(best_combo, True)
    for combo in itertools.product(*[range(len(p)) for p in pools]):
        if combo == tuple(incumbent):
            continue
        cost, order = combo_cost(combo, exhaustive_orders)
        if cost < best_cost * (1.0 - 1e-12):
            best_combo, best_cost, best_order = combo, cost, order
    if not exhaustive_orders and best_combo != tuple(incumbent):
        best_cost, best_order = combo_cost(best_combo, True)
    return best_combo, best_order, best_cost


# ------------------------------------------ online selectivity refinement -
class OnlineReorderer:
    """Mid-scan selectivity refinement (DESIGN.md §11.3; ROADMAP item).

    The planner's selectivity estimates come from the eval split and can
    drift on the queried corpus. The scan engine feeds observed labels
    back per evaluation flush (``observe``) and asks at chunk boundaries
    (``propose``) whether the surviving predicate order is still the
    cheapest under the refined estimates; when a predicate with at least
    ``min_rows`` observations has drifted by more than
    ``drift_threshold``, the order is re-derived — with shared-
    representation pricing when the plan carries decomposed costs, the
    classical rank rule otherwise — and the engine re-orders its stage
    pipeline mid-scan (ScanEngine.scan_rows drains its buffers first).

    Exactness: a proposal only ever permutes WHICH rows are evaluated
    early. Every row's per-cascade label is independent of batch
    composition and evaluation order (full-width levels, DESIGN.md
    §4.2), and a row is accepted iff every cascade labels it 1 — a
    conjunction, which is order-invariant. So mid-scan re-ordering
    cannot change the final row set (differential-tested in
    tests/test_joint_planner.py). Refined estimates are adopted whenever
    a drift check fires, so the same drift never re-triggers; ``propose``
    is O(k!) at most (order_predicates_shared) and only runs on drift.

    Conditional vs marginal selectivity:
    a stage's flushes only ever contain rows that SURVIVED the
    predicates ordered before it, so the observed rate estimates
    P(k | earlier pass), while everything downstream — the rank rule,
    expected_scan_cost, and plan_shards' skew weights via ``refined``
    — needs the marginal P(k). For correlated predicates the two
    differ, and adopting the conditional rate as if marginal can flip
    an ordering the true marginals get right (regression-tested in
    tests/test_ingest.py). The estimator therefore tracks EXPOSURE AT
    FIRST POSITION: the engines flag stage-0 observations
    (``observe(..., marginal=True)``) — stage 0 sees the unfiltered
    row stream, so its positive rate IS the marginal — and only those
    observations refine estimates. Later-stage (conditional)
    observations are accumulated separately for introspection
    (``conditional``) but never drive re-ordering or skew weights;
    predicates that have not yet held first position keep the static
    planner estimate. After a mid-scan re-order a different predicate
    occupies first position and starts accumulating ITS marginal.
    Re-ordering remains EXACT regardless (row sets cannot change) —
    only the cost of the chosen order is at stake.
    """

    def __init__(self, cascades: Sequence[CompiledCascade], *,
                 decomposed: Sequence[DecomposedCost] | None = None,
                 drift_threshold: float = 0.1, min_rows: int = 64,
                 dense_reps: bool = False):
        self.est = {c.key: float(c.selectivity) for c in cascades}
        self.cost = {c.key: float(c.cost_s) for c in cascades}
        self.dec = (dict(zip((c.key for c in cascades), decomposed))
                    if decomposed is not None else None)
        self.dense_reps = dense_reps
        self.drift_threshold = float(drift_threshold)
        # at least one observation: min_rows <= 0 would make observed()
        # trust cascades that never flushed (and KeyError on them)
        self.min_rows = max(1, int(min_rows))
        self.n: dict = {}          # marginal (first-position) exposure
        self.pos: dict = {}
        self.n_cond: dict = {}     # conditional (later-stage) exposure
        self.pos_cond: dict = {}
        self.reorders = 0

    @classmethod
    def from_plan(cls, plan: PhysicalPlan, **kw) -> "OnlineReorderer":
        decs = [p.decomposed for p in plan.predicates]
        # lazy first-touch rep pricing in every costing mode — matches
        # the plan search (see _plan_query_joint) and the engines
        kw.setdefault("dense_reps", False)
        return cls(plan.cascades,
                   decomposed=decs if all(d is not None for d in decs)
                   else None, **kw)

    def observe(self, key: tuple, labels, *, marginal: bool = False) -> None:
        """Fold one evaluation flush's labels into cascade ``key``'s
        observed selectivity. ``marginal=True`` marks a FIRST-POSITION
        flush (stage 0 of the pipeline at flush time — the unfiltered
        stream), the only exposure whose positive rate estimates the
        marginal P(key); anything else is conditional on the earlier
        predicates and is kept out of the refinement estimate."""
        labels = np.asarray(labels)
        if marginal:
            self.n[key] = self.n.get(key, 0) + len(labels)
            self.pos[key] = self.pos.get(key, 0) + int((labels == 1).sum())
        else:
            self.n_cond[key] = self.n_cond.get(key, 0) + len(labels)
            self.pos_cond[key] = (self.pos_cond.get(key, 0)
                                  + int((labels == 1).sum()))

    def observed(self, key: tuple) -> float | None:
        """Marginal selectivity measured at first position, or None
        until ``min_rows`` first-position rows have been seen."""
        n = self.n.get(key, 0)
        return self.pos[key] / n if n >= self.min_rows else None

    def conditional(self, key: tuple) -> float | None:
        """P(key | earlier predicates pass) from later-stage flushes —
        introspection only; never drives re-ordering or skew weights."""
        n = self.n_cond.get(key, 0)
        return self.pos_cond[key] / n if n >= self.min_rows else None

    def refined(self, key: tuple) -> float:
        obs = self.observed(key)
        return self.est[key] if obs is None else obs

    def propose(self, cascades: Sequence[CompiledCascade]) -> list | None:
        """None, or the permutation of ``cascades`` (indices into the
        given order) that is cheaper under refined selectivities."""
        keys = [c.key for c in cascades]
        drifted = any(
            obs is not None and abs(obs - self.est[k]) > self.drift_threshold
            for k in keys for obs in (self.observed(k),))
        if not drifted:
            return None
        sels = [self.refined(k) for k in keys]
        if self.dec is not None and all(k in self.dec for k in keys):
            order = order_predicates_shared([self.dec[k] for k in keys],
                                            sels,
                                            dense_reps=self.dense_reps)
        else:
            order = order_predicates([self.cost[k] for k in keys], sels)
        for k, s in zip(keys, sels):    # adopt: same drift fires once
            self.est[k] = s
        if order == list(range(len(keys))):
            return None
        self.reorders += 1
        return order


def _trim_pools(pools, ind_pos, max_combos: int):
    """Cap the product of pool sizes at ``max_combos`` by keeping each
    pool's cheapest-standalone candidates; the independent pick is
    always retained (the never-worse guarantee needs it enumerable)."""
    total = 1
    for p in pools:
        total *= len(p)
    if total <= max_combos:
        return pools, ind_pos
    cap = max(1, int(max_combos ** (1.0 / len(pools))))
    out_pools, out_ind = [], []
    for pool, ip in zip(pools, ind_pos):
        order = sorted(range(len(pool)), key=lambda j: pool[j][1].total_s)
        keep = order[:cap]
        if ip not in keep:
            keep[-1] = ip
        keep = sorted(set(keep))
        out_pools.append([pool[j] for j in keep])
        out_ind.append(keep.index(ip))
    return out_pools, out_ind
