"""Query engine on a torch device: logical->physical planner (joint or
independent cascade selection), boolean expression-tree algebra with
cross-corpus temporal joins, streaming ingest-time indexing, and the
multi-predicate scan executor."""
from repro_torch.engine.algebra import (AlgebraResult, And, Join, JoinPlan,
                                        JoinResult, Not, Or, PlanNode, Pred,
                                        TreePlan, execute_join, execute_tree,
                                        naive_join_pairs, naive_tree_rows,
                                        normalize, order_children,
                                        plan_expression, temporal_hash_join)
from repro_torch.engine.ingest import (CandidateIndex, IngestPipeline,
                                       frame_signature, indexed_execute)
from repro_torch.engine.planner import (OnlineReorderer, PhysicalPlan,
                                        PlannedPredicate, PredicateClause,
                                        QuerySpec, expected_scan_cost,
                                        joint_scan_cost, order_predicates,
                                        order_predicates_shared, plan_query,
                                        predicate_rank, search_joint)
from repro_torch.engine.scan import (CompiledCascade, ScanEngine,
                                     ScanResult, ScanStats,
                                     VirtualColumnStore, level_schedule,
                                     naive_scan, stage_needs)

__all__ = [
    "AlgebraResult", "And", "CandidateIndex", "CompiledCascade",
    "IngestPipeline", "Join", "JoinPlan", "JoinResult", "Not",
    "OnlineReorderer", "Or", "PhysicalPlan", "PlanNode",
    "PlannedPredicate", "Pred", "PredicateClause", "QuerySpec",
    "ScanEngine", "ScanResult", "ScanStats", "TreePlan",
    "VirtualColumnStore", "execute_join", "execute_tree",
    "expected_scan_cost", "frame_signature", "indexed_execute",
    "joint_scan_cost", "level_schedule", "naive_join_pairs", "naive_scan",
    "naive_tree_rows", "normalize", "order_children", "order_predicates",
    "order_predicates_shared", "plan_expression", "plan_query",
    "predicate_rank", "search_joint", "stage_needs", "temporal_hash_join",
]
