"""Query engine on a torch device: logical->physical planner (joint or
independent cascade selection) + the multi-predicate scan executor."""
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
    "CompiledCascade", "OnlineReorderer", "PhysicalPlan",
    "PlannedPredicate", "PredicateClause", "QuerySpec", "ScanEngine",
    "ScanResult", "ScanStats", "VirtualColumnStore", "expected_scan_cost",
    "joint_scan_cost", "level_schedule", "naive_scan", "order_predicates",
    "order_predicates_shared", "plan_query", "predicate_rank",
    "search_joint", "stage_needs",
]
