"""The paper's primary contribution: declarative pipelines + code intelligence.

``Pipeline``      — one artifact per node, implicit DAG (paper 4.1, A)
``LogicalPlan``   — typed DAG over catalog artifacts (paper 4.4.1)
``PhysicalPlan``  — fused stages with scan pushdown (paper 4.4.2)
``Runner``        — transform-audit-write over ephemeral branches (4.3),
                    and the interactive query path (``query``)
``RunRegistry``   — snapshotting, fingerprints, replay (4.4.1, 4.6)
``NodeCacheRegistry`` — cross-run differential artifact cache (FaaS &
                    Furious-style, keyed per logical node: clean nodes
                    restore or elide, dirty cones rerun, planner-config
                    changes stay warm)
``plan_interactive_query`` — pushdown split, stats fold, engine route and
                    scan plans of one query, before any data is read
"""
from repro_torch.core.pipeline import Pipeline, Node, PipelineError, requirements
from repro_torch.core.logical import LogicalPlan, build_logical_plan
from repro_torch.core.physical import (
    InteractiveQueryPlan,
    PhysicalPlan,
    Stage,
    ScanSpec,
    PlannerConfig,
    build_physical_plan,
    plan_interactive_query,
    resolve_query_snapshots,
)
from repro_torch.core.runner import Runner, RunResult, ExpectationFailed
from repro_torch.core.snapshot import (
    CacheView,
    NodeCacheEntry,
    NodeCacheRegistry,
    RunRecord,
    RunRegistry,
    StageCacheEntry,
    StageCacheRegistry,
)

__all__ = [
    "CacheView",
    "NodeCacheEntry",
    "NodeCacheRegistry",
    "StageCacheEntry",
    "StageCacheRegistry",
    "Pipeline",
    "Node",
    "PipelineError",
    "requirements",
    "LogicalPlan",
    "build_logical_plan",
    "PhysicalPlan",
    "Stage",
    "ScanSpec",
    "PlannerConfig",
    "build_physical_plan",
    "Runner",
    "RunResult",
    "ExpectationFailed",
    "RunRecord",
    "RunRegistry",
    "InteractiveQueryPlan",
    "plan_interactive_query",
    "resolve_query_snapshots",
]
