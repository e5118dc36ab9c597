"""The interactive query path: planning and the query runner.

``Runner``                — ``query()``: catalog → snapshot → scan with
                            pushdown → device → route → kernel or
                            reference operators → host result
``plan_interactive_query`` — pushdown split, stats fold, engine route and
                            scan plans, before any data is read
"""
from repro_torch.core.physical import (
    InteractiveQueryPlan,
    plan_interactive_query,
    resolve_query_snapshots,
)
from repro_torch.core.runner import Runner

__all__ = [
    "InteractiveQueryPlan",
    "Runner",
    "plan_interactive_query",
    "resolve_query_snapshots",
]
