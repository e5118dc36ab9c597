"""Columnar query engine in PyTorch — the "duckdb from spare parts" (paper 4.5).

A small analytical engine whose operators are plain torch functions over
fixed-shape columnar batches on one device.  A relation is a `Columnar`
— columns of identical length plus a validity mask.  Filters flip
validity bits instead of shrinking arrays, so every operator is
shape-preserving.  Eligible filter + GROUP BY aggregations run on the
hand-written CUDA kernel in ``repro_torch.kernels.fused_filter_agg``.
"""
from repro_torch.engine.columnar import Columnar
from repro_torch.engine.expr import Expr, col, lit
from repro_torch.engine.query import Agg, Join, Query
from repro_torch.engine.route import RouteDecision, RouteError, plan_route
from repro_torch.engine.exec import execute_query, compile_query
from repro_torch.engine.sql import SqlError, parse_sql

__all__ = [
    "Columnar",
    "Expr",
    "col",
    "lit",
    "Agg",
    "Join",
    "Query",
    "RouteDecision",
    "RouteError",
    "plan_route",
    "execute_query",
    "compile_query",
    "parse_sql",
    "SqlError",
]
