"""``repro explain`` — static plan description with the routing verdict.

The explain plane answers "what will this query/pipeline *do*" without
executing anything: planned stages, pushdown and shard pruning, the
kernel-vs-jnp verdict with the full :class:`RouteTrace` of evidence, the
inferred output schema, and the typed-dataflow (T-rule) findings.

Agreement with the runtime is structural, not aspirational:

* interactive SQL — :func:`explain_query` calls the very same
  :func:`repro_torch.core.physical.plan_interactive_query` that
  ``Runner.query`` executes, so the predicted ``engine_path`` (or the
  predicted :class:`RouteError`, byte-for-byte) IS the runtime decision;
* pipelines — :func:`explain_pipeline` routes each SQL node from the
  same ``(query, external snapshots)`` inputs ``build_physical_plan``
  stamps onto ``Stage.sql_routes``, so the two dictionaries compare
  equal (RouteDecision equality excludes the trace).

Nothing in this module reads shard data or writes to any store.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.lineage import (
    Unknown,
    combined_input_schema,
    infer_query_schema,
    propagate_schema,
)
from repro_torch.analysis.report import Finding, LintReport
from repro_torch.analysis.types import query_type_findings
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.physical import plan_interactive_query
from repro_torch.engine.expr import Expr
from repro_torch.engine.query import Query
from repro_torch.engine.route import (
    RouteDecision,
    RouteError,
    RouteTrace,
    column_stats_for_query,
    plan_route,
)
from repro_torch.engine.sql import parse_sql
from repro_torch.table.schema import Schema

_OP_SYMBOLS = {
    "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!=",
    "add": "+", "sub": "-", "mul": "*", "div": "/",
    "and": "AND", "or": "OR",
}


def render_expr(e: Optional[Expr]) -> str:
    """Readable infix form of an expression tree (diagnostics only)."""
    if e is None:
        return ""
    if e.op == "col":
        return str(e.args[0])
    if e.op == "lit":
        return repr(e.args[0])
    if e.op == "not":
        return f"NOT ({render_expr(e.args[0])})"
    if e.op in _OP_SYMBOLS and len(e.args) == 2:
        return (
            f"{render_expr(e.args[0])} {_OP_SYMBOLS[e.op]} "
            f"{render_expr(e.args[1])}"
        )
    return f"{e.op}({', '.join(render_expr(a) for a in e.args)})"


def _schema_pairs(schema: Optional[Schema]) -> Optional[Tuple[Tuple[str, str], ...]]:
    if schema is Unknown:
        return None
    return tuple((c.name, str(c.dtype)) for c in schema.columns)


@dataclass
class ExplainedQuery:
    """One interactive query, fully described and never executed."""

    sql: Optional[str]
    #: engine the caller requested ("auto" | "kernel" | "jnp")
    engine: str
    #: the verdict — "kernel" | "jnp", or None when the prediction is a
    #: RouteError (forced kernel on an ineligible query)
    engine_path: Optional[str]
    route: Optional[RouteDecision] = None
    trace: Optional[RouteTrace] = None
    #: predicted RouteError message — byte-identical to what the runtime
    #: would raise, positioned fragment and fix hint included
    error: Optional[str] = None
    #: filter conjuncts pushed into the FROM table's scan, rendered
    pushdown: Tuple[str, ...] = ()
    #: filter remainder the engine evaluates post-scan, rendered
    residual: Optional[str] = None
    #: table -> {columns, shards, pruned_shards, rows}
    scans: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    output_schema: Optional[Tuple[Tuple[str, str], ...]] = None
    #: typed-dataflow (T-rule) findings for this query
    findings: Tuple[Finding, ...] = ()

    def describe(self) -> str:
        lines: List[str] = []
        if self.sql:
            lines.append(f"explain: {' '.join(self.sql.split())}")
        lines.append(f"  engine requested: {self.engine}")
        lines.append("  plan:")
        for table, s in self.scans.items():
            lines.append(
                f"    scan      {table}: {len(s['columns'])} column(s) "
                f"{s['columns']}, {s['shards']} shard(s) "
                f"({s['pruned_shards']} pruned), {s['rows']} row(s)"
            )
        for p in self.pushdown:
            lines.append(f"    pushdown  {p} (into the scan)")
        if self.residual:
            lines.append(f"    residual  {self.residual}")
        if self.error is not None:
            lines.append(f"    execute   REFUSED — {self.error}")
        elif self.route is not None:
            lines.append(
                f"    execute   {self.route.engine_path} — {self.route.reason}"
            )
        if self.trace is not None and self.trace.checks:
            lines.append("  route trace:")
            lines.extend(
                "    " + line
                for c in self.trace.checks
                for line in c.describe().splitlines()
            )
        if self.output_schema is not None:
            cols = ", ".join(f"{n} {d}" for n, d in self.output_schema)
            lines.append(f"  output schema: {cols}")
        if self.findings:
            lines.append(f"  typed checks: {len(self.findings)} finding(s)")
            for f in self.findings:
                lines.append("    " + f.describe().replace("\n", "\n    "))
        return "\n".join(lines)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "sql": self.sql,
            "engine": self.engine,
            "engine_path": self.engine_path,
            "route": self.route.to_json_dict() if self.route else None,
            "trace": self.trace.to_json_dict() if self.trace else None,
            "error": self.error,
            "pushdown": list(self.pushdown),
            "residual": self.residual,
            "scans": self.scans,
            "output_schema": (
                [list(p) for p in self.output_schema]
                if self.output_schema is not None
                else None
            ),
            "findings": [f.to_json_dict() for f in self.findings],
        }


def explain_query(
    sql_or_query: Any,
    snapshots: Dict[str, Any],
    *,
    engine: str = "auto",
) -> ExplainedQuery:
    """Describe one interactive query exactly as ``Runner.query`` would
    run it.  ``snapshots`` maps every FROM/JOIN table to its Snapshot
    (``repro_torch.core.physical.resolve_query_snapshots`` produces it — with
    the same positioned SqlError for unknown tables the runtime raises).

    A predicted :class:`RouteError` (forced kernel, ineligible query) is
    a *product* here, not an exception: it lands on ``.error`` with the
    trace of the checks that doomed it.
    """
    query: Query = (
        parse_sql(sql_or_query) if isinstance(sql_or_query, str) else sql_or_query
    )
    schemas = {
        t: snap.schema for t, snap in snapshots.items()
    }
    error: Optional[str] = None
    route: Optional[RouteDecision] = None
    trace: Optional[RouteTrace] = None
    pushed: Tuple = ()
    residual = None
    scans: Dict[str, Dict[str, Any]] = {}
    try:
        iq = plan_interactive_query(query, snapshots, engine=engine)
        route, trace = iq.route, iq.route.trace
        pushed, residual = iq.pushed, iq.residual
        scans = {
            t: {
                "columns": list(sp.output_columns),
                "shards": len(sp.shards),
                "pruned_shards": sp.pruned_shards,
                "rows": sp.rows_to_read,
            }
            for t, sp in iq.scans.items()
        }
        stats, total_rows = iq.stats, iq.total_rows
    except RouteError as e:
        error, trace = str(e), e.trace
        stats, total_rows = column_stats_for_query(query, snapshots)

    in_schema, display = combined_input_schema(query, schemas)
    out_schema = (
        infer_query_schema(query, in_schema, display)
        if in_schema is not Unknown
        else Unknown
    )
    findings, _sup = query_type_findings(
        query, schemas, stats=stats, total_rows=total_rows
    )
    return ExplainedQuery(
        sql=query.raw_sql,
        engine=engine,
        engine_path=route.engine_path if route is not None else None,
        route=route,
        trace=trace,
        error=error,
        pushdown=tuple(
            f"{p.column} {p.op} {p.value:g}" for p in pushed
        ),
        residual=render_expr(residual) or None,
        scans=scans,
        output_schema=_schema_pairs(out_schema),
        findings=tuple(findings),
    )


# ===================================================================
# pipeline-level explain
# ===================================================================
@dataclass
class ExplainedNode:
    """One pipeline node's static story: route verdict + schema."""

    name: str
    kind: str
    parents: Tuple[str, ...]
    #: routing verdict for SQL nodes (None for python/expectation nodes
    #: and for nodes whose forced-kernel route is predicted to fail)
    route: Optional[RouteDecision] = None
    trace: Optional[RouteTrace] = None
    error: Optional[str] = None
    output_schema: Optional[Tuple[Tuple[str, str], ...]] = None

    def describe(self) -> str:
        head = f"{self.name} [{self.kind}] <- {list(self.parents)}"
        lines = [head]
        if self.error is not None:
            lines.append(f"  route: REFUSED — {self.error}")
        elif self.route is not None:
            lines.append(
                f"  route: {self.route.engine_path} — {self.route.reason}"
            )
        if self.trace is not None and self.trace.checks:
            lines.extend(
                "    " + line
                for c in self.trace.checks
                for line in c.describe().splitlines()
            )
        if self.output_schema is not None:
            cols = ", ".join(f"{n} {d}" for n, d in self.output_schema)
            lines.append(f"  schema: {cols}")
        return "\n".join(lines)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "kind": self.kind,
            "parents": list(self.parents),
            "engine_path": (
                self.route.engine_path if self.route is not None else None
            ),
            "route": self.route.to_json_dict() if self.route else None,
            "trace": self.trace.to_json_dict() if self.trace else None,
            "error": self.error,
            "output_schema": (
                [list(p) for p in self.output_schema]
                if self.output_schema is not None
                else None
            ),
        }


@dataclass
class PipelineExplanation:
    """The whole pipeline, statically explained, lint report included."""

    pipeline: str
    engine: str
    nodes: List[ExplainedNode]
    report: LintReport

    @property
    def routes(self) -> Dict[str, RouteDecision]:
        """Predicted per-SQL-node routes — directly comparable (dataclass
        equality) with the planner's ``Stage.sql_routes``."""
        return {n.name: n.route for n in self.nodes if n.route is not None}

    def describe(self) -> str:
        lines = [
            f"explain pipeline {self.pipeline!r} (engine={self.engine}): "
            f"{len(self.nodes)} node(s)"
        ]
        for n in self.nodes:
            lines.append("  " + n.describe().replace("\n", "\n  "))
        lines.append(self.report.describe())
        return "\n".join(lines)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "pipeline": self.pipeline,
            "engine": self.engine,
            "nodes": [n.to_json_dict() for n in self.nodes],
            "lint": self.report.to_json_dict(),
        }


def explain_pipeline(
    pipeline: Pipeline,
    *,
    external_schemas: Optional[Dict[str, Optional[Schema]]] = None,
    snapshots: Optional[Dict[str, Any]] = None,
    engine: str = "auto",
    catalog_tables: Optional[set] = None,
) -> PipelineExplanation:
    """Statically explain every node of a pipeline.

    SQL nodes are routed from exactly the inputs the physical planner
    uses — the node's query plus *external* snapshot statistics
    (node-sourced parents carry no stats there either) — so
    ``PipelineExplanation.routes`` equals the union of the planner's
    ``Stage.sql_routes`` for the same engine setting.  The embedded
    :class:`LintReport` runs the full preflight (L/G/D/T/C rules).
    """
    from repro_torch.analysis.lint import _toposort, lint_pipeline

    report = lint_pipeline(
        pipeline,
        external_schemas=external_schemas,
        external_snapshots=snapshots,
        catalog_tables=catalog_tables,
    )
    order, _ = _toposort(pipeline)
    if len(order) != len(pipeline.nodes):  # cyclic — explain what we can
        order += sorted(set(pipeline.nodes) - set(order))
    snapshots = snapshots or {}
    schemas: Dict[str, Optional[Schema]] = dict(external_schemas or {})
    explained: List[ExplainedNode] = []
    for name in order:
        node = pipeline.nodes[name]
        route: Optional[RouteDecision] = None
        trace: Optional[RouteTrace] = None
        error: Optional[str] = None
        if node.kind == "sql" and node.query is not None:
            stats, total_rows = column_stats_for_query(node.query, snapshots)
            try:
                route = plan_route(
                    node.query, engine=engine, stats=stats,
                    total_rows=total_rows,
                )
                trace = route.trace
            except RouteError as e:
                error, trace = str(e), e.trace
        out = propagate_schema(node, schemas)
        schemas[name] = out
        explained.append(
            ExplainedNode(
                name=name,
                kind=node.kind,
                parents=node.parents,
                route=route,
                trace=trace,
                error=error,
                output_schema=_schema_pairs(out),
            )
        )
    return PipelineExplanation(
        pipeline=pipeline.name,
        engine=engine,
        nodes=explained,
        report=report,
    )
