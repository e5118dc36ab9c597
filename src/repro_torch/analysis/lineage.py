"""Column-level lineage + schema checking (L-rules).

The pass infers each node's *referenced input columns* — from the parsed
``Query`` for SQL nodes, from an AST walk for ``@repro_torch.model`` /
``@repro_torch.expectation`` functions — propagates inferred *output schemas*
topologically from the catalog's table schemas, and flags, before
anything executes:

* ``L001`` a referenced column missing from the (inferred) input schema;
* ``L002`` a GROUP BY key whose dtype the engine cannot group on
  (``engine/exec.py`` requires integer/bool keys — a float key dies with
  a TypeError mid-run);
* ``L003`` an ORDER BY column absent from the node's *output* columns
  (sorting runs after projection/aggregation);
* ``L004`` a referenced table neither produced by the pipeline nor
  present in the catalog at the lint branch.

The rules see JOINs: a multi-table node is checked against the same
*combined relation* the executor builds (every column addressable as
``qualifier.name``, plain when exactly one source owns it — see
``engine/exec._combined_relation``), so qualified references, join-table
columns, ambiguous plain names, and ``SELECT *`` display schemas over
joins all lint exactly as they execute.  L004 covers join tables for
free because ``Query.source_tables()`` feeds the node's parents.

Schema inference is conservative: a Python node's output schema is
unknown (opaque function), and any node whose inputs are unknown
propagates unknown — the pass under-reports instead of guessing.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.astpass import column_references, load_fn_source
from repro_torch.analysis.report import Finding, Severity
from repro_torch.core.pipeline import Node
from repro_torch.engine.expr import Expr
from repro_torch.engine.query import Query
from repro_torch.table.schema import Column, Schema

#: inferred-schema value meaning "statically unknown" (opaque python node)
Unknown = None


def expr_dtype(e: Expr, schema: Schema) -> Optional[np.dtype]:
    """Static dtype of an expression over ``schema`` (None = unknown,
    e.g. a missing column — reported separately as L001)."""
    if e.op == "col":
        return schema.dtype_of(e.args[0]) if schema.has(e.args[0]) else None
    if e.op == "lit":
        v = e.args[0]
        # the engine runs x64-disabled: literals land as 32-bit
        if isinstance(v, bool):
            return np.dtype("bool")
        if isinstance(v, int):
            return np.dtype("int32")
        return np.dtype("float32")
    if e.op in ("lt", "le", "gt", "ge", "eq", "ne", "and", "or", "not"):
        return np.dtype("bool")
    args = [expr_dtype(a, schema) for a in e.args]
    if any(a is None for a in args):
        return None
    if e.op == "div":
        return np.dtype("float32")
    return np.result_type(*args)


def _agg_dtype(fn: str, expr: Optional[Expr], schema: Schema) -> Optional[np.dtype]:
    if fn == "count":
        return np.dtype("int32")
    if fn == "mean":
        return np.dtype("float32")
    inner = expr_dtype(expr, schema) if expr is not None else None
    if inner is None:
        return None
    if fn == "sum":
        return inner if inner.kind == "f" else np.dtype("int32")
    return inner  # min/max keep the input dtype


def combined_input_schema(
    query: Query,
    input_schemas: Dict[str, Optional[Schema]],
) -> Tuple[Optional[Schema], Optional[List[str]]]:
    """The schema-level mirror of ``engine/exec._combined_relation``.

    Returns ``(schema, display)``: the schema the query's expressions
    evaluate against — every column addressable as ``qualifier.name``,
    plus the plain name when exactly one source owns it — and the
    ``SELECT *`` display column list (plain-if-unique, qualified
    otherwise, in source order).  Single-table queries with no alias and
    no dotted references pass through untouched (``display`` = None);
    Unknown propagates if any source table's schema is unknown.
    """
    dotted = any("." in c for c in query.referenced_columns())
    if not query.joins and query.source_alias is None and not dotted:
        return input_schemas.get(query.source, Unknown), None
    sources: List[Tuple[str, Schema]] = []
    for qual, table in query.qualifiers():
        s = input_schemas.get(table, Unknown)
        if s is Unknown:
            return Unknown, None
        sources.append((qual, s))
    owners = Counter(n for _, s in sources for n in s.names)
    cols: List[Column] = []
    display: List[str] = []
    for qual, s in sources:
        for c in s.columns:
            cols.append(Column(f"{qual}.{c.name}", c.dtype))
            if owners[c.name] == 1:
                cols.append(Column(c.name, c.dtype))
                display.append(c.name)
            else:
                display.append(f"{qual}.{c.name}")
    return Schema(tuple(cols)), display


def infer_query_schema(
    query: Query,
    input_schema: Schema,
    display: Optional[List[str]] = None,
) -> Optional[Schema]:
    """Output schema of a SQL node given its (combined) input schema
    (None when any needed dtype cannot be inferred — downstream checks
    then skip).  ``display`` is the SELECT-* column list for multi-source
    queries, as returned by :func:`combined_input_schema`."""
    cols: List[Column] = []
    if query.is_aggregation:
        for k, out in zip(query.group_keys, query.group_key_output_names()):
            if not input_schema.has(k):
                return Unknown
            cols.append(Column(out, str(input_schema.dtype_of(k))))
        for agg in query.aggregates:
            dt = _agg_dtype(agg.fn, agg.expr, input_schema)
            if dt is None:
                return Unknown
            cols.append(Column(agg.name, str(dt)))
        if query.projections:  # post-agg projection re-derives columns
            agg_schema = Schema(tuple(cols))
            cols = []
            for alias, e in query.projections:
                dt = expr_dtype(e, agg_schema)
                if dt is None:
                    return Unknown
                cols.append(Column(alias, str(dt)))
    elif query.projections:
        for alias, e in query.projections:
            dt = expr_dtype(e, input_schema)
            if dt is None:
                return Unknown
            cols.append(Column(alias, str(dt)))
    elif display is not None:  # SELECT * over joins/aliases
        try:
            return input_schema.select(display)
        except KeyError:
            return Unknown
    else:  # SELECT *
        return input_schema
    try:
        return Schema(tuple(cols))
    except TypeError:  # a dtype outside the engine's numeric kinds
        return Unknown


def _sql_fragment(query: Query, token: str) -> Tuple[Optional[str], str]:
    """Locate ``token`` in the node's raw SQL: (position note, fragment)."""
    raw = query.raw_sql
    if not raw:
        return None, ""
    m = re.search(rf"\b{re.escape(token)}\b", raw)
    if not m:
        return None, ""
    start = m.start()
    line = raw.count("\n", 0, start) + 1
    frag = raw[max(0, start - 20):start + len(token) + 20].replace("\n", " ")
    return f"sql line {line}, pos {start}", f"... {frag.strip()} ..."


def check_sql_node(
    node: Node,
    input_schemas: Dict[str, Optional[Schema]],
) -> List[Finding]:
    """L001/L002/L003 for one SQL node against its input schemas.

    ``input_schemas`` maps every table the node reads (FROM + JOINs) to
    its possibly-unknown schema; the checks run over the combined
    relation schema, so qualified references (``t.col``) and join-table
    columns are validated the same way the executor resolves them."""
    findings: List[Finding] = []
    query = node.query
    assert query is not None

    def finding(rule: str, message: str, token: str) -> Finding:
        pos, frag = _sql_fragment(query, token)
        if pos:
            message = f"{message} ({pos})"
        return Finding(
            rule=rule,
            severity=Severity.ERROR,
            message=message,
            node=node.name,
            file=node.source_file,
            line=node.source_line,
            snippet=frag or None,
        )

    input_schema, display = combined_input_schema(query, input_schemas)
    if input_schema is not Unknown:
        known = set(input_schema.names)
        qual_tables = dict(query.qualifiers())
        for c in query.referenced_columns():
            if c in known:
                continue
            if "." in c:
                qual = c.split(".")[0]
                table = qual_tables.get(qual)
                msg = (
                    f"column {c!r} is not in table {table!r}"
                    if table is not None
                    else f"unknown table qualifier {qual!r} in {c!r} "
                    f"(tables: {sorted(qual_tables)})"
                )
            else:
                tables = sorted(set(qual_tables.values()))
                where = (
                    f"table {tables[0]!r}" if len(tables) == 1
                    else f"any of tables {tables}"
                )
                msg = f"column {c!r} is not in {where}"
            findings.append(finding("L001", msg, c))
        for k in query.group_keys:
            if k in known and input_schema.dtype_of(k).kind not in ("i", "u", "b"):
                findings.append(
                    finding(
                        "L002",
                        f"GROUP BY key {k!r} has dtype "
                        f"{input_schema.dtype_of(k)} — the engine groups "
                        "integer/bool keys only (runtime TypeError)",
                        k,
                    )
                )

    # ORDER BY applies to the node's OUTPUT relation
    out_schema = (
        infer_query_schema(query, input_schema, display)
        if input_schema is not Unknown
        else Unknown
    )
    out_cols = query.output_columns() or (
        list(out_schema.names) if out_schema is not Unknown else []
    )
    if out_cols:
        for col_name, _desc in query.order_by:
            # a qualified sort key resolves to its unqualified tail after
            # aggregation/projection, exactly as apply_sort does
            if col_name not in out_cols and col_name.split(".")[-1] not in out_cols:
                findings.append(
                    finding(
                        "L003",
                        f"ORDER BY column {col_name!r} is not among the "
                        f"node's output columns {sorted(out_cols)}",
                        col_name,
                    )
                )
    return findings


def check_python_node(
    node: Node,
    input_schemas: Dict[str, Optional[Schema]],
) -> Tuple[List[Finding], int]:
    """L001 for statically-visible column access in a function body;
    returns ``(findings, suppressed)``."""
    findings: List[Finding] = []
    suppressed = 0
    if node.fn is None:
        return findings, suppressed
    src = load_fn_source(node.fn)
    if src is None:
        return findings, suppressed
    for parent, col_name, at in column_references(src, node.parents):
        schema = input_schemas.get(parent, Unknown)
        if schema is Unknown or schema.has(col_name):
            continue
        line = src.abs_line(at)
        if src.suppressed("L001", line):
            suppressed += 1
            continue
        findings.append(
            Finding(
                rule="L001",
                severity=Severity.ERROR,
                message=(
                    f"column {col_name!r} is not in input {parent!r} "
                    f"(has {sorted(schema.names)})"
                ),
                node=node.name,
                file=src.file,
                line=line,
                snippet=src.snippet(at),
            )
        )
    return findings, suppressed


def propagate_schema(
    node: Node,
    input_schemas: Dict[str, Optional[Schema]],
) -> Optional[Schema]:
    """The node's inferred output schema (Unknown for opaque python
    nodes and for SQL nodes whose input is unknown)."""
    if node.kind != "sql" or node.query is None:
        return Unknown
    src_schema, display = combined_input_schema(node.query, input_schemas)
    if src_schema is Unknown:
        return Unknown
    return infer_query_schema(node.query, src_schema, display)
