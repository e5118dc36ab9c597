"""Typed dataflow verification over SQL plans (T-rules).

Static dtype inference over the full ``engine/expr.py`` algebra already
exists in :mod:`repro_torch.analysis.lineage` (``expr_dtype`` / ``_agg_dtype``
/ schema propagation).  This module turns that inference into *verdicts*
— the dtype behaviors that today surface as runtime TypeErrors or silent
numeric surprises, flagged before anything executes:

* ``T401`` a JOIN key whose dtype the gather cannot probe —
  ``engine/exec._first_match_gather`` requires integer/bool keys on both
  sides, so a float key dies with a TypeError mid-run;
* ``T402`` JOIN keys of differing integer dtypes — legal, but both sides
  are implicitly widened to int32 in the probe, which is worth seeing;
* ``T403`` an aggregation whose *provable* value bounds cross the 2^24
  f32-exactness boundary (shard stats x row count) — auto routing will
  refuse the fused kernel, and a forced kernel may drift in the last
  ulp;
* ``T404`` a GROUP BY key or aggregated column sourced from a LEFT JOIN
  table — unmatched left rows zero-fill it, so the group domain grows a
  synthetic 0 and sums silently include zero contributions.

Suppression: SQL nodes have no function body, so a
``# repro: noqa[T401]`` on the registration line (the ``p.sql(...)``
call) silences the rule for that node — same bare/[RULE] scoping as the
D rules (:func:`repro_torch.analysis.astpass.line_suppresses`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.astpass import line_suppresses
from repro_torch.analysis.lineage import Unknown, combined_input_schema
from repro_torch.analysis.report import Finding, Severity
from repro_torch.analysis.rules import Rule
from repro_torch.core.pipeline import Node
from repro_torch.engine.query import Query
from repro_torch.engine.route import EXACT_BOUND
from repro_torch.engine.sql import find_token
from repro_torch.table.schema import Schema

TYPE_RULES: Tuple[Rule, ...] = (
    Rule(
        "T401", Severity.ERROR,
        "join-key type incompatibility — the first-match gather probes "
        "integer/bool keys only; a float key is a runtime TypeError",
        "... JOIN zones AS z ON t.score = z.zone_id  -- score is float32",
    ),
    Rule(
        "T402", Severity.INFO,
        "join-key dtype mismatch — both sides are implicitly widened to "
        "int32 in the join probe",
        "... ON t.zone_i8 = z.zone_id  -- int8 vs int32",
    ),
    Rule(
        "T403", Severity.WARNING,
        "aggregate crosses the 2^24 f32-exactness boundary — provable "
        "from shard stats x row count; auto routing refuses the kernel "
        "and a forced kernel may drift in the last ulp",
        "SELECT SUM(big_values) ... over 2^20 rows",
    ),
    Rule(
        "T404", Severity.WARNING,
        "LEFT JOIN zero-fill widening — a grouped/aggregated column from "
        "the left-joined table gains synthetic zeros for unmatched rows",
        "SELECT z.borough, SUM(z.weight) ... LEFT JOIN zones AS z ...",
    ),
)

TYPE_RULES_BY_ID = {r.id: r for r in TYPE_RULES}


def _ref_dtype(schema: Schema, ref: str) -> Optional[np.dtype]:
    return schema.dtype_of(ref) if schema.has(ref) else None


def _sql_loc(query: Query, token: str) -> Tuple[Optional[str], str]:
    """(position note, fragment) for ``token`` in the node's raw SQL."""
    raw = query.raw_sql
    pos = find_token(raw, token)
    if pos is None:
        return None, ""
    line = raw.count("\n", 0, pos) + 1
    frag = raw[max(0, pos - 20):pos + len(token) + 20].replace("\n", " ")
    return f"sql line {line}, pos {pos}", f"... {frag.strip()} ..."


def query_type_findings(
    query: Query,
    input_schemas: Dict[str, Optional[Schema]],
    *,
    stats: Optional[Dict[str, Tuple[int, int]]] = None,
    total_rows: Optional[int] = None,
    node: Optional[str] = None,
    file: Optional[str] = None,
    line: Optional[int] = None,
) -> Tuple[List[Finding], int]:
    """All T-rule findings for one query; ``(findings, suppressed)``.

    ``stats``/``total_rows`` are the same folded shard statistics the
    router sees (``column_stats_for_query``) — when absent (bare lint
    with schemas only, or node-sourced inputs), the stats-grounded T403
    simply cannot fire; the pass under-reports rather than guesses.
    """
    findings: List[Finding] = []
    suppressed = 0

    def emit(rule_id: str, message: str, token: str, hint: str) -> None:
        nonlocal suppressed
        if line_suppresses(file, line, rule_id):
            suppressed += 1
            return
        rule = TYPE_RULES_BY_ID[rule_id]
        pos, frag = _sql_loc(query, token)
        if pos:
            message = f"{message} ({pos})"
        findings.append(
            Finding(
                rule=rule.id,
                severity=rule.severity,
                message=message,
                node=node,
                file=file,
                line=line,
                snippet=frag or None,
                hint=hint,
            )
        )

    schema, _display = combined_input_schema(query, input_schemas)
    if schema is Unknown:
        return findings, suppressed

    # ------------------------------------------------ T401/T402: join keys
    for j in query.joins:
        ldt = _ref_dtype(schema, j.left_on)
        rdt = _ref_dtype(schema, j.right_on)
        if ldt is None or rdt is None:
            continue  # missing columns are L001 territory
        bad = [
            (ref, dt)
            for ref, dt in ((j.left_on, ldt), (j.right_on, rdt))
            if dt.kind not in ("i", "u", "b")
        ]
        if bad:
            ref, dt = bad[0]
            emit(
                "T401",
                f"join key {ref!r} has dtype {dt} — the first-match "
                "gather probes integer/bool keys only (runtime TypeError "
                "in ON "
                f"{j.left_on} = {j.right_on})",
                ref,
                hint=f"cast {ref!r} to int32 upstream (or join on an "
                "integer surrogate key)",
            )
        elif ldt != rdt:
            emit(
                "T402",
                f"join keys {j.left_on!r} ({ldt}) and {j.right_on!r} "
                f"({rdt}) differ — both sides are widened to int32 in "
                "the join probe",
                j.left_on,
                hint="store both keys as int32 to make the comparison "
                "explicit",
            )

    # ------------------------------- T403: 2^24 f32-exactness boundary
    if query.is_aggregation and stats:
        if total_rows is not None and total_rows >= EXACT_BOUND:
            emit(
                "T403",
                f"{total_rows} rows >= 2^24 — f32 counts are no longer "
                "exact integers; auto routing refuses the fused kernel",
                query.source,
                hint="shard the aggregation (pre-aggregate per partition) "
                "or stay on the jnp path",
            )
        for a in query.aggregates:
            if a.fn not in ("sum", "mean") or a.expr is None or a.expr.op != "col":
                continue
            vcol = a.expr.args[0]
            if vcol not in stats or total_rows is None:
                continue
            vmin, vmax = stats[vcol]
            bound = max(abs(vmin), abs(vmax)) * max(total_rows, 1)
            if bound >= EXACT_BOUND:
                emit(
                    "T403",
                    f"aggregate {a.name!r} over {vcol!r}: worst-case sum "
                    f"max(|{vmin}|, |{vmax}|) * {total_rows} rows = "
                    f"{bound} >= 2^24 — exact f32 accumulation is not "
                    "provable; auto routing refuses the fused kernel",
                    vcol,
                    hint=f"narrow {vcol!r}'s value range (or accept the "
                    "jnp path; engine='kernel' would drift in the last ulp)",
                )

    # --------------------------- T404: LEFT JOIN zero-fill widening
    left_joins = [j for j in query.joins if j.how == "left"]
    if left_joins and query.is_aggregation:
        # a plain name is attributed to a left-join table only when that
        # table uniquely owns it — mirroring the combined relation
        owners: Dict[str, List[str]] = {}
        for qual, table in query.qualifiers():
            s = input_schemas.get(table, Unknown)
            if s is Unknown:
                continue
            for n in s.names:
                owners.setdefault(n, []).append(qual)
        left_quals = {j.qualifier: j.table for j in left_joins}

        def from_left(ref: str) -> Optional[str]:
            if "." in ref:
                qual = ref.split(".", 1)[0]
                return left_quals.get(qual)
            own = owners.get(ref, [])
            if len(own) == 1 and own[0] in left_quals:
                return left_quals[own[0]]
            return None

        for k in query.group_keys:
            table = from_left(k)
            if table is not None:
                emit(
                    "T404",
                    f"GROUP BY key {k!r} comes from LEFT JOIN table "
                    f"{table!r} — unmatched rows zero-fill it, widening "
                    "the group domain with a synthetic 0 group",
                    k,
                    hint="use an INNER JOIN to drop unmatched rows, or "
                    "account for the 0 group downstream",
                )
        for a in query.aggregates:
            if a.expr is None or a.expr.op != "col":
                continue
            vcol = a.expr.args[0]
            table = from_left(vcol)
            if table is not None:
                emit(
                    "T404",
                    f"aggregate {a.name!r} reads {vcol!r} from LEFT JOIN "
                    f"table {table!r} — unmatched rows contribute "
                    "zero-filled values to the aggregate",
                    vcol,
                    hint="use an INNER JOIN, or COUNT matches explicitly "
                    "to separate real zeros from fill",
                )
    return findings, suppressed


def check_node_types(
    node: Node,
    input_schemas: Dict[str, Optional[Schema]],
    *,
    stats: Optional[Dict[str, Tuple[int, int]]] = None,
    total_rows: Optional[int] = None,
) -> Tuple[List[Finding], int]:
    """T-rules for one SQL pipeline node (lint entry point)."""
    if node.kind != "sql" or node.query is None:
        return [], 0
    return query_type_findings(
        node.query,
        input_schemas,
        stats=stats,
        total_rows=total_rows,
        node=node.name,
        file=node.source_file,
        line=node.source_line,
    )
