"""Physical planning for the interactive query path.

The part of the JAX package's ``core/physical.py`` that ``Runner.query``
needs: filter pushdown into the FROM table's scan (shard pruning via
min/max stats + residual row filter), the engine route, and per-table
scan plans.  Pipeline planning (fusion into stages, the differential
cache) belongs to the pipeline-run path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.engine.expr import Expr
from repro_torch.engine.query import Query
from repro_torch.engine.route import RouteDecision, column_stats_for_query, plan_route
from repro_torch.table.format import Snapshot
from repro_torch.table.scan import Predicate, ScanPlan, plan_scan


def _split_primary_pushdown(
    query: Query, snapshots: Dict[str, Snapshot]
) -> Tuple[List[Predicate], Optional[Expr]]:
    """Filter conjuncts pushable into the FROM table's scan, plus residual.

    Only predicates provably over the *primary* table are pushed: pushing
    into a joined table could change which duplicate-key row wins the
    first-match gather, and an unqualified column is attributed to the
    primary only when no (known) join table also owns the name.  Pushed
    predicates are re-keyed to the plain column name the shard stats use.
    """
    conjuncts = query.filter_expr._flatten_and()
    primary_qual = query.source_alias or query.source
    psnap = snapshots.get(query.source)
    primary_cols = set(psnap.schema.names) if psnap else set()
    join_cols: set = set()
    unknown_join = False
    for j in query.joins:
        s = snapshots.get(j.table)
        if s is None:
            unknown_join = True  # node-sourced join: columns unknowable here
        else:
            join_cols.update(s.schema.names)

    pushed: List[Predicate] = []
    residual: List[Expr] = []
    for c in conjuncts:
        p = c._as_simple_predicate()
        tail: Optional[str] = None
        if p is not None:
            if "." in p.column:
                qual, t = p.column.split(".", 1)
                if qual == primary_qual and t in primary_cols:
                    tail = t
            elif p.column in primary_cols and (
                not query.joins or (not unknown_join and p.column not in join_cols)
            ):
                tail = p.column
        if tail is not None:
            pushed.append(Predicate(tail, p.op, p.value))
        else:
            residual.append(c)
    res: Optional[Expr] = None
    for r in residual:
        res = r if res is None else Expr("and", (res, r))
    return pushed, res


def _columns_for_table(
    query: Query, table: str, snapshot: Snapshot
) -> Optional[List[str]]:
    """The (plain-named) columns of ``table`` the query touches.

    None means "read everything" — the SELECT * case.  Ambiguous plain
    references load the name from every owning table; the executor's
    combined relation then reports the ambiguity on use."""
    if not (query.projections or query.is_aggregation):
        return None
    names = set(snapshot.schema.names)
    quals = {q for q, t in query.qualifiers() if t == table}
    out: List[str] = []
    for r in query.referenced_columns():
        if "." in r:
            qual, tail = r.split(".", 1)
            if qual in quals and tail in names:
                out.append(tail)
        elif r in names:
            out.append(r)
    # pure COUNT(*): still need one column to carry the row count
    return list(dict.fromkeys(out)) or [snapshot.schema.names[0]]


@dataclass(frozen=True)
class InteractiveQueryPlan:
    """Everything the interactive query path decides before touching data.

    One shared planning artifact behind both ``Runner.query`` (which
    executes it) and ``repro explain`` (which only describes it) — the
    static route verdict agrees with the runtime decision *by
    construction*, because both read this object.
    """

    query: Query
    #: filter conjuncts pushed into the FROM table's scan
    pushed: Tuple[Predicate, ...]
    #: filter remainder evaluated by the engine (None = fully pushed)
    residual: Optional[Expr]
    #: folded shard statistics that grounded the route decision
    stats: Dict[str, Tuple[int, int]]
    total_rows: Optional[int]
    route: "RouteDecision"
    #: per-table scan plans (column projection + shard pruning applied)
    scans: Dict[str, ScanPlan]


def resolve_query_snapshots(
    catalog: Any,
    fmt: Any,
    query: Query,
    *,
    branch: Optional[str] = None,
    commit_id: Optional[str] = None,
    text: Optional[str] = None,
) -> Dict[str, Snapshot]:
    """Zero-registration name resolution: every FROM/JOIN table against
    the catalog, unknown names surfacing as positioned SqlErrors."""
    from repro_torch.catalog.nessie import CatalogError
    from repro_torch.engine.sql import SqlError, find_token

    text = text if text is not None else (query.raw_sql or "")
    snapshots: Dict[str, Snapshot] = {}
    for table in query.source_tables():
        try:
            key = catalog.table_key(table, branch=branch, commit_id=commit_id)
            snapshots[table] = fmt.load_snapshot(key)
        except CatalogError as e:
            raise SqlError(
                f"unknown table {table!r} ({e})", text,
                find_token(text, table) or 0,
            ) from e
    return snapshots


def plan_interactive_query(
    query: Query,
    snapshots: Dict[str, Snapshot],
    *,
    engine: str = "auto",
) -> InteractiveQueryPlan:
    """Plan one interactive query: pushdown split, stats fold, engine
    route, and per-table scan plans.  Pure function of the query and the
    resolved snapshots — no data is read, nothing is written, so the
    explain plane can call it as-is.  Raises :class:`RouteError` when
    ``engine='kernel'`` is forced on an ineligible query, exactly as the
    execution path would."""
    pushed, residual = (
        _split_primary_pushdown(query, snapshots)
        if query.filter_expr is not None
        else ([], None)
    )
    stats, total_rows = column_stats_for_query(query, snapshots)
    route = plan_route(
        query, engine=engine, stats=stats, total_rows=total_rows
    )
    scans = {
        table: plan_scan(
            snapshots[table],
            columns=_columns_for_table(query, table, snapshots[table]),
            predicates=tuple(pushed) if table == query.source else (),
        )
        for table in query.source_tables()
    }
    return InteractiveQueryPlan(
        query=query,
        pushed=tuple(pushed),
        residual=residual,
        stats=stats,
        total_rows=total_rows,
        route=route,
        scans=scans,
    )
