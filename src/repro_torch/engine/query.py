"""Declarative query description — the logical form of one SQL node.

A `Query` is data, not execution: the code-intelligence layer stores it in
the logical plan, extracts pushdown predicates from it, and the executor
compiles it (engine/exec.py).  One Query == one artifact, per the paper's
one-query-one-artifact pattern (4.1).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.engine.expr import Expr, col

_AGG_FNS = {"sum", "count", "mean", "min", "max"}
_JOIN_KINDS = {"inner", "left"}


@dataclass(frozen=True)
class Join:
    """One ``JOIN table [alias] ON left_on = right_on`` clause.

    ``left_on`` refers to a column of the accumulated left side (the FROM
    table plus earlier joins); ``right_on`` to a column of ``table``.
    Either side may be qualified (``t.col``).  The engine compiles joins
    as a shape-stable first-match gather — the right side is expected to
    be key-unique (dimension-table shape); duplicate right keys resolve
    deterministically to the first matching row in storage order.
    """

    table: str
    left_on: str
    right_on: str
    how: str = "inner"
    alias: Optional[str] = None

    def __post_init__(self) -> None:
        if self.how not in _JOIN_KINDS:
            raise ValueError(f"unsupported join kind {self.how!r}")

    @property
    def qualifier(self) -> str:
        return self.alias or self.table

    def to_json_dict(self) -> Dict:
        return {
            "table": self.table,
            "left_on": self.left_on,
            "right_on": self.right_on,
            "how": self.how,
            "alias": self.alias,
        }


@dataclass(frozen=True)
class Agg:
    """One aggregation: ``fn(expr) AS name`` (``count`` ignores expr)."""

    fn: str
    expr: Optional[Expr]
    name: str

    def __post_init__(self) -> None:
        if self.fn not in _AGG_FNS:
            raise ValueError(f"unsupported aggregate {self.fn!r}")

    def to_json_dict(self) -> Dict:
        return {
            "fn": self.fn,
            "expr": self.expr.to_json_dict() if self.expr else None,
            "name": self.name,
        }


@dataclass(frozen=True)
class Query:
    """SELECT projections FROM source WHERE filter
    GROUP BY group_keys ORDER BY order_by LIMIT limit."""

    source: str  # logical table name (a catalog table or a parent node)
    projections: Tuple[Tuple[str, Expr], ...] = ()  # (alias, expr); () = *
    filter_expr: Optional[Expr] = None
    #: additional sources gathered onto the FROM table, in clause order
    joins: Tuple[Join, ...] = ()
    #: SQL alias of the FROM table (qualifies its columns in references)
    source_alias: Optional[str] = None
    group_keys: Tuple[str, ...] = ()
    aggregates: Tuple[Agg, ...] = ()
    order_by: Tuple[Tuple[str, bool], ...] = ()  # (column, descending)
    limit: Optional[int] = None
    #: the SQL text this query was parsed from, when it came from the SQL
    #: front-end — diagnostics only, excluded from equality and from
    #: ``to_json_dict`` so node fingerprints stay formatting-independent
    raw_sql: Optional[str] = field(default=None, compare=False, repr=False)

    # ------------------------------------------------------------- builders
    def select(self, *names: str, **named_exprs: Expr) -> "Query":
        proj = tuple((n, col(n)) for n in names) + tuple(named_exprs.items())
        return replace(self, projections=self.projections + proj)

    def where(self, expr: Expr) -> "Query":
        combined = expr if self.filter_expr is None else Expr("and", (self.filter_expr, expr))
        return replace(self, filter_expr=combined)

    def join(
        self,
        table: str,
        *,
        left_on: str,
        right_on: str,
        how: str = "inner",
        alias: Optional[str] = None,
    ) -> "Query":
        j = Join(table=table, left_on=left_on, right_on=right_on, how=how, alias=alias)
        return replace(self, joins=self.joins + (j,))

    def group_by(self, *keys: str) -> "Query":
        return replace(self, group_keys=self.group_keys + keys)

    def agg(self, fn: str, expr: Optional[Expr], name: str) -> "Query":
        return replace(self, aggregates=self.aggregates + (Agg(fn, expr, name),))

    def count(self, name: str = "counts") -> "Query":
        return self.agg("count", None, name)

    def sort(self, column: str, *, desc: bool = False) -> "Query":
        return replace(self, order_by=self.order_by + ((column, desc),))

    def take(self, n: int) -> "Query":
        return replace(self, limit=n)

    # ------------------------------------------------------------- analysis
    @property
    def is_aggregation(self) -> bool:
        return bool(self.aggregates) or bool(self.group_keys)

    def source_tables(self) -> List[str]:
        """Every logical table this query reads, FROM table first,
        deduplicated in clause order (a self-join appears once)."""
        return list(dict.fromkeys([self.source] + [j.table for j in self.joins]))

    def qualifiers(self) -> List[Tuple[str, str]]:
        """``(qualifier, table)`` per source in clause order; the qualifier
        is the SQL alias when one was given, else the table name."""
        out = [(self.source_alias or self.source, self.source)]
        out.extend((j.qualifier, j.table) for j in self.joins)
        return out

    def referenced_columns(self) -> List[str]:
        cols: List[str] = []
        for _, e in self.projections:
            cols.extend(e.referenced_columns())
        if self.filter_expr is not None:
            cols.extend(self.filter_expr.referenced_columns())
        cols.extend(self.group_keys)
        for a in self.aggregates:
            if a.expr is not None:
                cols.extend(a.expr.referenced_columns())
        for j in self.joins:
            cols.extend([j.left_on, j.right_on])
        return list(dict.fromkeys(cols))

    def group_key_output_names(self) -> List[str]:
        """Output column name per group key: the unqualified tail
        (``t.loc`` groups out as ``loc``), falling back to the full
        qualified name when two keys' tails collide."""
        names: List[str] = []
        seen: set = set()
        for k in self.group_keys:
            tail = k.split(".")[-1]
            out = tail if tail not in seen else k
            names.append(out)
            seen.add(out)
        return names

    def output_columns(self) -> List[str]:
        if self.is_aggregation:
            return self.group_key_output_names() + [a.name for a in self.aggregates]
        if self.projections:
            return [alias for alias, _ in self.projections]
        return []  # "*": depends on input schema

    def to_json_dict(self) -> Dict:
        d = {
            "source": self.source,
            "projections": [(a, e.to_json_dict()) for a, e in self.projections],
            "filter": self.filter_expr.to_json_dict() if self.filter_expr else None,
            "group_keys": list(self.group_keys),
            "aggregates": [a.to_json_dict() for a in self.aggregates],
            "order_by": [list(o) for o in self.order_by],
            "limit": self.limit,
        }
        # joins/alias keys appear only when used so pre-existing node
        # fingerprints (hashes of this dict) are unchanged for the whole
        # single-table query population — cache entries stay warm
        if self.joins:
            d["joins"] = [j.to_json_dict() for j in self.joins]
        if self.source_alias is not None:
            d["source_alias"] = self.source_alias
        return d
