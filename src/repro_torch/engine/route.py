"""Kernel-routing eligibility: which engine executes a query's hot path.

The planner calls :func:`plan_route` per SQL node and stamps the
resulting :class:`RouteDecision` onto the compiled stage.  The decision
is **not** part of node fingerprints — both engines produce byte-identical
artifacts (that is what the eligibility guards prove), so the cache must
stay warm regardless of which path ran.

Routing rules (``engine="auto"``):

* the query is a single-key GROUP BY aggregation whose aggregates are all
  ``count`` / ``sum`` / ``mean`` over plain columns — the shape
  ``kernels/fused_filter_agg`` fuses;
* the group key is integer/bool with *known* min/max statistics (shard
  stats folded over the snapshot) spanning at most ``max_groups``
  distinct values (the default equals the JAX route's; the kernel takes
  any count, a caller who raises it gets the kernel's windowed variant);
* exactness is provable: the kernel accumulates in f32, so every
  aggregated column must be integer/bool with
  ``max(|min|, |max|) * rows < 2**24`` and the row count itself below
  ``2**24`` — then f32 sums/counts are exact integers and casting back
  reproduces the jnp path's int32 scatter-adds bit-for-bit.  Float
  columns always take the jnp path under ``auto``: float addition is
  non-associative and the two paths order it differently.

``engine="kernel"`` forces the kernel for structurally-eligible queries
(skipping the exactness guards — float results may then differ in the
last ulp) and raises when the query shape or missing key statistics make
the kernel impossible.  ``engine="jnp"`` always takes the reference path.

Every eligibility check evaluated is recorded as a :class:`RouteCheck`
on the decision's :class:`RouteTrace` — which passed, which bailed, and
a concrete fix hint for the failure — so ``repro explain`` can show the
kernel-vs-jnp verdict with evidence instead of one opaque reason string.
The trace is excluded from equality/hash: two decisions that route the
same way stay equal (and keep the compiled-query cache warm) regardless
of the evidence trail.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.engine.expr import Expr
from repro_torch.engine.query import Query
from repro_torch.engine.sql import find_token

#: aggregate fns expressible as the kernel's (sums, counts) outputs
FUSED_AGGS = frozenset({"count", "sum", "mean"})

#: largest integer magnitude f32 represents exactly (2**24); sums and
#: counts must stay below this for kernel/jnp byte-identity
EXACT_BOUND = 2 ** 24

#: default cap on the kernel's dense group axis, equal to the JAX route's
#: so both route alike: up to it each of a CUDA block's 8 warps keeps a
#: (sum, count) bin a group in shared memory (64 KB at 1024 groups) and the
#: kernel is one launch; above it, windows of groups and a merge launch
DEFAULT_MAX_GROUPS = 1024

_PRED_TO_KERNEL_OP = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "==": "eq", "!=": "ne"}

#: the R-rule registry — one entry per eligibility check the router can
#: evaluate, id -> (slug, what the check verifies, generic fix hint).
#: ``repro explain`` and the README rule catalog are generated from this
#: table, so the ids in a RouteTrace always resolve to documentation.
ROUTE_CHECKS: Dict[str, Tuple[str, str, str]] = {
    "R200": (
        "engine-pinned",
        "engine was pinned explicitly, no eligibility to evaluate",
        "drop engine='jnp' to let auto routing consider the fused kernel",
    ),
    "R201": (
        "aggregation-shape",
        "query is a GROUP BY aggregation (the shape the fused kernel runs)",
        "only filter+GROUP BY aggregations fuse; plain scans/joins always "
        "run on the jnp path",
    ),
    "R202": (
        "single-group-key",
        "exactly one GROUP BY key (the kernel's dense group axis is 1-D)",
        "group by exactly one key, or split into per-key queries",
    ),
    "R203": (
        "fusable-aggregates",
        "every aggregate is COUNT/SUM/AVG (expressible as the kernel's "
        "sums+counts outputs)",
        "compute MIN/MAX with engine='jnp' (kernel extension pending)",
    ),
    "R204": (
        "plain-column-aggregates",
        "aggregates read plain columns, not computed expressions",
        "materialize the expression as a column in an upstream node, then "
        "aggregate the plain column",
    ),
    "R205": (
        "key-statistics",
        "integer min/max shard statistics exist for the group key",
        "cast the group key to int32 (float keys never route to the "
        "kernel; node-sourced inputs carry no shard statistics)",
    ),
    "R206": (
        "group-range",
        "the key's value range (left-join zero-fill included) fits the "
        "kernel's dense group axis",
        "bucket the key into a denser id space, or raise max_groups "
        "(VMEM permitting)",
    ),
    "R207": (
        "row-count-exactness",
        "row count is known and below 2**24 so f32 counts are exact "
        "(auto only)",
        "force engine='kernel' to skip the proof and accept last-ulp "
        "drift, or keep the jnp path",
    ),
    "R208": (
        "value-exactness",
        "aggregated-column bounds * rows stay below 2**24 so f32 sums "
        "are exact (auto only)",
        "cast the aggregated column to a narrower integer range, or "
        "force engine='kernel' to accept last-ulp drift",
    ),
    "R209": (
        "native-filter",
        "whether the WHERE clause evaluates in-register inside the "
        "kernel or precomputes to a mask input (never bails)",
        "a single col-cmp-literal over an f32-exact column filters "
        "in-register; anything else takes the mask path",
    ),
}


class RouteError(ValueError):
    """``engine="kernel"`` was forced but the kernel cannot run the query.

    Like :class:`repro.engine.sql.SqlError`, the error is positioned:
    when the query carries its raw SQL, ``pos``/``fragment`` quote the
    offending clause (the group key, aggregate, or column that made the
    kernel ineligible), ``hint`` carries the concrete fix, and ``trace``
    the full :class:`RouteTrace` of eligibility checks evaluated.
    """

    def __init__(
        self,
        message: str,
        *,
        sql: Optional[str] = None,
        token: Optional[str] = None,
        hint: Optional[str] = None,
        trace: Optional["RouteTrace"] = None,
    ):
        self.sql = sql
        self.hint = hint
        self.trace = trace
        self.pos: Optional[int] = None
        self.fragment: str = ""
        if sql and token:
            pos = find_token(sql, token)
            if pos is not None:
                self.pos = pos
                lo, hi = max(0, pos - 8), min(len(sql), pos + 16)
                self.fragment = sql[lo:hi].replace("\n", " ")
        if self.pos is not None:
            message = f"{message} at position {self.pos}: ...{self.fragment}..."
        if hint:
            message = f"{message} (fix: {hint})"
        super().__init__(message)


@dataclass(frozen=True)
class RouteCheck:
    """One eligibility check the router evaluated, with its evidence."""

    check: str   # registry id, e.g. "R203"
    name: str    # registry slug, e.g. "fusable-aggregates"
    passed: bool
    detail: str  # the concrete evidence for THIS query
    #: concrete fix for a failed check ("cast zone to int32"); None on pass
    hint: Optional[str] = None
    #: SQL token the evidence points at, for positioned diagnostics
    token: Optional[str] = None

    def describe(self) -> str:
        mark = "pass" if self.passed else "FAIL"
        out = f"[{mark}] {self.check} {self.name}: {self.detail}"
        if self.hint and not self.passed:
            out += f"\n       fix: {self.hint}"
        return out

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "check": self.check,
            "name": self.name,
            "passed": self.passed,
            "detail": self.detail,
            "hint": self.hint,
        }


@dataclass(frozen=True)
class RouteTrace:
    """Every eligibility check evaluated for one routing decision, in
    evaluation order.  The router short-circuits, so the last entry of a
    jnp-routed trace is the check that bailed (``failed``)."""

    checks: Tuple[RouteCheck, ...] = ()

    @property
    def failed(self) -> Optional[RouteCheck]:
        for c in self.checks:
            if not c.passed:
                return c
        return None

    def describe(self) -> str:
        return "\n".join(c.describe() for c in self.checks)

    def to_json_dict(self) -> Dict[str, Any]:
        return {"checks": [c.to_json_dict() for c in self.checks]}


@dataclass(frozen=True)
class RouteDecision:
    """Which engine runs a query's filter+group+agg pipeline, and why.

    Frozen/hashable so it can key the compiled-query cache alongside the
    Query itself.  ``num_groups``/``key_offset`` size the kernel's dense
    group axis (slot = key - offset); ``native_filter`` means the WHERE
    clause is a single ``col <cmp> literal`` the kernel evaluates
    in-register instead of taking a precomputed mask.  ``trace`` carries
    the evidence (every check evaluated) but is excluded from
    equality/hash — routing identity is the semantic fields only."""

    engine_path: str  # "kernel" | "jnp"
    reason: str
    num_groups: int = 0
    key_offset: int = 0
    native_filter: bool = False
    trace: Optional[RouteTrace] = field(default=None, compare=False, repr=False)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "engine_path": self.engine_path,
            "reason": self.reason,
            "num_groups": self.num_groups,
            "key_offset": self.key_offset,
            "native_filter": self.native_filter,
            "trace": self.trace.to_json_dict() if self.trace else None,
        }


def _jnp(reason: str, trace: Optional[RouteTrace] = None) -> RouteDecision:
    return RouteDecision("jnp", reason, trace=trace)


def native_filter_of(expr: Optional[Expr]) -> Optional[Tuple[str, str, float]]:
    """``(column, kernel_op, threshold)`` when the whole filter is one
    ``col <cmp> literal`` conjunct, else None."""
    if expr is None:
        return None
    p = expr._as_simple_predicate()
    if p is None:
        return None
    return p.column, _PRED_TO_KERNEL_OP[p.op], float(p.value)


def column_stats_for_query(
    query: Query, snapshots: Dict[str, object]
) -> Tuple[Dict[str, Tuple[int, int]], Optional[int]]:
    """Fold shard statistics into per-reference (min, max) int bounds.

    ``snapshots`` maps table name -> Snapshot for every lake table the
    query reads (node-sourced inputs simply have no entry — their columns
    get no stats and ``auto`` routing falls back to jnp).  Bounds are
    recorded under both the qualified reference (``qual.col``) and, when
    exactly one source owns the plain name, the plain name — mirroring
    how the executor builds the combined relation.  Only integer/bool
    columns with finite stats are recorded, so a missing entry doubles as
    "not a kernel-safe dtype".  Returns ``(stats, primary_row_count)``;
    the row count is None when the FROM table has no snapshot.
    """
    quals = query.qualifiers()
    owners: Counter = Counter()
    for _, table in quals:
        snap = snapshots.get(table)
        if snap is not None:
            owners.update(snap.schema.names)

    stats: Dict[str, Tuple[int, int]] = {}
    for qual, table in quals:
        snap = snapshots.get(table)
        if snap is None:
            continue
        for col in snap.schema.columns:
            if np.dtype(col.dtype).kind not in ("i", "u", "b"):
                continue
            los = [s.column_stats[col.name]["min"] for s in snap.shards
                   if col.name in s.column_stats]
            his = [s.column_stats[col.name]["max"] for s in snap.shards
                   if col.name in s.column_stats]
            if not los or any(not np.isfinite(v) for v in los + his):
                continue
            bound = (int(min(los)), int(max(his)))
            stats[f"{qual}.{col.name}"] = bound
            if owners[col.name] == 1:
                stats[col.name] = bound
    primary = snapshots.get(query.source)
    return stats, (primary.num_rows if primary is not None else None)


def plan_route(
    query: Query,
    *,
    engine: str = "auto",
    stats: Optional[Dict[str, Tuple[int, int]]] = None,
    total_rows: Optional[int] = None,
    max_groups: int = DEFAULT_MAX_GROUPS,
) -> RouteDecision:
    """Decide the engine for one query (see module docstring for rules)."""
    if engine not in ("auto", "kernel", "jnp"):
        raise ValueError(f"unknown engine {engine!r}; use auto|kernel|jnp")

    checks: List[RouteCheck] = []

    def record(
        cid: str,
        passed: bool,
        detail: str,
        hint: Optional[str] = None,
        token: Optional[str] = None,
    ) -> bool:
        name = ROUTE_CHECKS[cid][0]
        if not passed and hint is None:
            hint = ROUTE_CHECKS[cid][2]
        checks.append(RouteCheck(cid, name, passed, detail, hint, token))
        return passed

    if engine == "jnp":
        record("R200", True, "engine='jnp' requested — reference path pinned")
        return _jnp("engine=jnp requested", RouteTrace(tuple(checks)))
    forced = engine == "kernel"
    stats = stats or {}

    def bail(reason: str) -> RouteDecision:
        last = checks[-1]
        trace = RouteTrace(tuple(checks))
        if forced:
            raise RouteError(
                f"engine='kernel' forced but {reason}",
                sql=query.raw_sql,
                token=last.token,
                hint=last.hint,
                trace=trace,
            )
        return _jnp(reason, trace)

    # ---------------------------------------------------------- structure
    if not record(
        "R201", query.is_aggregation,
        "query is a GROUP BY aggregation" if query.is_aggregation
        else "query has no aggregation — nothing for the kernel to fuse",
    ):
        return bail("not an aggregation")
    nkeys = len(query.group_keys)
    if not record(
        "R202", nkeys == 1,
        f"{nkeys} group key(s): {list(query.group_keys)}",
        token=query.group_keys[-1] if query.group_keys else None,
    ):
        return bail(f"kernel supports exactly one group key, got {nkeys}")
    for a in query.aggregates:
        if not record(
            "R203", a.fn in FUSED_AGGS,
            f"aggregate {a.name!r} uses fn {a.fn!r}",
            hint=None if a.fn in FUSED_AGGS else (
                f"only COUNT/SUM/AVG fuse; compute {a.fn!r} with "
                "engine='jnp' (kernel extension pending)"
            ),
            token=a.name,
        ):
            return bail(f"aggregate {a.fn!r} is not kernel-fusable")
        plain = a.fn == "count" or (a.expr is not None and a.expr.op == "col")
        if not record(
            "R204", plain,
            f"aggregate {a.name!r} reads "
            + ("a plain column" if plain else "a computed expression"),
            token=a.name,
        ):
            return bail(f"aggregate {a.name!r} is over a computed expression")

    # ------------------------------------------------------- key geometry
    key = query.group_keys[0]
    if not record(
        "R205", key in stats,
        f"group key {key!r}: "
        + (f"stats {stats[key]}" if key in stats
           else "no integer shard statistics"),
        hint=None if key in stats else (
            f"cast {key!r} to int32 so shard statistics cover it (float "
            "keys and node-sourced inputs never carry integer stats)"
        ),
        token=key,
    ):
        return bail(f"no integer statistics for group key {key!r}")
    kmin, kmax = stats[key]
    # a left join zero-fills unmatched right-side rows, so a group key
    # that may come from a left-joined table must admit slot value 0
    # (an unqualified key's owner is unknown here — extend conservatively)
    widened = False
    left_quals = {j.qualifier for j in query.joins if j.how == "left"}
    if left_quals:
        owner = key.split(".")[0] if "." in key else None
        if owner is None or owner in left_quals:
            widened = (kmin, kmax) != (min(kmin, 0), max(kmax, 0))
            kmin, kmax = min(kmin, 0), max(kmax, 0)
    num_groups = kmax - kmin + 1
    if not record(
        "R206", num_groups <= max_groups,
        f"key range [{kmin}, {kmax}] -> {num_groups} groups "
        f"(max_groups={max_groups})"
        + (" — widened to include 0 for LEFT JOIN zero-fill" if widened else ""),
        hint=None if num_groups <= max_groups else (
            f"bucket {key!r} into a denser id space, or raise max_groups "
            "(VMEM permitting)"
        ),
        token=key,
    ):
        return bail(
            f"group key range {num_groups} exceeds max_groups={max_groups}"
        )

    # ------------------------------------------------- exactness (auto)
    if not forced:
        known = total_rows is not None
        if not record(
            "R207", known and total_rows < EXACT_BOUND,
            "row count unknown (no snapshot for the FROM table)" if not known
            else f"{total_rows} rows vs exact-f32 bound {EXACT_BOUND}",
        ):
            return bail(
                "row count unknown; f32 count exactness not provable"
                if not known
                else f"{total_rows} rows overflow exact f32 counts"
            )
        for a in query.aggregates:
            if a.fn == "count":
                continue
            vcol = a.expr.args[0]
            if not record(
                "R208", vcol in stats,
                f"aggregated column {vcol!r}: "
                + (f"stats {stats[vcol]}" if vcol in stats
                   else "no integer shard statistics (float or node-sourced)"),
                hint=None if vcol in stats else (
                    f"cast {vcol!r} to int32, or force engine='kernel' to "
                    "skip the exactness proof and accept last-ulp drift"
                ),
                token=vcol,
            ):
                return bail(f"no integer statistics for aggregated column {vcol!r}")
            vmin, vmax = stats[vcol]
            bound = max(abs(vmin), abs(vmax)) * max(total_rows, 1)
            if not record(
                "R208", bound < EXACT_BOUND,
                f"sum bound for {vcol!r}: max(|{vmin}|, |{vmax}|) * "
                f"{total_rows} rows = {bound} vs {EXACT_BOUND}",
                token=vcol,
            ):
                return bail(
                    f"sum bound for {vcol!r} overflows exact f32 accumulation"
                )

    # -------------------------------------------------------- the filter
    native = False
    nf = native_filter_of(query.filter_expr)
    if query.filter_expr is None:
        record("R209", True, "no WHERE clause — nothing to filter")
    elif nf is None:
        record(
            "R209", True,
            "WHERE is not a single col-cmp-literal — precomputed mask input",
        )
    else:
        fcol, _, _ = nf
        b = stats.get(fcol)
        # the kernel compares the filter column in f32; only use the
        # native path when the column provably fits f32 exactly
        native = b is not None and max(abs(b[0]), abs(b[1])) < EXACT_BOUND
        record(
            "R209", True,
            f"WHERE is a single comparison on {fcol!r} — "
            + ("evaluated in-register (f32-exact bounds "
               f"{b})" if native else
               "mask input (column bounds not provably f32-exact)"),
        )

    return RouteDecision(
        engine_path="kernel",
        reason="forced by engine='kernel'" if forced else (
            f"single-key agg, {num_groups} groups, exact f32 bounds hold"
        ),
        num_groups=num_groups,
        key_offset=kmin,
        native_filter=native,
        trace=RouteTrace(tuple(checks)),
    )
