"""Vectorized execution of Query objects over Columnar batches, in torch.

Every operator is shape-stable (masked-row semantics), as in the JAX
package, and runs on the relation's device.  Group-by uses a sort +
segment formulation: stable argsorts group equal key tuples, a cumsum
numbers the segments, and per-segment reductions fill a static-capacity
output.  Joins compile to a shape-stable first-match gather: the right
side is sorted once (valid rows first), probe keys binary-search into
it, and misses either invalidate the row (inner) or zero-fill the
gathered columns (left).

Float group sums are bitwise repeatable from run to run on every device:
they go through ``torch.segment_reduce`` over the sorted, contiguous
segments, which adds each segment's values in order — no float atomics.
Integer sums and counts use ``index_add_``, which is exact in any order.

The CUDA kernel in kernels/fused_filter_agg IS wired in: when the
planner's eligibility pass (engine/route.py) stamps a ``RouteDecision``
with ``engine_path == "kernel"``, the scan→filter→agg pipeline of an
aggregation query runs as one fused kernel pass (filter evaluated
in-kernel for native column-vs-literal predicates, as a mask feed
otherwise) and the grouped output is re-assembled to match the
reference path's layout byte-for-byte.  Queries without a route — or
routed ``"jnp"`` (the JAX package's name for the reference path, kept so
routing decisions compare equal across the two packages) — run the
plain torch operators below, which remain the reference semantics.
"""
from __future__ import annotations

import functools
from collections import Counter
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.engine.columnar import Columnar, dtype_extreme, dtype_kind, dtype_name
from repro_torch.engine.query import Agg, Query
from repro_torch.engine.route import RouteDecision, native_filter_of

_INT32_MAX = torch.iinfo(torch.int32).max


def _zero(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=device)


def _evaluate_as(expr, rel: Columnar, dtype: torch.dtype) -> torch.Tensor:
    """``expr`` over ``rel`` cast to ``dtype``; a scalar result (an
    expression of literals only) broadcasts to every row."""
    out = expr.evaluate(rel.columns)
    if isinstance(out, torch.Tensor):
        return out.to(dtype)
    return torch.full((rel.capacity,), out, device=rel.device).to(dtype)


def apply_filter(rel: Columnar, query: Query) -> Columnar:
    if query.filter_expr is None:
        return rel
    return rel.mask_where(_evaluate_as(query.filter_expr, rel, torch.bool))


def apply_projection(rel: Columnar, query: Query) -> Columnar:
    if not query.projections:
        return rel
    out = {alias: expr.evaluate(rel.columns) for alias, expr in query.projections}
    return Columnar(out, rel.valid)


# --------------------------------------------------------------------- joins
def _combined_relation(
    query: Query, rel: Columnar, joined: Optional[Dict[str, Columnar]]
) -> Tuple[Columnar, Optional[List[str]]]:
    """Gather all join sources onto the FROM relation.

    The combined relation carries every column twice-addressable: under its
    qualified name (``qualifier.col``) always, and under its plain name
    when exactly one source owns that name — so expressions written either
    way evaluate against the same dict with no rewriting.  Returns the
    combined relation plus the *display* column list (plain-if-unique,
    qualified otherwise, in source order) used to resolve ``SELECT *``.

    Single-table queries with no alias and no dotted references pass
    through untouched (display ``None``) — the common path pays nothing.
    """
    dotted = any("." in c for c in query.referenced_columns())
    if not query.joins and query.source_alias is None and not dotted:
        return rel, None

    sources: List[Tuple[str, Columnar]] = [(query.source_alias or query.source, rel)]
    for j in query.joins:
        if not joined or j.table not in joined:
            raise KeyError(
                f"join table {j.table!r} was not provided to execute_query; "
                f"have {sorted(joined or {})}"
            )
        sources.append((j.qualifier, joined[j.table]))

    owners: Counter = Counter()
    for _, srel in sources:
        owners.update(srel.columns.keys())

    q0, rel0 = sources[0]
    combined: Dict[str, torch.Tensor] = {}
    display: List[str] = []
    for n, a in rel0.columns.items():
        combined[f"{q0}.{n}"] = a
        if owners[n] == 1:
            combined[n] = a
        display.append(n if owners[n] == 1 else f"{q0}.{n}")
    valid = rel0.valid

    for j, (jq, jrel) in zip(query.joins, sources[1:]):
        gathered, found = _first_match_gather(j, jq, combined, valid, jrel)
        for n, g in gathered.items():
            combined[f"{jq}.{n}"] = g
            if owners[n] == 1:
                combined[n] = g
            display.append(n if owners[n] == 1 else f"{jq}.{n}")
        if j.how == "inner":
            valid = found
        # left join: validity unchanged, misses were zero-filled

    return Columnar(combined, valid), display


def _first_match_gather(join, jq, combined, valid, jrel):
    """Probe the accumulated left side into one joined relation.

    Right side is sorted by key with invalid rows pushed to the tail
    (double stable argsort), probe keys ``searchsorted`` into it, and
    duplicate right keys resolve deterministically to the first matching
    row in storage order.  Returns (gathered right columns, found mask);
    misses are zero-filled so even non-compact outputs are deterministic.
    """
    def _orient(lref, rref):
        rtail = rref.split(".")[-1]
        rq = rref.split(".")[0] if "." in rref else None
        if rq is not None and rq != jq:
            return None
        if lref in combined and rtail in jrel.columns:
            return combined[lref], jrel.columns[rtail]
        return None

    pair = _orient(join.left_on, join.right_on) or _orient(join.right_on, join.left_on)
    if pair is None:
        raise KeyError(
            f"cannot resolve JOIN {join.table} ON {join.left_on} = "
            f"{join.right_on}: left side has {sorted(combined)}, "
            f"{join.qualifier!r} has {sorted(jrel.columns)}"
        )
    left_keys, right_keys = pair
    for side, arr in (("left", left_keys), ("right", right_keys)):
        if dtype_kind(arr.dtype) not in ("i", "u", "b"):
            raise TypeError(
                f"join key on the {side} side of {join.left_on} = "
                f"{join.right_on} must be integer/bool, got {dtype_name(arr.dtype)} "
                "(fix: cast the join key to int32 upstream — T401 flags "
                "this statically)"
            )

    cap_r = jrel.capacity
    dev = valid.device
    if cap_r == 0:  # statically-empty right side: nothing ever matches
        found = torch.zeros(valid.shape, dtype=torch.bool, device=dev)
        gathered = {
            n: torch.zeros(valid.shape, dtype=a.dtype, device=dev)
            for n, a in jrel.columns.items()
        }
        return gathered, found

    rk32 = right_keys.to(torch.int32)
    perm = torch.argsort(rk32, stable=True)
    perm = perm[torch.argsort((~jrel.valid[perm]).to(torch.int32), stable=True)]
    sorted_valid = jrel.valid[perm]
    # invalid tail carries the max sentinel; a *valid* key equal to the
    # sentinel still wins because searchsorted("left") lands on it first
    sorted_keys = torch.where(
        sorted_valid, rk32[perm], torch.full((), _INT32_MAX, dtype=torch.int32, device=dev)
    )

    lk32 = left_keys.to(torch.int32)
    idx = torch.searchsorted(sorted_keys, lk32, side="left").clamp(max=cap_r - 1)
    found = (sorted_keys[idx] == lk32) & sorted_valid[idx] & valid
    src = perm[idx]
    gathered = {
        n: torch.where(found, a[src], _zero(a.dtype, dev))
        for n, a in jrel.columns.items()
    }
    return gathered, found


def _normalize_group_keys(rel: Columnar, query: Query) -> Tuple[Columnar, Query]:
    """Materialize qualified group keys under their output names.

    ``GROUP BY t.loc`` groups out as column ``loc`` (see
    Query.group_key_output_names); the plain single-table path is
    untouched."""
    out_names = query.group_key_output_names()
    if list(query.group_keys) == out_names:
        return rel, query
    new_cols = {
        out: rel.column(k)
        for k, out in zip(query.group_keys, out_names)
        if out != k
    }
    return rel.with_columns(new_cols), replace(query, group_keys=tuple(out_names))


def _lex_sort_perm(rel: Columnar, keys) -> torch.Tensor:
    """Permutation grouping equal key tuples, valid rows first.

    Lexicographic order via repeated *stable* argsort from least- to
    most-significant key; validity is the most significant key.  Avoids
    packing keys into one word (no range limits).
    """
    perm = torch.arange(rel.capacity, device=rel.device)
    for k in reversed(keys):
        kcol = rel.column(k)
        if dtype_kind(kcol.dtype) not in ("i", "u", "b"):
            raise TypeError(
                f"group key {k!r} must be integer/bool, got {dtype_name(kcol.dtype)}"
            )
        order = torch.argsort(kcol[perm].to(torch.int32), stable=True)
        perm = perm[order]
    order = torch.argsort((~rel.valid[perm]).to(torch.int32), stable=True)
    return perm[order]


def apply_groupby(rel: Columnar, query: Query, *, capacity: Optional[int] = None) -> Columnar:
    """Sort-based grouping with static output capacity.

    Output relation has ``capacity`` rows (default: input capacity); rows
    beyond the number of distinct groups are invalid.
    """
    cap = capacity or rel.capacity
    dev = rel.device
    order = _lex_sort_perm(rel, query.group_keys)
    sorted_valid = rel.valid[order]
    if query.group_keys:
        diff = torch.zeros((rel.capacity,), dtype=torch.bool, device=dev)
        for k in query.group_keys:
            kcol = rel.column(k)[order]
            diff = diff | torch.cat(
                [torch.ones((1,), dtype=torch.bool, device=dev), kcol[1:] != kcol[:-1]]
            )
        is_new = diff & sorted_valid
    else:
        # global aggregation: one group, opened by the first (valid) row
        is_new = sorted_valid & (torch.arange(rel.capacity, device=dev) == 0)
    seg_id = torch.cumsum(is_new.to(torch.int32), 0, dtype=torch.int32) - 1
    seg_id = torch.where(sorted_valid, seg_id, cap)  # route invalid to overflow slot
    # overflow slot is dropped; segments are contiguous and ascending
    seg = seg_id.clamp(max=cap).long()

    out_cols: Dict[str, torch.Tensor] = {}
    # representative group-key columns (every row of a segment agrees)
    for k in query.group_keys:
        src = rel.column(k)[order]
        out = torch.zeros((cap + 1,), dtype=src.dtype, device=dev).index_put_((seg,), src)
        out_cols[k] = out[:cap]

    counts = torch.zeros((cap + 1,), dtype=torch.int32, device=dev).index_add_(
        0, seg, sorted_valid.to(torch.int32)
    )[:cap]

    for agg in query.aggregates:
        out_cols[agg.name] = _apply_one_agg(rel, agg, order, seg, sorted_valid, counts, cap)

    group_valid = counts > 0
    return Columnar(out_cols, group_valid)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-segment sums into ``cap + 1`` slots, ``seg`` ascending.

    Integers add with ``index_add_`` (exact, wrapping like int32 does);
    floats add each segment in row order with ``segment_reduce``, so
    their sums are bitwise the same on every run."""
    if dtype_kind(vals.dtype) != "f":
        return torch.zeros((cap + 1,), dtype=vals.dtype, device=vals.device).index_add_(
            0, seg, vals
        )
    lengths = torch.bincount(seg, minlength=cap + 1)
    return torch.segment_reduce(vals, "sum", lengths=lengths, unsafe=True)


def _apply_one_agg(rel, agg: Agg, order, seg, sorted_valid, counts, cap):
    if agg.fn == "count":
        return counts
    vals = agg.expr.evaluate(rel.columns)[order]
    if agg.fn in ("sum", "mean"):
        # f32 accum for floats, i32 for ints (the JAX package runs x64-off)
        acc_dtype = vals.dtype if dtype_kind(vals.dtype) == "f" else torch.int32
        zeroed = torch.where(sorted_valid, vals.to(acc_dtype), _zero(acc_dtype, vals.device))
        total = _segment_sum(zeroed, seg, cap)[:cap]
        if agg.fn == "sum":
            return total
        return total.to(torch.float32) / counts.clamp(min=1).to(torch.float32)
    if agg.fn in ("min", "max"):
        sign = +1 if agg.fn == "min" else -1
        fill = torch.full((), dtype_extreme(vals.dtype, sign), dtype=vals.dtype, device=vals.device)
        masked = torch.where(sorted_valid, vals, fill)
        out = fill.expand(cap + 1).clone().scatter_reduce_(
            0, seg, masked, reduce="amin" if agg.fn == "min" else "amax"
        )
        return out[:cap]
    raise ValueError(f"unsupported aggregate {agg.fn!r}")


# --------------------------------------------------------------- kernel path
def _kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """The kernel reads int32 and float32 columns as they are (it converts
    to float32 in-register); anything else is cast to float32 first."""
    if x.dtype not in (torch.int32, torch.float32):
        x = x.to(torch.float32)
    return x.contiguous()


def _kernel_filter_agg(rel: Columnar, query: Query, route: RouteDecision) -> Columnar:
    """Filter + group + aggregate through kernels/fused_filter_agg.

    One kernel pass per distinct value column (counts ride along free);
    the grouped output is re-assembled into the reference path's layout —
    present groups first in ascending key order, absent slots zeroed —
    so compacted results are byte-identical to apply_groupby's whenever
    the route's exactness guards hold (integer sums below 2**24).
    """
    from repro_torch.kernels.fused_filter_agg import fused_filter_agg

    dev = rel.device
    key_name = query.group_keys[0]
    out_key = query.group_key_output_names()[0]
    key_col = rel.column(key_name)
    # validity folds into the key stream: invalid rows carry key -1,
    # which matches no group inside the kernel
    keys_slot = torch.where(
        rel.valid, key_col.to(torch.int32) - route.key_offset,
        torch.full((), -1, dtype=torch.int32, device=dev),
    ).contiguous()
    G = route.num_groups

    native = native_filter_of(query.filter_expr) if route.native_filter else None
    if native is not None:
        fcol, op, thr = native
        filt = _kernel_operand(rel.column(fcol))
    elif query.filter_expr is not None:
        # non-native predicate: evaluate to a mask and feed it as the
        # filter column
        filt = _evaluate_as(query.filter_expr, rel, torch.float32)
        op, thr = "ge", 0.5
    else:
        filt, op, thr = torch.ones((rel.capacity,), dtype=torch.float32, device=dev), "ge", 0.0

    value_cols: Dict[str, torch.Tensor] = {}
    for agg in query.aggregates:
        if agg.fn != "count":
            value_cols.setdefault(agg.expr.args[0], rel.column(agg.expr.args[0]))

    sums_by_col: Dict[str, torch.Tensor] = {}
    counts_f = None
    if not value_cols:  # COUNT(*)-only (or bare GROUP BY): one zero-value pass
        _, counts_f = fused_filter_agg(
            keys_slot, torch.zeros((rel.capacity,), dtype=torch.float32, device=dev), filt,
            op=op, threshold=thr, num_groups=G,
        )
    for cname, vals in value_cols.items():
        sums_f, counts_f = fused_filter_agg(
            keys_slot, _kernel_operand(vals), filt,
            op=op, threshold=thr, num_groups=G,
        )
        sums_by_col[cname] = sums_f

    counts_i = counts_f.to(torch.int32)
    present = counts_i > 0
    # reference layout: present groups first, ascending key (slot index ==
    # key - offset, so ascending slot == ascending key)
    order = torch.argsort((~present).to(torch.int32), stable=True)
    present_s = present[order]
    keys_out = (torch.arange(G, dtype=torch.int32, device=dev) + route.key_offset)[order]
    out_cols: Dict[str, torch.Tensor] = {
        out_key: torch.where(
            present_s, keys_out.to(key_col.dtype), _zero(key_col.dtype, dev)
        )
    }
    counts_s = torch.where(present_s, counts_i[order], _zero(torch.int32, dev))
    for agg in query.aggregates:
        if agg.fn == "count":
            out_cols[agg.name] = counts_s
            continue
        sums_s = torch.where(
            present_s, sums_by_col[agg.expr.args[0]][order], _zero(torch.float32, dev)
        )
        if agg.fn == "sum":
            vdtype = rel.column(agg.expr.args[0]).dtype
            out_cols[agg.name] = sums_s.to(
                vdtype if dtype_kind(vdtype) == "f" else torch.int32
            )
        else:  # mean
            out_cols[agg.name] = sums_s / counts_s.clamp(min=1).to(torch.float32)
    return Columnar(out_cols, present_s)


def apply_sort(rel: Columnar, query: Query) -> Columnar:
    if not query.order_by:
        return rel
    # stable multi-key sort: apply keys in reverse significance order,
    # then one final stable pass pushing invalid rows to the end
    perm = torch.arange(rel.capacity, device=rel.device)
    for column, desc in reversed(query.order_by):
        # after aggregation a qualified group key surfaces under its
        # unqualified tail (group_key_output_names) — resolve the same way
        if column not in rel.columns and "." in column:
            tail = column.split(".")[-1]
            if tail in rel.columns:
                column = tail
        vals = rel.column(column)[perm]
        if vals.dtype == torch.bool:
            vals = vals.to(torch.int32)
        order = torch.argsort(-vals if desc else vals, stable=True)
        perm = perm[order]
    order = torch.argsort((~rel.valid[perm]).to(torch.int32), stable=True)
    perm = perm[order]
    return Columnar({k: v[perm] for k, v in rel.columns.items()}, rel.valid[perm])


def apply_limit(rel: Columnar, query: Query) -> Columnar:
    if query.limit is None or query.limit >= rel.capacity:
        return rel
    n = query.limit
    return Columnar({k: v[:n] for k, v in rel.columns.items()}, rel.valid[:n])


def execute_query(
    query: Query,
    rel: Columnar,
    *,
    group_capacity: Optional[int] = None,
    joined: Optional[Dict[str, Columnar]] = None,
    route: Optional[RouteDecision] = None,
) -> Columnar:
    """Interpret a Query over a Columnar. Pure function of its inputs.

    ``joined`` maps each JOIN table name to its relation; ``route`` is an
    optional engine/route.py decision — ``"kernel"`` sends the
    filter+group+agg pipeline through the fused CUDA kernel (its plain
    version for CPU relations), anything else (including no route at all)
    runs the reference torch operators.
    """
    rel, display = _combined_relation(query, rel, joined)
    if route is not None and route.engine_path == "kernel" and query.is_aggregation:
        rel = _kernel_filter_agg(rel, query, route)
        if query.projections:
            rel = apply_projection(rel, query)
    else:
        rel = apply_filter(rel, query)
        if query.is_aggregation:
            grel, gquery = _normalize_group_keys(rel, query)
            rel = apply_groupby(grel, gquery, capacity=group_capacity)
            if query.projections:
                rel = apply_projection(rel, query)
        else:
            if query.projections:
                rel = apply_projection(rel, query)
            elif display is not None:
                rel = rel.select(display)  # SELECT * over joined sources
    rel = apply_sort(rel, query)
    rel = apply_limit(rel, query)
    return rel


@functools.lru_cache(maxsize=512)
def _compiled_for(
    query: Query, group_capacity: Optional[int], route: Optional[RouteDecision]
) -> Callable:
    def call(rel: Columnar, joined: Optional[Dict[str, Columnar]] = None) -> Columnar:
        out = execute_query(
            query, rel, group_capacity=group_capacity, joined=joined or {}, route=route
        )
        # the JAX package's jitted executable hands its columns back in
        # sorted name order (pytree flattening); callers see the same here
        return Columnar({k: out.columns[k] for k in sorted(out.columns)}, out.valid)

    return call


def compile_query(
    query: Query,
    *,
    group_capacity: Optional[int] = None,
    route: Optional[RouteDecision] = None,
) -> Callable[..., Columnar]:
    """Return the executable for a query (cached, so a repeated query gets
    the same callable).  PyTorch runs eagerly, so the executable calls
    :func:`execute_query` directly; no tracing or compilation happens.

    The executable takes ``(rel, joined=None)``; single-table callers keep
    the one-argument form."""
    return _compiled_for(query, group_capacity, route)
