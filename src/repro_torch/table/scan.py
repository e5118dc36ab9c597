"""Scan planning: column pruning + predicate pushdown over shard stats.

This is the metadata half of the paper's 4.4.2 optimization: before any
bytes move, the planner uses per-shard min/max statistics to drop shards
that cannot contain matching rows, and reads only referenced columns.
``execute_scan`` then applies the residual predicate row-wise, so downstream
fused stages see an already-small in-memory table.
"""
from __future__ import annotations

import time
from concurrent.futures import Executor
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.table.format import ShardMeta, Snapshot, TableData, TableFormat

_OPS = {"<", "<=", ">", ">=", "==", "!="}

#: default ``chunk_rows`` for kernel-bound scans: 8 of the fused kernel's
#: (8×128)-row tiles per work item — large enough to amortize pool
#: round-trips, small enough that wide fan-outs still parallelize
KERNEL_CHUNK_ROWS = 8192


@dataclass(frozen=True)
class Predicate:
    """A conjunct: ``column <op> literal``."""

    column: str
    op: str
    value: float

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError(f"unsupported predicate op {self.op!r}")

    def to_json_dict(self) -> Dict:
        return {"column": self.column, "op": self.op, "value": self.value}

    # --- shard-level: can this shard possibly contain a matching row? ------
    def may_match(self, stats: Dict[str, Dict[str, float]]) -> bool:
        st = stats.get(self.column)
        if st is None:
            return True
        lo, hi = st["min"], st["max"]
        v = self.value
        if self.op == "<":
            return lo < v
        if self.op == "<=":
            return lo <= v
        if self.op == ">":
            return hi > v
        if self.op == ">=":
            return hi >= v
        if self.op == "==":
            return lo <= v <= hi
        return not (lo == hi == v)  # "!=": only prunable if constant shard

    # --- row-level ----------------------------------------------------------
    def mask(self, col: np.ndarray) -> np.ndarray:
        v = col.dtype.type(self.value) if col.dtype.kind in "iuf" else self.value
        if self.op == "<":
            return col < v
        if self.op == "<=":
            return col <= v
        if self.op == ">":
            return col > v
        if self.op == ">=":
            return col >= v
        if self.op == "==":
            return col == v
        return col != v


@dataclass
class ScanPlan:
    """Output of planning: which shards survive, which columns to read."""

    snapshot: Snapshot
    #: columns to READ — the requested projection plus any predicate-only
    #: columns needed for residual filtering
    columns: List[str]
    predicates: Tuple[Predicate, ...]
    shards: List[ShardMeta]
    pruned_shards: int = 0
    pruned_columns: int = 0
    #: columns to RETURN (the caller's projection); predicate-only columns
    #: are read for filtering but dropped from the result.  ``None`` means
    #: everything read is projected (pre-projection plans deserialize so).
    projection: Optional[List[str]] = None

    @property
    def output_columns(self) -> List[str]:
        return self.columns if self.projection is None else self.projection

    @property
    def rows_to_read(self) -> int:
        return sum(s.num_rows for s in self.shards)


def plan_scan(
    snapshot: Snapshot,
    *,
    columns: Optional[Sequence[str]] = None,
    predicates: Sequence[Predicate] = (),
) -> ScanPlan:
    all_cols = snapshot.schema.names
    needed = list(columns) if columns is not None else list(all_cols)
    # predicate columns must be read even if not projected
    read_cols = list(dict.fromkeys(needed + [p.column for p in predicates]))
    snapshot.schema.select(read_cols)  # validates existence
    keep: List[ShardMeta] = []
    for shard in snapshot.shards:
        if all(p.may_match(shard.column_stats) for p in predicates):
            keep.append(shard)
    return ScanPlan(
        snapshot=snapshot,
        columns=read_cols,
        predicates=tuple(predicates),
        shards=keep,
        pruned_shards=len(snapshot.shards) - len(keep),
        pruned_columns=len(all_cols) - len(read_cols),
        projection=needed,
    )


def pruning_effectiveness(
    snapshot: Snapshot, predicates: Sequence[Predicate]
) -> float:
    """Fraction of *rows* a metadata-only plan proves away for these
    predicates (0.0 = stats prune nothing, 1.0 = everything).

    Compaction (repro.maintenance.compaction) reports this before/after
    for its ``guard_predicates`` and warns when merging shards coarsened
    pruning on the table's hot predicates — fewer, bigger shards
    inherently trade per-shard pruning granularity for scan overhead.
    """
    total = snapshot.num_rows
    if total == 0:
        return 0.0
    plan = plan_scan(snapshot, predicates=predicates)
    return 1.0 - plan.rows_to_read / total


def _chunk_work_items(
    indexed: List[Tuple[int, ShardMeta]], chunk_rows: Optional[int]
) -> List[List[Tuple[int, ShardMeta]]]:
    """Batch (index, shard) pairs into pool work items, order preserved.

    ``chunk_rows`` switches from the default fixed fan-out (≤16 items) to
    greedy row-count batching: consecutive shards pack into one item
    until it carries ~``chunk_rows`` rows.  Shared by the blocking and
    the streaming scan paths so both read the exact same chunks.
    """
    if chunk_rows is not None:
        chunks, cur, cur_rows = [], [], 0
        for item in indexed:
            cur.append(item)
            cur_rows += item[1].num_rows
            if cur_rows >= chunk_rows:
                chunks.append(cur)
                cur, cur_rows = [], 0
        if cur:
            chunks.append(cur)
        return chunks
    # batch shards into at most ~16 work items: many tiny shards would
    # otherwise pay one pool round-trip each and lose to the serial read
    # (ThreadPoolExecutor.map ignores chunksize, so the batching is done
    # by hand; order is preserved either way)
    step = -(-len(indexed) // 16)  # ceil division
    return [indexed[i : i + step] for i in range(0, len(indexed), step)]


#: streaming read-ahead window: chunk reads in flight ahead of the
#: consumer.  Bounds memory to ~window × chunk bytes while still hiding
#: per-shard store latency behind downstream work.
SCAN_PREFETCH_CHUNKS = 4


def execute_scan(
    fmt: TableFormat,
    plan: ScanPlan,
    *,
    pool: Optional[Executor] = None,
    bus=None,
    tags: Optional[Dict] = None,
    chunk_rows: Optional[int] = None,
    streaming: bool = False,
) -> TableData:
    """Read surviving shards, apply the residual row-level predicate.

    Returns only the plan's *projection* — predicate-only columns are read
    for filtering and then dropped.  ``pool`` (any
    ``concurrent.futures.Executor``) parallelizes the per-shard read +
    residual filter; shard order is preserved, so the concatenated result
    is byte-identical to the serial read.

    ``chunk_rows`` switches the work-item batching from the default
    fixed fan-out (≤16 items) to greedy row-count batching: consecutive
    shards pack into one item until it holds ~``chunk_rows`` rows.  The
    interactive query path uses :data:`KERNEL_CHUNK_ROWS` so each item
    feeds the fused kernel a whole number of its (8×128) tiles.

    ``bus`` (a :class:`repro.telemetry.bus.EventBus`) gets one
    ``ScanShardRead`` per shard; ``tags`` attributes the events to a run
    (``run_id``/``stage_id``/``table``/``source``) since the scan pool
    itself has no run context.

    ``streaming=True`` drives the same chunks through the incremental
    shard iterator (:func:`iter_scan`'s machinery): a bounded read-ahead
    window of chunk reads stays in flight while earlier chunks are
    already being consumed, instead of one barrier ``pool.map`` over all
    of them.  Chunking, shard order and the final concatenation are
    identical, so the result is byte-for-byte the same either way.
    """
    parts = [
        part
        for chunk_parts in _iter_chunk_parts(
            fmt, plan, pool=pool, bus=bus, tags=tags,
            chunk_rows=chunk_rows, streaming=streaming,
        )
        for part in chunk_parts
    ]
    out_cols = plan.output_columns
    if not parts:
        return {
            c: np.empty((0,), dtype=plan.snapshot.schema.dtype_of(c))
            for c in out_cols
        }
    return {c: np.concatenate([p[c] for p in parts]) for c in out_cols}


def iter_scan(
    fmt: TableFormat,
    plan: ScanPlan,
    *,
    pool: Optional[Executor] = None,
    bus=None,
    tags: Optional[Dict] = None,
    chunk_rows: Optional[int] = None,
    prefetch: int = SCAN_PREFETCH_CHUNKS,
) -> Iterator[TableData]:
    """Incremental shard-iterator mode: yield the scan chunk by chunk.

    Each yielded ``TableData`` covers one pool work item's shards (same
    chunking as :func:`execute_scan` — concatenating every yielded chunk
    reproduces the blocking scan's arrays byte-for-byte, in shard
    order).  With a ``pool``, up to ``prefetch`` chunk reads run ahead of
    the consumer, so a downstream filter/transform starts on completed
    shards while later shards are still in flight — the streaming half
    of Scheduler v2's scan→filter overlap.
    """
    out_cols = plan.output_columns
    for chunk_parts in _iter_chunk_parts(
        fmt, plan, pool=pool, bus=bus, tags=tags,
        chunk_rows=chunk_rows, streaming=True, prefetch=prefetch,
    ):
        if chunk_parts:
            yield {
                c: np.concatenate([p[c] for p in chunk_parts])
                if len(chunk_parts) > 1
                else chunk_parts[0][c]
                for c in out_cols
            }


def _iter_chunk_parts(
    fmt: TableFormat,
    plan: ScanPlan,
    *,
    pool: Optional[Executor] = None,
    bus=None,
    tags: Optional[Dict] = None,
    chunk_rows: Optional[int] = None,
    streaming: bool = False,
    prefetch: int = SCAN_PREFETCH_CHUNKS,
) -> Iterator[List[TableData]]:
    """Yield per-chunk lists of filtered shard parts, in shard order."""
    if not plan.shards:
        return
    tags = tags or {}

    def read_one(index: int, shard: ShardMeta) -> TableData:
        t0 = time.perf_counter()
        ts = time.time()
        part = fmt.read_shard(shard, plan.columns)
        if plan.predicates:
            mask = np.ones(shard.num_rows, dtype=bool)
            for p in plan.predicates:
                mask &= p.mask(part[p.column])
            if not mask.all():
                part = {c: v[mask] for c, v in part.items()}
        if bus is not None:
            from repro_torch.telemetry.events import ScanShardRead

            rows_out = (
                len(next(iter(part.values()))) if part else shard.num_rows
            )
            bus.publish(ScanShardRead(
                run_id=tags.get("run_id"),
                ts=ts,
                table=tags.get("table", plan.snapshot.table),
                shard_index=index,
                rows_in=shard.num_rows,
                rows_out=rows_out,
                dur_s=time.perf_counter() - t0,
                source=tags.get("source", "stage"),
                stage_id=tags.get("stage_id"),
            ))
        return part

    indexed = list(enumerate(plan.shards))
    if pool is None or len(plan.shards) <= 1:
        for i, shard in indexed:
            yield [read_one(i, shard)]
        return
    chunks = _chunk_work_items(indexed, chunk_rows)

    def read_chunk(chunk: List[Tuple[int, ShardMeta]]) -> List[TableData]:
        return [read_one(i, s) for i, s in chunk]

    if not streaming:
        # barrier path: one pool.map over every chunk (results in order)
        yield from pool.map(read_chunk, chunks)
        return
    # streaming path: keep a bounded window of chunk reads in flight and
    # yield strictly in chunk order — same chunks, same order, the only
    # difference is that the consumer overlaps with later reads
    window = max(1, prefetch)
    futures = [pool.submit(read_chunk, c) for c in chunks[:window]]
    next_submit = window
    for consumed in range(len(chunks)):
        yield futures[consumed].result()
        if next_submit < len(chunks):
            futures.append(pool.submit(read_chunk, chunks[next_submit]))
            next_submit += 1
