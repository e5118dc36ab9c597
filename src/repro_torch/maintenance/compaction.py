"""Small-shard compaction (``repro compact``).

Many small appends (or a runner writing per-stage outputs with a small
``shard_rows``) leave tables fragmented: every scan pays per-shard
overhead (one object GET per column per shard) and per-shard min/max
stats prune less than they could.  Compaction rewrites runs of adjacent
small shards into fewer near-target ones **as a new commit**:

* row order is preserved, so query results are bit-identical;
* per-column min/max stats are recomputed from the merged data, so
  ``Predicate.may_match`` pruning stays exact (``pruning_effectiveness``
  quantifies it before/after on the table's hot predicates);
* the old snapshot stays readable (time travel, replay of pinned runs)
  until ``repro gc --history N`` expires the commit that references it —
  compaction creates garbage, GC collects it, exactly Iceberg's
  rewrite-then-expire split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.catalog.nessie import Catalog
from repro_torch.table.format import TableFormat, plan_compaction_groups
from repro_torch.table.scan import Predicate, pruning_effectiveness
from repro_torch.utils.logging import get_logger

log = get_logger("maintenance.compaction")


@dataclass(frozen=True)
class CompactionReport:
    table: str
    branch: str
    shards_before: int
    shards_after: int
    #: small shards rewritten into merged ones (0 = table already compact)
    shards_merged: int
    #: commit that published the compacted snapshot (None on no-op/dry-run)
    commit_id: Optional[str]
    #: metadata-only pruning fraction on guard predicates, before/after
    pruning_before: Optional[float]
    pruning_after: Optional[float]
    dry_run: bool

    def describe(self) -> str:
        if self.shards_merged == 0:
            return f"compact {self.table}@{self.branch}: already compact"
        verb = "would rewrite" if self.dry_run else "rewrote"
        extra = ""
        if self.pruning_before is not None:
            extra = (
                f"; pruning {self.pruning_before:.0%} -> {self.pruning_after:.0%}"
            )
        return (
            f"compact {self.table}@{self.branch}: {verb} "
            f"{self.shards_merged} small shards, "
            f"{self.shards_before} -> {self.shards_after} shards{extra}"
        )


def _publish_compaction(bus, report: "CompactionReport") -> None:
    if bus is None:
        return
    from repro_torch.telemetry.events import CompactionApplied

    bus.publish(CompactionApplied(
        table=report.table,
        branch=report.branch,
        shards_before=report.shards_before,
        shards_after=report.shards_after,
        shards_merged=report.shards_merged,
        dry_run=report.dry_run,
    ))


def compact_table(
    catalog: Catalog,
    fmt: TableFormat,
    table: str,
    *,
    branch: str = "main",
    target_rows: Optional[int] = None,
    min_fill: float = 0.5,
    guard_predicates: Sequence[Predicate] = (),
    author: str = "lakekeeper",
    dry_run: bool = False,
    bus=None,
) -> CompactionReport:
    """Compact one table at a branch head into a new commit.  ``bus`` (an
    optional EventBus) gets one ``CompactionApplied`` per report."""
    key = catalog.table_key(table, branch=branch)
    snap = fmt.load_snapshot(key)
    target = target_rows or fmt.shard_rows

    if dry_run:
        groups = plan_compaction_groups(
            snap.shards, target_rows=target, min_fill=min_fill
        )
        merged = sum(len(g) for g in groups if len(g) > 1)
        report = CompactionReport(
            table=table,
            branch=branch,
            shards_before=len(snap.shards),
            shards_after=len(groups) if merged else len(snap.shards),
            shards_merged=merged,
            commit_id=None,
            pruning_before=(
                pruning_effectiveness(snap, guard_predicates)
                if guard_predicates else None
            ),
            pruning_after=None,
            dry_run=True,
        )
        log.info("%s", report.describe())
        _publish_compaction(bus, report)
        return report

    new_snap, merged = fmt.compact_snapshot(
        snap, target_rows=target, min_fill=min_fill
    )
    commit_id = None
    pruning_before = pruning_after = None
    if guard_predicates:
        pruning_before = pruning_effectiveness(snap, guard_predicates)
        pruning_after = pruning_effectiveness(new_snap, guard_predicates)
        if pruning_after < pruning_before:
            log.warning(
                "compact %s@%s coarsened pushdown on guard predicates "
                "(%.0f%% -> %.0f%% rows pruned) — consider a smaller "
                "--target-rows for this table",
                table, branch, 100 * pruning_before, 100 * pruning_after,
            )
    if merged:
        # table-level CAS: this rewrite is only valid against the exact
        # version we read — a concurrent run merging new rows must win,
        # raising MergeConflict here (rerun compaction; the orphaned
        # rewritten shards are swept by the next gc)
        commit = catalog.commit(
            branch,
            {table: fmt.manifest_key(new_snap)},
            message=(
                f"compact {table}: {len(snap.shards)} -> "
                f"{len(new_snap.shards)} shards"
            ),
            author=author,
            expect={table: key},
        )
        commit_id = commit.commit_id
        fmt.store.bump_stat("compact_shards_merged", merged)
    report = CompactionReport(
        table=table,
        branch=branch,
        shards_before=len(snap.shards),
        shards_after=len(new_snap.shards),
        shards_merged=merged,
        commit_id=commit_id,
        pruning_before=pruning_before,
        pruning_after=pruning_after,
        dry_run=False,
    )
    log.info("%s", report.describe())
    _publish_compaction(bus, report)
    return report


def compact_branch(
    catalog: Catalog,
    fmt: TableFormat,
    *,
    branch: str = "main",
    target_rows: Optional[int] = None,
    min_fill: float = 0.5,
    author: str = "lakekeeper",
    dry_run: bool = False,
    bus=None,
) -> List[CompactionReport]:
    """Compact every table at a branch head (the cron-job entry point)."""
    return [
        compact_table(
            catalog, fmt, table,
            branch=branch, target_rows=target_rows, min_fill=min_fill,
            author=author, dry_run=dry_run, bus=bus,
        )
        for table in sorted(catalog.tables(branch=branch))
    ]
