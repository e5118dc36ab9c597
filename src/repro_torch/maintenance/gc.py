"""Mark-and-sweep garbage collection (``repro gc``).

Mark (repro_torch.maintenance.reachability) walks branch heads, tags, pinned
in-flight runs and live stage-cache entries down to shard blobs; sweep
deletes everything else — first the unreachable/expired *commit refs*,
then the unreachable *objects* (manifests + column blobs).

Safety levers, in the order a production deployment reaches for them:

* ``dry_run``   — report what would be reclaimed, delete nothing;
* ``grace_s``   — never sweep an object younger than this, so an
  in-flight run's just-written, not-yet-committed stage outputs survive
  a concurrent sweep (defence in depth on top of run pins);
* ``history``   — Iceberg-style snapshot expiry: keep only the last N
  commits per branch (None keeps all history, so a default ``repro gc``
  only reclaims failed/abandoned runs and evicted cache blobs);
* ``pin_ttl_s`` — how long a leaked pin (crashed process) keeps
  protecting its base commit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.catalog.nessie import Catalog
from repro_torch.io.objectstore import ObjectStore
from repro_torch.maintenance.reachability import LiveSet, mark
from repro_torch.table.format import TableFormat
from repro_torch.utils.logging import get_logger

log = get_logger("maintenance.gc")


@dataclass(frozen=True)
class GCReport:
    """What one ``repro gc`` pass saw and did."""

    roots: Dict[str, int]
    live_commits: int
    live_objects: int
    swept_commits: int
    swept_objects: int
    bytes_reclaimed: int
    #: unreachable but younger than the grace period — left for next time
    kept_young: int
    dry_run: bool
    #: content-fingerprint memo refs pruned for expired snapshots
    swept_content_refs: int = 0
    #: speculation latency baselines dropped for long-unused fingerprints
    swept_latency_refs: int = 0
    #: run-trace refs expired past the runlog retention TTL
    swept_runlog_refs: int = 0

    def describe(self) -> str:
        verb = "would reclaim" if self.dry_run else "reclaimed"
        return (
            f"gc: {verb} {self.swept_objects} objects "
            f"({self.bytes_reclaimed} bytes) + {self.swept_commits} commit refs "
            f"+ {self.swept_content_refs} content-hash memos "
            f"+ {self.swept_latency_refs} latency baselines "
            f"+ {self.swept_runlog_refs} run traces; "
            f"live: {self.live_commits} commits / {self.live_objects} objects; "
            f"spared {self.kept_young} in-grace objects; roots: {self.roots}"
        )


def collect_garbage(
    store: ObjectStore,
    catalog: Catalog,
    fmt: TableFormat,
    *,
    history: Optional[int] = None,
    grace_s: float = 0.0,
    pin_ttl_s: Optional[float] = None,
    latency_ttl_s: Optional[float] = 30 * 86400.0,
    runlog_ttl_s: Optional[float] = 14 * 86400.0,
    dry_run: bool = False,
    bus=None,
) -> GCReport:
    """One full mark-and-sweep pass.  Idempotent and crash-safe: every
    delete is a no-op when re-applied, and a half-finished sweep only
    leaves garbage for the next pass, never dangling live data.

    ``runlog_ttl_s`` is the run-trace retention window (``repro gc
    --runlog-ttl``): traces older than it lose their ref here, and their
    blobs — no longer reachability roots — fall to this same pass's
    object sweep.  ``None`` keeps every trace.  ``bus`` (an optional
    :class:`repro_torch.telemetry.bus.EventBus`) gets one ``GcSweep`` event
    summarizing the pass.
    """
    live: LiveSet = mark(
        store, catalog, fmt, history=history, pin_ttl_s=pin_ttl_s,
        runlog_ttl_s=runlog_ttl_s,
    )

    # drop expired run-trace refs BEFORE the object sweep: the mark above
    # already excluded them from the live set, so their blobs reclaim in
    # this very pass (ref sweep + blob sweep, one gc invocation)
    swept_runlogs = 0
    if runlog_ttl_s is not None:
        from repro_torch.telemetry.runlog import RunLogStore

        swept_runlogs = RunLogStore(store).sweep_expired(
            ttl_s=runlog_ttl_s, dry_run=dry_run
        )

    # sweep expired/unreachable commit refs first so a crash between the
    # two phases can't leave a commit whose objects are already gone.
    # The grace period applies here too: a concurrent run writes its
    # commit ref *before* CAS-ing the branch head, so a just-created
    # commit can look unreachable for a moment — deleting it would leave
    # the branch head dangling once the CAS lands.
    now = time.time()
    swept_commits = 0
    for commit_id in catalog.all_commit_ids():
        if commit_id in live.commits:
            continue
        commit = catalog.get_commit_opt(commit_id)
        if commit is not None and now - commit.created_at < grace_s:
            continue
        swept_commits += 1
        if not dry_run:
            catalog.delete_commit(commit_id)

    result = store.sweep(
        live.objects, grace_s=grace_s, dry_run=dry_run
    )

    # content-fingerprint memos for expired snapshots are pure cache —
    # dropping one only costs a recompute on next use, so no grace needed
    swept_content = fmt.prune_content_fingerprints(
        live.snapshot_ids, dry_run=dry_run
    )

    # speculation latency baselines (written by the SDK Client) are keyed
    # by *function* fingerprint — every code edit mints a new one and no
    # catalog walk can prove liveness, so they expire by disuse: a ref not
    # refreshed for latency_ttl_s belongs to code nobody runs anymore.
    # Pure telemetry cache — dropping one costs a re-learned baseline.
    swept_latency = 0
    if latency_ttl_s is not None:
        for name, raw in store.list_refs("latencyhist").items():
            if now - raw.get("updated_at", 0.0) > latency_ttl_s:
                swept_latency += 1
                if not dry_run:
                    store.delete_ref("latencyhist", name)

    report = GCReport(
        roots=live.roots,
        live_commits=len(live.commits),
        live_objects=len(live.objects),
        swept_commits=swept_commits,
        swept_objects=result.swept,
        bytes_reclaimed=result.bytes_reclaimed,
        kept_young=result.kept_young,
        dry_run=dry_run,
        swept_content_refs=swept_content,
        swept_latency_refs=swept_latency,
        swept_runlog_refs=swept_runlogs,
    )
    log.info("%s", report.describe())
    if bus is not None:
        from repro_torch.telemetry.events import GcSweep

        bus.publish(GcSweep(
            swept_objects=report.swept_objects,
            swept_commits=report.swept_commits,
            swept_runlog_refs=report.swept_runlog_refs,
            bytes_reclaimed=report.bytes_reclaimed,
            dry_run=dry_run,
        ))
    return report
