"""The shared mark phase: what is *live* in a lake.

One reachability walk serves all three lakekeeper services (GC sweeps
against it, eviction releases roots from it, compaction relies on it to
expire superseded snapshots):

    roots                         edges
    -----                         -----
    branch heads  ─┐
    tags           ├─> commits ──> table manifests ──> shard column blobs
    pinned runs   ─┘
    node-cache entries ──────────> table manifests ──> shard column blobs

Commits, branch heads, tags, pins and cache entries are *refs* (small
mutable pointers); manifests and column blobs are content-addressed
*objects*.  The mark returns both vocabularies: live commit ids (so the
GC can drop expired commit refs) and live object keys (so the sweep can
drop unreachable blobs).

Cache roots are **node-granular**: each live ``NodeCacheEntry`` (and any
not-yet-upgraded legacy stage entry — ``NodeCacheRegistry.entries()``
returns the union of both namespaces) pins the manifest of the one
artifact it caches, so evicting a single node releases exactly that
node's blobs to the next sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

from repro_torch.catalog.nessie import Catalog
from repro_torch.core.snapshot import NodeCacheRegistry, RunRegistry
from repro_torch.io.objectstore import ObjectStore
from repro_torch.table.format import TableFormat


@dataclass(frozen=True)
class LiveSet:
    """The mark result: everything a sweep must keep."""

    #: live commit ids (reachable from branch heads/tags/pins within the
    #: history bound)
    commits: Set[str]
    #: live object keys (manifests + shard column blobs)
    objects: Set[str]
    #: telemetry: how many roots of each kind seeded the walk
    roots: Dict[str, int] = field(default_factory=dict)
    #: snapshot ids of the live manifests — lets the sweep prune
    #: content-fingerprint memo refs whose snapshot has been expired
    snapshot_ids: Set[str] = field(default_factory=set)


def mark(
    store: ObjectStore,
    catalog: Catalog,
    fmt: TableFormat,
    *,
    history: Optional[int] = None,
    pin_ttl_s: Optional[float] = None,
    runlog_ttl_s: Optional[float] = None,
) -> LiveSet:
    """Walk every root to a closed live set.

    ``history`` bounds how many commits deep each branch is retained
    (None = keep everything, ``1`` = heads only — Iceberg-style snapshot
    expiry).  Tagged commits are always roots regardless of depth, so a
    tag protects its data forever.  ``pin_ttl_s`` ages out pins leaked by
    crashed runs (None = honour all pins).  ``runlog_ttl_s`` bounds how
    long a persisted run trace (``runlog`` namespace) keeps its blob
    pinned — refs older than the TTL are *not* roots, so an expired
    trace's blob falls to the same pass's object sweep (None = every
    trace is a root).
    """
    registry = RunRegistry(store)
    cache = NodeCacheRegistry(store)

    pins = registry.pinned_commits(max_age_s=pin_ttl_s)
    commits = catalog.reachable_commits(
        extra_roots=list(pins.values()), history=history
    )

    manifests: Set[str] = set()
    for commit in commits.values():
        manifests.update(commit.tables.values())

    cache_entries = cache.entries()
    for entry in cache_entries.values():
        manifests.update(entry.outputs.values())

    # run traces are roots only within their retention TTL — an expired
    # trace's blob becomes unreachable and is reclaimed by the sweep
    from repro_torch.telemetry.runlog import RunLogStore

    runlog_blobs = RunLogStore(store).live_blobs(ttl_s=runlog_ttl_s)

    objects: Set[str] = set(runlog_blobs.values())
    snapshot_ids: Set[str] = set()
    for key in manifests:
        # tolerate a missing manifest (crashed prior sweep), like
        # snapshot_object_keys does
        if not store.exists(key):
            continue
        snap = fmt.load_snapshot(key)
        snapshot_ids.add(snap.snapshot_id)
        objects.add(key)
        for shard in snap.shards:
            objects.update(shard.column_blobs.values())

    return LiveSet(
        commits=set(commits),
        objects=objects,
        roots={
            "branches": len(catalog.branches()),
            "tags": len(catalog.tags()),
            "pinned_runs": len(pins),
            "cache_entries": len(cache_entries),
            "runlogs": len(runlog_blobs),
        },
        snapshot_ids=snapshot_ids,
    )
