"""Run snapshotting + replay (paper 4.4.1, 4.6) and the differential cache.

Every run is assigned an id and an immutable record: pipeline fingerprint,
base data commit, parameters, produced artifact keys, and execution stats.
"The same code on the same data version will produce identical results" —
``Runner.replay`` re-executes a recorded run against its pinned commit and
the tests assert snapshot-id equality (bit-for-bit reproducibility).

That same determinism, read forward, is a performance win (the follow-up
paper's differential caching): if a *logical node's* transitive
fingerprint — node code + upstream node fingerprints + input table
content hashes + params — matches a previous successful run, its output
can be restored from the object store instead of recomputed.  The cache
is keyed at **node** granularity, independent of how the physical
planner happened to fuse nodes into stages, so a planner-config change
(fusion toggled, ``max_stage_nodes`` tweaked) never invalidates the
cache.  ``NodeCacheRegistry`` is the fingerprint → entry index; entries
are written only after a run's audit passes, so a failed expectation can
never leave poisoned cache entries behind.  Entries written by the old
stage-keyed scheme are kept readable in their own namespace and
upgraded one-way to node entries the first time a plan matches them
(``CacheView.adopt_legacy``), so pre-migration lakes don't cold-start.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.io.objectstore import ObjectStore

_RUN_NS = "runs"
_COUNTER = "run_counter"
#: legacy stage-keyed entries — read-only except for the one-way
#: upgrade; new entries always land in the node namespace
_LEGACY_CACHE_NS = "stagecache"
_CACHE_NS = "nodecache"
#: in-flight run pins — GC roots protecting a running run's base commit
#: (see repro.maintenance.reachability)
_PIN_NS = "pins"


@dataclass(frozen=True)
class RunRecord:
    run_id: int
    pipeline_name: str
    pipeline_fingerprint: str
    branch: str
    base_commit: str
    params: Dict[str, Any]
    #: artifact name -> snapshot manifest key
    artifacts: Dict[str, str]
    checks: Dict[str, bool]
    merged_commit: Optional[str]
    fused: bool
    stats: Dict[str, Any]
    created_at: float
    #: transitive *node* fingerprint -> artifact manifest keys persisted to
    #: the differential cache by this run (empty for cache-off / failed
    #: runs; check entries appear with an empty mapping).  Named
    #: ``stage_cache`` for on-disk compatibility with pre-node records.
    stage_cache: Dict[str, Dict[str, str]] = field(default_factory=dict)

    def to_json_dict(self) -> Dict:
        return {
            "run_id": self.run_id,
            "pipeline_name": self.pipeline_name,
            "pipeline_fingerprint": self.pipeline_fingerprint,
            "branch": self.branch,
            "base_commit": self.base_commit,
            "params": self.params,
            "artifacts": self.artifacts,
            "checks": self.checks,
            "merged_commit": self.merged_commit,
            "fused": self.fused,
            "stats": self.stats,
            "created_at": self.created_at,
            "stage_cache": self.stage_cache,
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "RunRecord":
        return RunRecord(**d)


@dataclass
class RunRegistry:
    """The Postgres-of-spare-parts: run records as refs in the store."""

    store: ObjectStore

    def next_run_id(self) -> int:
        for _ in range(1000):
            cur = self.store.get_ref(_RUN_NS, _COUNTER)  # None on first run
            val = (cur or {"value": 0})["value"] + 1
            if self.store.compare_and_set_ref(_RUN_NS, _COUNTER, cur, {"value": val}):
                return val
        raise RuntimeError("run-id contention")

    def record(self, rec: RunRecord) -> None:
        self.store.set_ref(_RUN_NS, f"run_{rec.run_id}", rec.to_json_dict())

    def get(self, run_id: int) -> RunRecord:
        raw = self.store.get_ref(_RUN_NS, f"run_{run_id}")
        if raw is None:
            raise KeyError(f"no run record for id {run_id}")
        return RunRecord.from_json_dict(raw)

    def all_runs(self) -> List[RunRecord]:
        out = []
        for name, raw in self.store.list_refs(_RUN_NS).items():
            if name.startswith("run_"):
                out.append(RunRecord.from_json_dict(raw))
        return sorted(out, key=lambda r: r.run_id)

    # -------------------------------------------------------------- pinning
    # An executing run holds a pin on its base commit so a concurrent
    # ``repro gc`` cannot expire the data version it is reading.  Pins are
    # dropped in the runner's ``finally``; a pin leaked by a crashed
    # process ages out via the GC's ``pin_ttl_s``.

    def pin_run(self, run_id: int, base_commit: str) -> None:
        self.store.set_ref(
            _PIN_NS, f"run_{run_id}",
            {"base_commit": base_commit, "created_at": time.time()},
        )

    def unpin_run(self, run_id: int) -> None:
        self.store.delete_ref(_PIN_NS, f"run_{run_id}")

    def pinned_commits(self, *, max_age_s: Optional[float] = None) -> Dict[int, str]:
        """Live pins: run_id -> base commit.  Pins older than
        ``max_age_s`` are treated as leaked and ignored."""
        now = time.time()
        out: Dict[int, str] = {}
        for name, raw in self.store.list_refs(_PIN_NS).items():
            if not name.startswith("run_"):
                continue
            if max_age_s is not None and now - raw.get("created_at", 0.0) > max_age_s:
                continue
            out[int(name[len("run_"):])] = raw["base_commit"]
        return out


@dataclass(frozen=True)
class NodeCacheEntry:
    """Everything needed to substitute one cached logical node for execution.

    An **artifact** node's entry maps its name -> snapshot manifest key in
    ``outputs`` (a single-key dict); an **expectation** node's entry records
    its audited verdict in ``checks`` instead.  The blobs behind a manifest
    key are content-addressed, so the key stays dereferenceable until the
    lakekeeper (repro.maintenance) evicts the entry and a GC sweep reclaims
    any blobs no longer reachable from another root.  Since entries are
    only persisted after a fully-audited run, every recorded verdict is
    True — audit can be skipped for cache-restored nodes.  ``output_bytes``
    (size) and ``last_used_at`` (recency) are the metadata the eviction
    policy (LRU within a byte budget, optional TTL) ranks entries by.

    Legacy stage-keyed entries deserialize into the same shape
    (multi-name ``outputs``/``checks``, empty ``node``) and are upgraded
    one-way to node entries by ``CacheView.adopt_legacy``.
    """

    fingerprint: str
    outputs: Dict[str, str]
    checks: Dict[str, bool]
    #: decompressed bytes the cached outputs represent (what a recompute
    #: would have re-written) — feeds StoreStats.cache_bytes_saved and
    #: counts against the eviction policy's byte budget
    output_bytes: int
    run_id: int
    created_at: float
    #: bumped on every cache hit (LRU clock); equals created_at until the
    #: entry is first restored
    last_used_at: float = 0.0
    #: logical node name this entry caches ("" for legacy stage entries)
    node: str = ""

    def __post_init__(self) -> None:
        if self.last_used_at == 0.0:
            object.__setattr__(self, "last_used_at", self.created_at)

    @property
    def kind(self) -> str:
        if not self.node:
            return "stage"  # legacy, pre-node-granularity
        return "check" if self.checks else "artifact"

    def to_json_dict(self) -> Dict:
        return {
            "fingerprint": self.fingerprint,
            "outputs": self.outputs,
            "checks": self.checks,
            "output_bytes": self.output_bytes,
            "run_id": self.run_id,
            "created_at": self.created_at,
            "last_used_at": self.last_used_at,
            "node": self.node,
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "NodeCacheEntry":
        return NodeCacheEntry(**d)


#: historical name — external callers and old records still use it
StageCacheEntry = NodeCacheEntry


@dataclass
class NodeCacheRegistry:
    """Differential-cache index: transitive node fingerprint -> entry.

    Entries live in the same ref namespace machinery as branches and run
    records, so the cache shares the store's durability and atomic-swap
    semantics without any new storage layer.  Two namespaces back the
    registry: ``nodecache`` (current, node-keyed) and ``stagecache``
    (legacy stage-keyed entries, kept readable so old lakes warm up
    instead of cold-starting).  Reads/evictions see the union; writes go
    to the node namespace only.
    """

    store: ObjectStore

    def get(self, fingerprint: str) -> Optional[NodeCacheEntry]:
        raw = self.store.get_ref(_CACHE_NS, fingerprint)
        return None if raw is None else NodeCacheEntry.from_json_dict(raw)

    def get_legacy(self, stage_fingerprint: str) -> Optional[NodeCacheEntry]:
        """Look up a legacy stage-keyed entry (the upgrade-path read)."""
        raw = self.store.get_ref(_LEGACY_CACHE_NS, stage_fingerprint)
        return None if raw is None else NodeCacheEntry.from_json_dict(raw)

    def put(self, entry: NodeCacheEntry) -> None:
        self.store.set_ref(_CACHE_NS, entry.fingerprint, entry.to_json_dict())

    def put_legacy(self, entry: NodeCacheEntry) -> None:
        """Write into the legacy stage-keyed namespace.  Only migration
        tests and pre-node tooling should ever need this."""
        self.store.set_ref(
            _LEGACY_CACHE_NS, entry.fingerprint, entry.to_json_dict()
        )

    def invalidate(self, fingerprint: str) -> bool:
        """Drop an entry from whichever namespace holds it; idempotent,
        returns whether it existed."""
        dropped = self.store.delete_ref(_CACHE_NS, fingerprint)
        return self.store.delete_ref(_LEGACY_CACHE_NS, fingerprint) or dropped

    def touch(
        self,
        fingerprint: str,
        *,
        entry: Optional[NodeCacheEntry] = None,
        now: Optional[float] = None,
    ) -> None:
        """Bump an entry's LRU clock (called by the runner on a hit).
        Pass ``entry`` when already in hand to skip the re-fetch."""
        entry = entry if entry is not None else self.get(fingerprint)
        if entry is None:
            return
        self.put(replace(entry, last_used_at=now if now is not None else time.time()))

    def entries(self) -> Dict[str, NodeCacheEntry]:
        """Union of node-keyed and surviving legacy entries — what the
        eviction policy budgets and the GC mark walks."""
        out = {
            fp: NodeCacheEntry.from_json_dict(raw)
            for fp, raw in self.store.list_refs(_LEGACY_CACHE_NS).items()
        }
        out.update(
            (fp, NodeCacheEntry.from_json_dict(raw))
            for fp, raw in self.store.list_refs(_CACHE_NS).items()
        )
        return out

    def total_bytes(self) -> int:
        """Sum of output_bytes across live entries (the budgeted figure)."""
        return sum(e.output_bytes for e in self.entries().values())

    def clear(self) -> None:
        for fp in list(self.entries()):
            self.invalidate(fp)


#: historical name — maintenance, CLI and tests predating node granularity
StageCacheRegistry = NodeCacheRegistry


class CacheView:
    """The planner's window onto the differential cache.

    ``build_physical_plan`` consults it to decide which logical nodes can
    be satisfied without execution; the runner constructs one per cached
    run.  The view is strictly read-only at plan time: ``adopt_legacy``
    only *stages* the one-way upgrade of a matched legacy stage entry into
    per-node entries, and the runner applies it (``apply_adoptions``)
    after the run's audit passes — a failed run must not mutate the
    registry, re-keying included.
    """

    def __init__(self, registry: NodeCacheRegistry):
        self.registry = registry
        #: (legacy entry, replacement node entries) staged by the planner
        self.pending_adoptions: List[
            Tuple[NodeCacheEntry, List[NodeCacheEntry]]
        ] = []

    def node(self, fingerprint: str) -> Optional[NodeCacheEntry]:
        return self.registry.get(fingerprint)

    def legacy_stage(self, stage_fingerprint: str) -> Optional[NodeCacheEntry]:
        return self.registry.get_legacy(stage_fingerprint)

    def adopt_legacy(
        self,
        legacy: NodeCacheEntry,
        node_entries: List[NodeCacheEntry],
    ) -> None:
        """Stage the split of ``legacy`` into node-keyed ``node_entries``.

        The legacy entry's outputs were written by a fully-audited run, so
        the adopted entries inherit its provenance (run_id/created_at);
        this run can plan against them immediately.  Nothing is persisted
        here — ``apply_adoptions`` runs post-audit.
        """
        self.pending_adoptions.append((legacy, list(node_entries)))

    def apply_adoptions(self) -> None:
        """Persist staged upgrades: write the node entries, retire the
        stage-keyed originals (the node entries now root the same
        manifests for the GC).  Idempotent; called by the runner after a
        successful audit."""
        for legacy, entries in self.pending_adoptions:
            for entry in entries:
                self.registry.put(entry)
            self.registry.store.delete_ref(
                _LEGACY_CACHE_NS, legacy.fingerprint
            )
        self.pending_adoptions.clear()
