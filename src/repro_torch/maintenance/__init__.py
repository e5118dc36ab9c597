"""Lakekeeper — the lake-maintenance subsystem.

The lakehouse's write path is append-only by design: blobs are
content-addressed and immutable, commits chain forever, the differential
cache grows monotonically.  That is what makes branches, time travel and
replay trivially correct (paper 4.3/4.4) — and also what makes a real
deployment leak storage without bound.  Lakekeeper is the counterpart
service every production lakehouse runs (Iceberg snapshot expiry + small
file compaction; see arXiv 2310.08697, and arXiv 2411.08203 for why a
differential cache must be budgeted):

* ``repro_torch.maintenance.reachability`` — the shared mark phase: walk roots
  (branch heads, tags, live cache entries, pinned in-flight runs) through
  commits -> snapshot manifests -> shard blobs;
* ``repro_torch.maintenance.gc``          — mark-and-sweep garbage collection
  with dry-run, history expiry and an in-flight grace period;
* ``repro_torch.maintenance.eviction``    — LRU/TTL cache eviction under a byte
  budget (evicted entries release their blobs to the sweeper);
* ``repro_torch.maintenance.compaction``  — small-shard compaction as a new
  catalog commit, old snapshots stay readable until expired.
"""
from repro_torch.maintenance.reachability import LiveSet, mark
from repro_torch.maintenance.gc import GCReport, collect_garbage
from repro_torch.maintenance.eviction import EvictionPolicy, EvictionReport, prune_cache
from repro_torch.maintenance.compaction import CompactionReport, compact_table, compact_branch

__all__ = [
    "LiveSet",
    "mark",
    "GCReport",
    "collect_garbage",
    "EvictionPolicy",
    "EvictionReport",
    "prune_cache",
    "CompactionReport",
    "compact_table",
    "compact_branch",
]
