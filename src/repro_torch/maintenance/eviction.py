"""Differential-cache eviction (``repro cache prune``).

The cache only pays off long-term if its footprint is bounded (FaaS and
Furious, arXiv 2411.08203): every audited run adds entries, and each
entry roots its output manifests against the GC.  The eviction policy is
the classic two-stage filter:

1. **TTL** — entries not used for ``ttl_s`` seconds are dropped outright;
2. **LRU within a byte budget** — survivors are ranked by
   ``last_used_at`` and evicted oldest-first until the summed
   ``output_bytes`` fits ``max_bytes``.

Eviction only removes the registry *entry* (a ref); the entry's blobs
become unreachable the moment no branch/tag/pin still needs them and are
reclaimed by the next ``repro gc`` — eviction releases roots, the
sweeper frees bytes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.snapshot import NodeCacheEntry, NodeCacheRegistry
from repro_torch.utils.logging import get_logger

log = get_logger("maintenance.eviction")


@dataclass(frozen=True)
class EvictionPolicy:
    """Byte budget + optional TTL; None disables that stage."""

    max_bytes: Optional[int] = None
    ttl_s: Optional[float] = None


@dataclass(frozen=True)
class EvictionReport:
    entries_before: int
    entries_evicted: int
    bytes_before: int
    #: output_bytes released to the sweeper (reclaimed at the next gc)
    bytes_released: int
    bytes_after: int
    dry_run: bool

    def describe(self) -> str:
        verb = "would evict" if self.dry_run else "evicted"
        return (
            f"cache prune: {verb} {self.entries_evicted}/{self.entries_before} "
            f"entries, released {self.bytes_released} bytes "
            f"({self.bytes_before} -> {self.bytes_after})"
        )


def prune_cache(
    registry: NodeCacheRegistry,
    policy: EvictionPolicy,
    *,
    now: Optional[float] = None,
    dry_run: bool = False,
) -> EvictionReport:
    """Apply ``policy`` to the registry; idempotent under retries."""
    now = now if now is not None else time.time()
    entries = list(registry.entries().values())
    bytes_before = sum(e.output_bytes for e in entries)

    expired: List[NodeCacheEntry] = []
    survivors: List[NodeCacheEntry] = []
    for e in entries:
        if policy.ttl_s is not None and now - e.last_used_at > policy.ttl_s:
            expired.append(e)
        else:
            survivors.append(e)

    # LRU: oldest last_used_at evicts first until the budget fits
    survivors.sort(key=lambda e: (e.last_used_at, e.fingerprint))
    if policy.max_bytes is not None:
        total = sum(e.output_bytes for e in survivors)
        while survivors and total > policy.max_bytes:
            victim = survivors.pop(0)
            total -= victim.output_bytes
            expired.append(victim)

    if not dry_run:
        for e in expired:
            registry.invalidate(e.fingerprint)
        registry.store.bump_stat("cache_entries_evicted", len(expired))

    bytes_released = sum(e.output_bytes for e in expired)
    report = EvictionReport(
        entries_before=len(entries),
        entries_evicted=len(expired),
        bytes_before=bytes_before,
        bytes_released=bytes_released,
        bytes_after=bytes_before - bytes_released,
        dry_run=dry_run,
    )
    log.info("%s", report.describe())
    return report
