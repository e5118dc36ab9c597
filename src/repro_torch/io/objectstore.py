"""Content-addressed object store — the local-filesystem stand-in for S3.

Design points lifted from the paper:

* **Immutability**: objects are keyed by content hash; a key never changes
  meaning.  This is what makes catalog branches, time travel and run replay
  (4.3, 4.4.1) trivially correct — a snapshot is just a set of keys.
* **Object storage as last resort** (4.5): the store counts puts/gets/bytes
  so the physical planner and benchmarks can *prove* fusion avoided
  spillover (the paper's 5x claim is about exactly this).
* Namespaced refs: small mutable pointers (branch heads) live in a separate
  ref space with atomic swap semantics, mirroring how Nessie keeps branch
  heads apart from immutable commits.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional, Set

from repro_torch.utils.hashing import content_hash


@dataclass
class StoreStats:
    """Telemetry: the 'bytes moved' ledger used by planner + benchmarks.

    Counter updates are atomic under the ledger's own lock (``bump``), so
    concurrently executing stages — the wave scheduler runs shard reads
    and artifact writes from many threads — can never lose I/O accounting,
    regardless of which component holds the ``ObjectStore`` lock.
    """

    puts: int = 0
    gets: int = 0
    bytes_written: int = 0
    bytes_read: int = 0
    ref_updates: int = 0
    #: differential cache: stages restored from the store instead of
    #: recomputed, and the output bytes that were NOT re-written as a result
    cache_hits: int = 0
    cache_bytes_saved: int = 0
    #: lakekeeper maintenance ledger (see repro.maintenance): the gc_*,
    #: cache_entries_* and compact_* counters are maintenance telemetry,
    #: not run I/O — the runner's per-run io delta excludes those prefixes
    gc_objects_swept: int = 0
    gc_bytes_reclaimed: int = 0
    cache_entries_evicted: int = 0
    compact_shards_merged: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        # duck-typed MetricsRegistry (attach_metrics) — kept out of the
        # dataclass fields so snapshot()/asdict semantics are unchanged
        self._metrics = None

    def attach_metrics(self, registry) -> None:
        """Mirror every future bump into ``store.<counter>`` counters on a
        :class:`repro.telemetry.metrics.MetricsRegistry` (duck-typed: any
        object with ``counter(name).inc(n)``).  The unified metrics plane
        absorbs this ledger without touching any bump call site."""
        with self._lock:
            self._metrics = registry

    def bump(self, **deltas: int) -> None:
        """Atomically increment counters by name — the single mutation
        path; every writer goes through here."""
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)
            metrics = self._metrics
        if metrics is not None:
            for name, delta in deltas.items():
                metrics.counter(f"store.{name}").inc(delta)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "puts": self.puts,
                "gets": self.gets,
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "ref_updates": self.ref_updates,
                "cache_hits": self.cache_hits,
                "cache_bytes_saved": self.cache_bytes_saved,
                "gc_objects_swept": self.gc_objects_swept,
                "gc_bytes_reclaimed": self.gc_bytes_reclaimed,
                "cache_entries_evicted": self.cache_entries_evicted,
                "compact_shards_merged": self.compact_shards_merged,
            }


@dataclass(frozen=True)
class SweepResult:
    """Outcome of one mark-and-sweep pass over the blob space."""

    swept: int
    bytes_reclaimed: int
    #: unreachable objects spared because they are younger than the grace
    #: period (an in-flight run may have written them before committing)
    kept_young: int
    dry_run: bool


@dataclass
class ObjectStore:
    """A content-addressed blob store rooted at a local directory.

    Layout::

        root/
          objects/ab/cdef....        # immutable blobs, sharded by prefix
          refs/<namespace>/<name>    # small mutable pointers (JSON)
    """

    root: Path
    stats: StoreStats = field(default_factory=StoreStats)

    def __post_init__(self) -> None:
        self.root = Path(self.root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)
        (self.root / "refs").mkdir(parents=True, exist_ok=True)
        # RLock: compare_and_set_ref holds the lock across get_ref/set_ref
        # (stats counters have their own lock inside StoreStats).
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ blobs
    def _object_path(self, key: str) -> Path:
        return self.root / "objects" / key[:2] / key[2:]

    def put(self, data: bytes) -> str:
        """Store a blob, return its content address. Idempotent."""
        key = content_hash(data)
        path = self._object_path(key)
        self.stats.bump(puts=1, bytes_written=len(data))
        if path.exists():  # content-addressed: already present...
            # ...but refresh its mtime: the GC grace period keys off object
            # age, and a writer deduping onto an old *unreachable* blob
            # must re-arm the grace window or a concurrent sweep could
            # delete the blob before this writer commits a reference to it
            try:
                os.utime(path, None)
                return key
            except FileNotFoundError:
                pass  # a concurrent sweep won the race — rewrite below
        path.parent.mkdir(parents=True, exist_ok=True)
        # Write-then-rename for atomicity (a crashed writer never leaves a
        # half-object visible — required for checkpoint fault tolerance).
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return key

    def get(self, key: str) -> bytes:
        path = self._object_path(key)
        data = path.read_bytes()
        actual = content_hash(data)
        if actual != key:
            raise IOError(f"object store corruption: key={key} hash={actual}")
        self.stats.bump(gets=1, bytes_read=len(data))
        return data

    def exists(self, key: str) -> bool:
        return self._object_path(key).exists()

    def record_cache_hit(self, bytes_saved: int) -> None:
        """Count a differential-cache restore: one stage skipped,
        ``bytes_saved`` output bytes NOT re-written to the store."""
        self.stats.bump(cache_hits=1, cache_bytes_saved=bytes_saved)

    def bump_stat(self, counter: str, n: int = 1) -> None:
        """Thread-safe increment of a StoreStats counter by name (the
        maintenance services report through this)."""
        self.stats.bump(**{counter: n})

    def keys(self) -> Iterator[str]:
        objects = self.root / "objects"
        for shard in sorted(objects.iterdir()):
            if shard.is_dir():
                for obj in sorted(shard.iterdir()):
                    if not obj.name.startswith(".tmp-"):
                        yield shard.name + obj.name

    def object_size(self, key: str) -> Optional[int]:
        """Size in bytes of a stored blob, or None if absent."""
        try:
            return self._object_path(key).stat().st_size
        except FileNotFoundError:
            return None

    def object_age_s(self, key: str, *, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the blob was (last) written, or None if absent."""
        try:
            mtime = self._object_path(key).stat().st_mtime
        except FileNotFoundError:
            return None
        return max(0.0, (now if now is not None else time.time()) - mtime)

    def delete(self, key: str) -> int:
        """Delete a blob; return bytes freed (0 if already absent).

        Idempotent — deletion is a maintenance operation (GC sweep) that
        must be safely retryable after a crashed or concurrent sweeper.
        """
        path = self._object_path(key)
        try:
            size = path.stat().st_size
            path.unlink()
        except FileNotFoundError:
            return 0
        return size

    def sweep(
        self,
        live: Set[str],
        *,
        grace_s: float = 0.0,
        dry_run: bool = False,
        now: Optional[float] = None,
    ) -> SweepResult:
        """Delete every blob not in ``live`` (the sweep half of mark-and-sweep).

        ``grace_s`` spares unreachable objects younger than the grace
        period: an in-flight run writes stage outputs *before* committing
        them to its ephemeral branch, so a concurrent sweeper would see
        them as garbage for a moment.  ``dry_run`` reports what would be
        reclaimed without deleting anything.
        """
        now = now if now is not None else time.time()
        swept = 0
        bytes_reclaimed = 0
        kept_young = 0
        for key in list(self.keys()):
            if key in live:
                continue
            age = self.object_age_s(key, now=now)
            if age is None:
                continue  # raced with another sweeper
            if age < grace_s:
                kept_young += 1
                continue
            size = self.object_size(key) or 0
            if not dry_run:
                # re-check age at delete time: a writer deduping onto this
                # blob re-arms the grace window via put()'s utime, and the
                # first stat above may predate it (check-then-delete race)
                age = self.object_age_s(key, now=time.time())
                if age is None:
                    continue
                if age < grace_s:
                    kept_young += 1
                    continue
                size = self.delete(key)
            swept += 1
            bytes_reclaimed += size
        if not dry_run:
            self.stats.bump(
                gc_objects_swept=swept, gc_bytes_reclaimed=bytes_reclaimed
            )
        return SweepResult(swept, bytes_reclaimed, kept_young, dry_run)

    # ------------------------------------------------------------------- refs
    def _ref_path(self, namespace: str, name: str) -> Path:
        safe = name.replace("/", "__")
        return self.root / "refs" / namespace / safe

    def set_ref(self, namespace: str, name: str, value: Dict) -> None:
        path = self._ref_path(namespace, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(value, f, sort_keys=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.stats.bump(ref_updates=1)

    def get_ref(self, namespace: str, name: str) -> Optional[Dict]:
        path = self._ref_path(namespace, name)
        if not path.exists():
            return None
        return json.loads(path.read_text())

    def delete_ref(self, namespace: str, name: str) -> bool:
        """Delete a ref; return whether it existed.

        Idempotent (no-op on a missing ref, even under a concurrent
        deleter) so eviction and GC sweeps can retry safely.
        """
        path = self._ref_path(namespace, name)
        try:
            path.unlink()
        except FileNotFoundError:
            return False
        return True

    def list_refs(self, namespace: str) -> Dict[str, Dict]:
        ns = self.root / "refs" / namespace
        if not ns.exists():
            return {}
        out = {}
        for p in sorted(ns.iterdir()):
            if p.is_file() and not p.name.startswith(".tmp-"):
                out[p.name.replace("__", "/")] = json.loads(p.read_text())
        return out

    def compare_and_set_ref(
        self, namespace: str, name: str, expected: Optional[Dict], value: Dict
    ) -> bool:
        """Atomic CAS on a ref — the primitive behind safe branch updates."""
        with self._lock:
            current = self.get_ref(namespace, name)
            if current != expected:
                return False
            self.set_ref(namespace, name, value)
            return True
