"""TensorTable physical format: shards, manifests, snapshots.

Responsibility split (mirrors Parquet vs Iceberg):

* a **shard** is one immutable columnar blob per column (content-addressed),
  plus per-column min/max stats captured at write time;
* a **manifest** lists the shards of one table version;
* a **snapshot** is (schema, manifest, lineage) — the unit the catalog
  commits.  Appends create a new snapshot sharing parent shards
  (structural sharing = cheap time travel, paper 4.2/4.3).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.io.objectstore import ObjectStore
from repro_torch.io.serialization import array_to_bytes, bytes_to_array, dumps_json, loads_json
from repro_torch.table.schema import Schema
from repro_torch.utils.hashing import stable_hash

#: default rows per shard — small enough that predicate pushdown has
#: something to prune, big enough to amortize per-shard overheads.
DEFAULT_SHARD_ROWS = 65536

#: ref namespace memoizing snapshot_id -> content fingerprint (tiny JSON
#: pointers; stale ones for expired snapshots are harmless)
_CONTENT_NS = "contenthash"


@dataclass(frozen=True)
class ShardMeta:
    """Metadata for one shard: blob keys + per-column stats."""

    num_rows: int
    column_blobs: Dict[str, str]  # column name -> object-store key
    column_stats: Dict[str, Dict[str, float]]  # column name -> {min, max}

    def to_json_dict(self) -> Dict:
        return {
            "num_rows": self.num_rows,
            "column_blobs": self.column_blobs,
            "column_stats": self.column_stats,
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "ShardMeta":
        return ShardMeta(d["num_rows"], d["column_blobs"], d["column_stats"])


@dataclass(frozen=True)
class Snapshot:
    """One immutable table version."""

    table: str
    snapshot_id: str
    schema: Schema
    shards: Sequence[ShardMeta]
    parent_id: Optional[str]  # lineage for time travel

    @property
    def num_rows(self) -> int:
        return sum(s.num_rows for s in self.shards)

    def to_json_dict(self) -> Dict:
        return {
            "table": self.table,
            "snapshot_id": self.snapshot_id,
            "schema": self.schema.to_json_dict(),
            "shards": [s.to_json_dict() for s in self.shards],
            "parent_id": self.parent_id,
        }

    @staticmethod
    def from_json_dict(d: Dict) -> "Snapshot":
        return Snapshot(
            table=d["table"],
            snapshot_id=d["snapshot_id"],
            schema=Schema.from_json_dict(d["schema"]),
            shards=tuple(ShardMeta.from_json_dict(s) for s in d["shards"]),
            parent_id=d.get("parent_id"),
        )


#: A fully-materialized columnar table in memory: {column: 1-D array}.
TableData = Dict[str, np.ndarray]


@dataclass
class TableFormat:
    """Reader/writer for TensorTables over an ObjectStore."""

    store: ObjectStore
    shard_rows: int = DEFAULT_SHARD_ROWS

    # ----------------------------------------------------------------- write
    def write(
        self,
        table: str,
        schema: Schema,
        data: TableData,
        *,
        parent: Optional[Snapshot] = None,
        append: bool = False,
    ) -> Snapshot:
        """Write a new snapshot. ``append=True`` keeps the parent's shards."""
        nrows = schema.validate_batch(data)
        shards: List[ShardMeta] = []
        if append and parent is not None:
            if parent.schema != schema:
                raise TypeError(
                    f"append schema mismatch for {table}: "
                    f"{schema.names} vs {parent.schema.names}"
                )
            shards.extend(parent.shards)
        for start in range(0, max(nrows, 1), self.shard_rows):
            stop = min(start + self.shard_rows, nrows)
            if stop <= start:
                break
            shards.append(self._write_shard(
                schema, {c.name: data[c.name][start:stop] for c in schema.columns}
            ))
        return self._seal_snapshot(
            table, schema, shards, parent.snapshot_id if parent else None
        )

    def _write_shard(self, schema: Schema, data: TableData) -> ShardMeta:
        """Write one shard's column blobs, capturing min/max stats."""
        blobs: Dict[str, str] = {}
        stats: Dict[str, Dict[str, float]] = {}
        nrows = 0
        for col in schema.columns:
            chunk = np.ascontiguousarray(data[col.name])
            nrows = len(chunk)
            blobs[col.name] = self.store.put(array_to_bytes(chunk))
            if chunk.size and chunk.dtype.kind in "iuf":
                stats[col.name] = {
                    "min": float(np.min(chunk)),
                    "max": float(np.max(chunk)),
                }
            else:
                stats[col.name] = {"min": float("-inf"), "max": float("inf")}
        return ShardMeta(nrows, blobs, stats)

    def _seal_snapshot(
        self,
        table: str,
        schema: Schema,
        shards: Sequence[ShardMeta],
        parent_id: Optional[str],
    ) -> Snapshot:
        snapshot_id = stable_hash(
            {
                "table": table,
                "schema": schema.to_json_dict(),
                "shards": [s.to_json_dict() for s in shards],
                "parent": parent_id,
            }
        )
        snap = Snapshot(table, snapshot_id, schema, tuple(shards), parent_id)
        # persist the snapshot manifest itself so catalogs only hold keys
        self.store.put(dumps_json(snap.to_json_dict()))
        return snap

    # ----------------------------------------------------------- compaction
    def compact_snapshot(
        self,
        snapshot: Snapshot,
        *,
        target_rows: Optional[int] = None,
        min_fill: float = 0.5,
    ) -> tuple:
        """Rewrite runs of small shards into fewer near-``target_rows`` ones.

        The mechanics half of ``repro compact`` (policy + catalog commit
        live in repro.maintenance.compaction).  Only *adjacent* shards
        merge and the merged chunk preserves row order, so a full scan of
        the new snapshot is bit-identical to the old one.  Shards already
        at least ``min_fill * target_rows`` full pass through untouched —
        structural sharing keeps compaction incremental.  Per-column
        min/max stats are recomputed from the merged data, so
        ``Predicate.may_match`` pruning stays exact.

        Returns ``(new_snapshot, shards_merged)``; ``shards_merged == 0``
        means nothing to do and ``new_snapshot is snapshot``.
        """
        groups = plan_compaction_groups(
            snapshot.shards,
            target_rows=target_rows or self.shard_rows,
            min_fill=min_fill,
        )
        out: List[ShardMeta] = []
        merged = 0
        for group in groups:
            if len(group) == 1:
                out.append(group[0])
                continue
            parts = [self.read_shard(s) for s in group]
            data = {
                c: np.concatenate([p[c] for p in parts])
                for c in snapshot.schema.names
            }
            out.append(self._write_shard(snapshot.schema, data))
            merged += len(group)
        if merged == 0:
            return snapshot, 0
        return (
            self._seal_snapshot(
                snapshot.table, snapshot.schema, out, snapshot.snapshot_id
            ),
            merged,
        )

    # ------------------------------------------------------------------ read
    def read_shard(
        self, shard: ShardMeta, columns: Optional[Sequence[str]] = None
    ) -> TableData:
        cols = columns if columns is not None else list(shard.column_blobs)
        return {c: bytes_to_array(self.store.get(shard.column_blobs[c])) for c in cols}

    def read(
        self, snapshot: Snapshot, columns: Optional[Sequence[str]] = None
    ) -> TableData:
        """Materialize (selected columns of) a snapshot into memory."""
        cols = list(columns) if columns is not None else snapshot.schema.names
        if not snapshot.shards:
            return {
                c: np.empty((0,), dtype=snapshot.schema.dtype_of(c)) for c in cols
            }
        parts = [self.read_shard(s, cols) for s in snapshot.shards]
        return {c: np.concatenate([p[c] for p in parts]) for c in cols}

    def content_fingerprint(self, snapshot: Snapshot) -> str:
        """Sharding-invariant identity of a table version.

        Streams each column's raw row-order bytes (shard boundaries
        excluded) through sha256, then hashes the per-column digests with
        the schema.  Because ``compact_snapshot`` preserves row order, a
        compacted snapshot has the SAME content fingerprint as its parent
        even though its snapshot id (which hashes shard layout) differs —
        this is what keeps the differential cache warm across ``repro
        compact``.  The result is memoized per snapshot id in the ref
        space, so only the first caller per table version pays the scan.
        """
        memo = self.store.get_ref(_CONTENT_NS, snapshot.snapshot_id)
        if memo is not None:
            return memo["content_fingerprint"]
        hashers = {c: hashlib.sha256() for c in snapshot.schema.names}
        for shard in snapshot.shards:
            data = self.read_shard(shard)
            for c in snapshot.schema.names:
                hashers[c].update(np.ascontiguousarray(data[c]).tobytes())
        fp = stable_hash(
            {
                "table": snapshot.table,
                "schema": snapshot.schema.to_json_dict(),
                "columns": {c: h.hexdigest() for c, h in hashers.items()},
            }
        )
        self.store.set_ref(
            _CONTENT_NS, snapshot.snapshot_id, {"content_fingerprint": fp}
        )
        return fp

    def prune_content_fingerprints(
        self, live_snapshot_ids: set, *, dry_run: bool = False
    ) -> int:
        """Drop content-fingerprint memo refs whose snapshot is no longer
        live (``repro gc`` calls this after the mark) — without it every
        expired table version would leak one tiny ref forever.  Returns
        the number of refs pruned; a dropped memo is only a cache miss,
        the fingerprint recomputes on next use."""
        pruned = 0
        for snapshot_id in self.store.list_refs(_CONTENT_NS):
            if snapshot_id in live_snapshot_ids:
                continue
            pruned += 1
            if not dry_run:
                self.store.delete_ref(_CONTENT_NS, snapshot_id)
        return pruned

    def load_snapshot(self, manifest_key: str) -> Snapshot:
        return Snapshot.from_json_dict(loads_json(self.store.get(manifest_key)))

    def snapshot_object_keys(self, manifest_key: str) -> set:
        """The manifest blob itself plus every column blob it references —
        one table version's contribution to the GC live set.  A missing
        manifest yields the empty set (tolerates a crashed prior sweep)."""
        if not self.store.exists(manifest_key):
            return set()
        snap = self.load_snapshot(manifest_key)
        keys = {manifest_key}
        for shard in snap.shards:
            keys.update(shard.column_blobs.values())
        return keys

    def manifest_key(self, snapshot: Snapshot) -> str:
        """Content address of a snapshot manifest (what catalogs store)."""
        return self.store.put(dumps_json(snapshot.to_json_dict()))


def plan_compaction_groups(
    shards: Sequence[ShardMeta],
    *,
    target_rows: int,
    min_fill: float = 0.5,
) -> List[List[ShardMeta]]:
    """Greedy, order-preserving grouping: consecutive *small* shards
    (< ``min_fill * target_rows`` rows) pack together until adding the
    next would exceed ``target_rows``.  Each returned group becomes one
    output shard; singleton groups pass through without a rewrite.  Pure
    metadata — used both by the writer and by ``repro compact --dry-run``.
    """
    small_cutoff = max(1, int(min_fill * target_rows))
    groups: List[List[ShardMeta]] = []
    buffer: List[ShardMeta] = []
    buffered_rows = 0

    def flush() -> None:
        nonlocal buffered_rows
        if buffer:
            groups.append(list(buffer))
            buffer.clear()
        buffered_rows = 0

    for shard in shards:
        if shard.num_rows < small_cutoff:
            if buffer and buffered_rows + shard.num_rows > target_rows:
                flush()
            buffer.append(shard)
            buffered_rows += shard.num_rows
        else:
            flush()
            groups.append([shard])
    flush()
    return groups
