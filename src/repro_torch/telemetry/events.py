"""The typed telemetry event schema — one vocabulary for the whole platform.

Every component that does observable work (the wave scheduler, the
serverless executor, the scan pool, the lakekeeper) publishes one of the
event types below onto the :class:`repro.telemetry.bus.EventBus`.  Events
are plain dataclasses with a ``kind`` discriminator so they round-trip
through JSON — the run log persisted to the lake (``runlog`` namespace),
the live spool file tailed by ``repro events --follow``, and the Chrome
trace export all speak this one schema.

Two fields are stamped by the bus at publish time, never by the caller:

* ``ts``  — wall-clock seconds (``time.time()``); span durations carried
  on the events themselves (``dur_s``/``exec_s``/...) are measured with
  ``perf_counter`` at the site, so the trace assembler prefers those;
* ``seq`` — monotonic sequence number **per run** (events without a
  ``run_id`` share one global scope), so a consumer can detect gaps after
  a bounded buffer dropped on it, and the run log has a total order that
  does not depend on thread interleaving of equal timestamps.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, ClassVar, Dict, List, Optional, Type

__all__ = [
    "Event",
    "RunStarted",
    "RunFinished",
    "StageScheduled",
    "StageQueued",
    "StageStarted",
    "StageFinished",
    "StageCommitted",
    "NodeCacheHit",
    "NodeCacheMiss",
    "NodeCacheRehydrated",
    "SpeculationArmed",
    "SpeculationFired",
    "SpeculationWon",
    "ScanShardRead",
    "QueryExecuted",
    "GcSweep",
    "CompactionApplied",
    "EVENT_TYPES",
    "event_from_json_dict",
]


@dataclass
class Event:
    """Base event: the envelope every concrete kind shares.

    Subclass fields must stay JSON-serializable (str/int/float/bool and
    flat lists thereof) — events are persisted verbatim to the run log.
    """

    kind: ClassVar[str] = "Event"

    #: the run this event belongs to (None for maintenance/global events)
    run_id: Optional[int] = None
    #: wall-clock seconds; stamped by the bus unless the publisher set it
    #: (publishers that measured a span set ts to the span *start*)
    ts: float = 0.0
    #: per-run monotonic sequence number, stamped by the bus
    seq: int = 0

    def to_json_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["kind"] = self.kind
        return d


# ------------------------------------------------------------------ run
@dataclass
class RunStarted(Event):
    kind: ClassVar[str] = "RunStarted"
    pipeline: str = ""
    branch: str = ""
    #: set when this run re-executes a recorded one (Runner.replay)
    replay_of: Optional[int] = None


@dataclass
class RunFinished(Event):
    """Always emitted, whatever the outcome — a mid-DAG stage crash or a
    failed audit still closes the run span (state carries the verdict)."""

    kind: ClassVar[str] = "RunFinished"
    #: SUCCESS | AUDIT_FAILED | ERROR
    state: str = "SUCCESS"
    wall_s: float = 0.0
    failed_checks: List[str] = field(default_factory=list)


# ---------------------------------------------------------------- stages
@dataclass
class StageScheduled(Event):
    """The Scheduler-v2 admission decision for one stage: the cost-model
    estimate that ordered it, its critical-path rank, and how long the
    memory-capped admission gate held it after it became ready.  `repro
    trace` joins this against StageStarted/StageFinished for the
    predicted-vs-actual table."""

    kind: ClassVar[str] = "StageScheduled"
    stage_id: int = 0
    #: estimated runtime seconds ("latency" = latencyhist median,
    #: "bytes" = scan-bytes heuristic)
    est_cost_s: float = 0.0
    cost_source: str = "bytes"
    #: longest-path-to-sink weight and rank (0 = most critical)
    cp_weight_s: float = 0.0
    cp_rank: int = 0
    #: estimated peak memory tier charged against the admission budget
    est_memory_gb: int = 1
    #: seconds between becoming ready (parents satisfied) and admission
    admission_wait_s: float = 0.0
    #: "immediate" | "waited" — whether the admission gate held the stage
    admission: str = "immediate"
    #: ordering mode ("critical_path" | "stage_id") and streaming handoff
    schedule: str = "critical_path"
    streaming: bool = False
    #: compiled executable already cached for this stage's fingerprint
    warm: bool = False


@dataclass
class StageQueued(Event):
    """The wave scheduler handed the stage to the executor's stage lane;
    queue time is StageStarted.ts - StageQueued.ts."""

    kind: ClassVar[str] = "StageQueued"
    stage_id: int = 0
    nodes: List[str] = field(default_factory=list)
    #: dependency edges — lets the trace assembler compute the critical
    #: path without re-planning the pipeline
    parents: List[int] = field(default_factory=list)


@dataclass
class StageStarted(Event):
    kind: ClassVar[str] = "StageStarted"
    stage_id: int = 0


@dataclass
class StageFinished(Event):
    """The stage driver finished scan → execute → write (commit pending)."""

    kind: ClassVar[str] = "StageFinished"
    stage_id: int = 0
    exec_s: float = 0.0
    outputs: List[str] = field(default_factory=list)
    checks: List[str] = field(default_factory=list)


@dataclass
class StageCommitted(Event):
    """The stage's table updates landed on the ephemeral branch (commits
    are applied in stage-id order, possibly by a later stage's thread)."""

    kind: ClassVar[str] = "StageCommitted"
    stage_id: int = 0
    tables: List[str] = field(default_factory=list)
    commit_s: float = 0.0


# ----------------------------------------------------------------- cache
@dataclass
class NodeCacheHit(Event):
    """A logical node the differential cache satisfied at plan time."""

    kind: ClassVar[str] = "NodeCacheHit"
    node: str = ""
    fingerprint: str = ""
    #: True when the node's artifact is restored (committed) this run;
    #: False for elided nodes and audited-check hits
    rehydrated: bool = False
    bytes: int = 0


@dataclass
class NodeCacheMiss(Event):
    """A logical node the plan must execute (cache consulted, no entry)."""

    kind: ClassVar[str] = "NodeCacheMiss"
    node: str = ""
    fingerprint: str = ""
    stage_id: int = 0


@dataclass
class NodeCacheRehydrated(Event):
    """A cached artifact's manifest was committed to the run's ephemeral
    branch instead of being recomputed (the rehydrate span)."""

    kind: ClassVar[str] = "NodeCacheRehydrated"
    node: str = ""
    bytes: int = 0
    dur_s: float = 0.0


# ----------------------------------------------------------- speculation
@dataclass
class SpeculationArmed(Event):
    """A straggler deadline was armed against the task's latency history."""

    kind: ClassVar[str] = "SpeculationArmed"
    task: str = ""
    stage_id: Optional[int] = None
    baseline_s: float = 0.0
    deadline_s: float = 0.0


@dataclass
class SpeculationFired(Event):
    """The deadline passed — a duplicate container launched."""

    kind: ClassVar[str] = "SpeculationFired"
    task: str = ""
    stage_id: Optional[int] = None


@dataclass
class SpeculationWon(Event):
    """The backup finished (successfully) before the straggler."""

    kind: ClassVar[str] = "SpeculationWon"
    task: str = ""
    stage_id: Optional[int] = None


# ------------------------------------------------------------------ scans
@dataclass
class ScanShardRead(Event):
    """One shard read (+ residual filter) by the scan pool.  ``ts`` is the
    read's start; ``dur_s`` its wall duration — together they place the
    scan span inside its stage lane."""

    kind: ClassVar[str] = "ScanShardRead"
    table: str = ""
    shard_index: int = 0
    rows_in: int = 0
    rows_out: int = 0
    dur_s: float = 0.0
    #: "stage" for pipeline scans, "query" for interactive client.query()
    source: str = "stage"
    stage_id: Optional[int] = None


@dataclass
class QueryExecuted(Event):
    """One interactive query completed (point-wise path, paper 4.6).

    ``engine_path`` records which engine ran the filter+group+agg
    pipeline ("kernel" = fused Pallas kernel, "jnp" = reference path) and
    the ``*_s`` attrs break the wall clock into per-operator phases —
    parse, plan (catalog + routing + scan planning), scan (pooled shard
    reads), exec (compiled query)."""

    kind: ClassVar[str] = "QueryExecuted"
    table: str = ""
    rows_out: int = 0
    shards_read: int = 0
    wall_s: float = 0.0
    engine_path: str = "jnp"
    parse_s: float = 0.0
    plan_s: float = 0.0
    scan_s: float = 0.0
    exec_s: float = 0.0


# ------------------------------------------------------------ maintenance
@dataclass
class GcSweep(Event):
    kind: ClassVar[str] = "GcSweep"
    swept_objects: int = 0
    swept_commits: int = 0
    swept_runlog_refs: int = 0
    bytes_reclaimed: int = 0
    dry_run: bool = False


@dataclass
class CompactionApplied(Event):
    kind: ClassVar[str] = "CompactionApplied"
    table: str = ""
    branch: str = ""
    shards_before: int = 0
    shards_after: int = 0
    shards_merged: int = 0
    dry_run: bool = False


#: kind discriminator -> event class (the run-log reader's vocabulary)
EVENT_TYPES: Dict[str, Type[Event]] = {
    cls.kind: cls
    for cls in (
        RunStarted,
        RunFinished,
        StageScheduled,
        StageQueued,
        StageStarted,
        StageFinished,
        StageCommitted,
        NodeCacheHit,
        NodeCacheMiss,
        NodeCacheRehydrated,
        SpeculationArmed,
        SpeculationFired,
        SpeculationWon,
        ScanShardRead,
        QueryExecuted,
        GcSweep,
        CompactionApplied,
    )
}


def event_from_json_dict(d: Dict[str, Any]) -> Event:
    """Rebuild a typed event from its JSON form.  Unknown kinds (a newer
    writer) degrade to the base ``Event`` rather than failing the reader;
    unknown fields on a known kind are dropped for the same reason."""
    d = dict(d)
    kind = d.pop("kind", "Event")
    cls = EVENT_TYPES.get(kind, Event)
    known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
    return cls(**{k: v for k, v in d.items() if k in known})
