"""repro_torch.telemetry — event bus, run tracing, and the metrics plane.

* ``repro_torch.telemetry.events``  — the typed event schema (Run/Stage/
  NodeCache/Speculation/Scan/Query/Gc/Compaction kinds) with per-run
  monotonic sequence numbers (``QueryExecuted`` carries the interactive
  path's parse/plan/scan/exec breakdown);
* ``repro_torch.telemetry.bus``     — in-process multi-consumer bus with
  bounded per-subscriber buffers, drop accounting, and an on-disk spool
  for cross-process tailing (``events --follow``);
* ``repro_torch.telemetry.tracing`` — span assembly (run→stage→node→scan),
  critical-path analysis, Chrome trace export (``trace``);
* ``repro_torch.telemetry.metrics`` — counters/gauges/histograms behind one
  registry (absorbs ``StoreStats`` bumps + executor latencies);
* ``repro_torch.telemetry.runlog``  — a run's events persisted to the lake
  as a GC-able artifact under the ``runlog`` namespace;
* ``repro_torch.telemetry.spans``   — the model path's spans (``lm.*``):
  ``torch.profiler.record_function`` while a profiler records, a flag
  check otherwise.
"""
from repro_torch.telemetry.bus import EventBus, Subscription, follow_spool, read_spool
from repro_torch.telemetry.events import (
    EVENT_TYPES,
    CompactionApplied,
    Event,
    GcSweep,
    NodeCacheHit,
    NodeCacheMiss,
    NodeCacheRehydrated,
    QueryExecuted,
    RunFinished,
    RunStarted,
    ScanShardRead,
    SpeculationArmed,
    SpeculationFired,
    SpeculationWon,
    StageCommitted,
    StageFinished,
    StageQueued,
    StageStarted,
    event_from_json_dict,
)
from repro_torch.telemetry.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.telemetry.runlog import RUNLOG_NS, RunLogStore
from repro_torch.telemetry.tracing import RunTrace, Span

__all__ = [
    "EventBus",
    "Subscription",
    "read_spool",
    "follow_spool",
    "Event",
    "EVENT_TYPES",
    "event_from_json_dict",
    "RunStarted",
    "RunFinished",
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
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RunLogStore",
    "RUNLOG_NS",
    "RunTrace",
    "Span",
]
