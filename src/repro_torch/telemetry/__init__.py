"""repro_torch.telemetry — the typed event schema and the event bus.

* ``repro_torch.telemetry.events`` — the typed event schema with per-run
  monotonic sequence numbers (``QueryExecuted`` carries the interactive
  path's parse/plan/scan/exec breakdown);
* ``repro_torch.telemetry.bus``    — in-process multi-consumer bus with
  bounded per-subscriber buffers, drop accounting, and an on-disk spool.
"""
from repro_torch.telemetry.bus import EventBus, Subscription, follow_spool, read_spool
from repro_torch.telemetry.events import (
    EVENT_TYPES,
    Event,
    QueryExecuted,
    ScanShardRead,
    event_from_json_dict,
)

__all__ = [
    "EventBus",
    "Subscription",
    "read_spool",
    "follow_spool",
    "Event",
    "EVENT_TYPES",
    "event_from_json_dict",
    "QueryExecuted",
    "ScanShardRead",
]
