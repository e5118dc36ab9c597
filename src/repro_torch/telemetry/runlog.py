"""Run traces persisted to the lake — the ``runlog`` namespace.

A run's full event stream is written as one content-addressed blob plus
a small ref (``refs/runlog/run_<id>``) pointing at it, so traces are
first-class lake artifacts: branchable, content-addressed, and GC-able
like everything else.  Reachability (repro.maintenance.reachability)
treats runlog refs as roots **only within a retention TTL** — an expired
trace's ref is swept by ``repro gc --runlog-ttl`` and its blob is
reclaimed on the same pass, while live traces keep their bytes pinned.

``RunHandle.trace()`` / ``Client.trace(run_id)`` / ``repro trace`` all
read back through here.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.io.objectstore import ObjectStore
from repro_torch.telemetry.events import Event, event_from_json_dict

__all__ = ["RUNLOG_NS", "RunLogStore"]

RUNLOG_NS = "runlog"


@dataclass
class RunLogStore:
    store: ObjectStore

    def _ref_name(self, run_id: int) -> str:
        return f"run_{run_id}"

    def put(
        self,
        run_id: int,
        events: Sequence[Event],
        *,
        pipeline: str = "",
        state: str = "",
    ) -> str:
        """Persist one run's events; returns the trace blob's key."""
        payload = json.dumps(
            {"run_id": run_id, "events": [e.to_json_dict() for e in events]},
            sort_keys=True,
        ).encode()
        blob = self.store.put(payload)
        self.store.set_ref(
            RUNLOG_NS,
            self._ref_name(run_id),
            {
                "run_id": run_id,
                "blob": blob,
                "events": len(events),
                "pipeline": pipeline,
                "state": state,
                "created_at": time.time(),
            },
        )
        return blob

    def get(self, run_id: int) -> List[Event]:
        """Load a run's events (KeyError if the trace is absent/expired)."""
        ref = self.store.get_ref(RUNLOG_NS, self._ref_name(run_id))
        if ref is None:
            raise KeyError(
                f"no runlog trace for run {run_id} (never recorded, "
                "telemetry disabled, or expired by gc --runlog-ttl)"
            )
        raw = json.loads(self.store.get(ref["blob"]))
        return [event_from_json_dict(d) for d in raw["events"]]

    def has(self, run_id: int) -> bool:
        return self.store.get_ref(RUNLOG_NS, self._ref_name(run_id)) is not None

    def refs(self) -> Dict[str, Dict]:
        """Every runlog ref (name -> {run_id, blob, created_at, ...})."""
        return self.store.list_refs(RUNLOG_NS)

    def live_blobs(self, *, ttl_s: Optional[float] = None) -> Dict[str, str]:
        """ref name -> blob key for refs still inside the retention TTL
        (None = every trace is live).  The reachability mark adds these
        blobs to the live object set."""
        now = time.time()
        out: Dict[str, str] = {}
        for name, ref in self.refs().items():
            if ttl_s is not None and now - ref.get("created_at", 0.0) > ttl_s:
                continue
            out[name] = ref["blob"]
        return out

    def sweep_expired(self, *, ttl_s: float, dry_run: bool = False) -> int:
        """Drop refs older than the TTL; their blobs become unreachable
        and fall to the same GC pass's object sweep.  Returns the count."""
        now = time.time()
        swept = 0
        for name, ref in self.refs().items():
            if now - ref.get("created_at", 0.0) > ttl_s:
                swept += 1
                if not dry_run:
                    self.store.delete_ref(RUNLOG_NS, name)
        return swept
