"""Span-based run tracing: events in, a run→stage→node→scan tree out.

The trace assembler consumes one run's event stream (live from the bus,
or loaded back from the ``runlog`` namespace) and rebuilds where the
wall-clock went:

* the **run span** (RunStarted → RunFinished) is the root;
* a **plan phase** covers planning + cache rehydration (with one
  ``rehydrate`` child span per restored node — a warm run is *all*
  rehydrate spans, which is exactly what the differential cache promised);
* each stage owns a lane with **queue** (scheduler handoff → stage
  start), **exec** (scan → execute → write) and **commit** spans; scan
  shard reads and the stage's logical nodes nest inside exec.  Nodes of
  a fused stage share the executor window — the platform deliberately
  does not time individual nodes inside one fused stage function, so
  their spans carry ``fused_with`` instead of fabricated durations;
* an **audit+write phase** covers the expectation gate + atomic merge.

``critical_path()`` walks the stage dependency edges (carried on
``StageQueued.parents``) to the longest queue+exec chain — the stages a
speedup must target.  It delegates to the SAME longest-path
implementation the Scheduler-v2 cost model uses for dispatch ordering
(``repro_torch.core.physical.longest_path_weights`` / ``critical_path_ids``),
fed observed latencies instead of estimates — one implementation, two
cost sources.  ``StageScheduled`` events are joined onto the stage
lanes, so ``describe()`` reports predicted-vs-actual per stage.
``to_chrome_trace()`` exports the tree as Chrome trace-event JSON (load
in ``chrome://tracing`` / Perfetto).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry.events import (
    Event,
    NodeCacheRehydrated,
    RunFinished,
    RunStarted,
    ScanShardRead,
    StageCommitted,
    StageFinished,
    StageQueued,
    StageScheduled,
    StageStarted,
)

__all__ = ["Span", "RunTrace"]


@dataclass
class Span:
    name: str
    #: run | phase | queue | exec | commit | node | scan | rehydrate
    kind: str
    start: float
    end: float
    #: display lane ("run", "stage 3", ...) — the Chrome tid
    lane: str = "run"
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def dur(self) -> float:
        return max(0.0, self.end - self.start)

    def walk(self) -> List["Span"]:
        out = [self]
        for c in self.children:
            out.extend(c.walk())
        return out


def _union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total wall seconds covered by the union of [start, end) intervals."""
    covered = 0.0
    hi = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if hi is None or s > hi:
            covered += e - s
            hi = e
        elif e > hi:
            covered += e - hi
            hi = e
    return covered


@dataclass
class RunTrace:
    run_id: int
    root: Span
    #: stage_id -> {"queue": Span, "exec": Span, "commit": Span?}
    stage_spans: Dict[int, Dict[str, Span]]
    #: stage_id -> parent stage ids (the scheduler's dependency edges)
    stage_parents: Dict[int, List[int]]
    state: str = "SUCCESS"
    events: List[Event] = field(default_factory=list)
    #: stage_id -> the scheduler's admission decision (cost estimate,
    #: critical-path rank, admission wait) — predicted-vs-actual source
    stage_scheduled: Dict[int, StageScheduled] = field(default_factory=dict)

    # ------------------------------------------------------------ assembly
    @classmethod
    def from_events(
        cls, events: Sequence[Event], *, run_id: Optional[int] = None
    ) -> "RunTrace":
        events = sorted(events, key=lambda e: (e.ts, e.seq))
        started = next((e for e in events if isinstance(e, RunStarted)), None)
        finished = next((e for e in events if isinstance(e, RunFinished)), None)
        if not events:
            raise ValueError("cannot build a trace from zero events")
        if run_id is None:
            run_id = next(
                (e.run_id for e in events if e.run_id is not None), -1
            )
        t0 = started.ts if started is not None else events[0].ts
        t1 = finished.ts if finished is not None else events[-1].ts
        state = finished.state if finished is not None else "UNKNOWN"

        root = Span(
            name=f"run {run_id}",
            kind="run",
            start=t0,
            end=max(t1, t0),
            lane="run",
            attrs={
                "state": state,
                "pipeline": started.pipeline if started else "",
                "branch": started.branch if started else "",
            },
        )

        # ---- per-stage event index
        queued: Dict[int, StageQueued] = {}
        scheduled: Dict[int, StageScheduled] = {}
        started_ev: Dict[int, StageStarted] = {}
        finished_ev: Dict[int, StageFinished] = {}
        committed: Dict[int, StageCommitted] = {}
        scans: Dict[Optional[int], List[ScanShardRead]] = {}
        rehydrated: List[NodeCacheRehydrated] = []
        for e in events:
            if isinstance(e, StageQueued):
                queued[e.stage_id] = e
            elif isinstance(e, StageScheduled):
                scheduled[e.stage_id] = e
            elif isinstance(e, StageStarted):
                started_ev[e.stage_id] = e
            elif isinstance(e, StageFinished):
                finished_ev[e.stage_id] = e
            elif isinstance(e, StageCommitted):
                committed[e.stage_id] = e
            elif isinstance(e, ScanShardRead):
                scans.setdefault(e.stage_id, []).append(e)
            elif isinstance(e, NodeCacheRehydrated):
                rehydrated.append(e)

        # ---- phases
        first_queued = min((e.ts for e in queued.values()), default=None)
        plan_end = first_queued
        if plan_end is None:
            plan_end = max((e.ts for e in rehydrated), default=root.end)
        plan = Span(
            name="plan+rehydrate",
            kind="phase",
            start=root.start,
            end=min(max(plan_end, root.start), root.end),
            lane="run",
        )
        for e in rehydrated:
            plan.children.append(
                Span(
                    name=f"rehydrate {e.node}",
                    kind="rehydrate",
                    start=max(root.start, e.ts - e.dur_s),
                    end=e.ts,
                    lane="run",
                    attrs={"node": e.node, "bytes": e.bytes},
                )
            )
        root.children.append(plan)

        # ---- stage lanes
        stage_spans: Dict[int, Dict[str, Span]] = {}
        stage_parents: Dict[int, List[int]] = {}
        last_stage_ts = plan.end
        for sid in sorted(queued):
            q = queued[sid]
            lane = f"stage {sid}"
            stage_parents[sid] = list(q.parents)
            s_ev, f_ev, c_ev = (
                started_ev.get(sid), finished_ev.get(sid), committed.get(sid)
            )
            spans: Dict[str, Span] = {}
            exec_start = s_ev.ts if s_ev is not None else q.ts
            q_attrs: Dict[str, Any] = {"nodes": list(q.nodes)}
            sched = scheduled.get(sid)
            if sched is not None:
                q_attrs.update(
                    est_cost_s=sched.est_cost_s,
                    cost_source=sched.cost_source,
                    cp_weight_s=sched.cp_weight_s,
                    cp_rank=sched.cp_rank,
                    est_memory_gb=sched.est_memory_gb,
                    admission=sched.admission,
                    admission_wait_s=sched.admission_wait_s,
                    warm=sched.warm,
                )
            queue_span = Span(
                name=f"queue stage {sid}",
                kind="queue",
                start=q.ts,
                end=exec_start,
                lane=lane,
                attrs=q_attrs,
            )
            spans["queue"] = queue_span
            root.children.append(queue_span)
            if s_ev is not None:
                exec_end = f_ev.ts if f_ev is not None else root.end
                exec_span = Span(
                    name=f"exec stage {sid}",
                    kind="exec",
                    start=exec_start,
                    end=exec_end,
                    lane=lane,
                    attrs={
                        "nodes": list(q.nodes),
                        "outputs": list(f_ev.outputs) if f_ev else [],
                        "checks": list(f_ev.checks) if f_ev else [],
                        "incomplete": f_ev is None,
                    },
                )
                for scan in scans.get(sid, ()):
                    exec_span.children.append(
                        Span(
                            name=f"scan {scan.table}[{scan.shard_index}]",
                            kind="scan",
                            start=scan.ts,
                            end=scan.ts + scan.dur_s,
                            lane=lane,
                            attrs={
                                "table": scan.table,
                                "rows_in": scan.rows_in,
                                "rows_out": scan.rows_out,
                            },
                        )
                    )
                for node in q.nodes:
                    # fused nodes share the executor window (see module doc)
                    exec_span.children.append(
                        Span(
                            name=f"node {node}",
                            kind="node",
                            start=exec_span.start,
                            end=exec_span.end,
                            lane=lane,
                            attrs={
                                "fused_with": [n for n in q.nodes if n != node]
                            },
                        )
                    )
                spans["exec"] = exec_span
                root.children.append(exec_span)
                last_stage_ts = max(last_stage_ts, exec_span.end)
            if c_ev is not None:
                commit_span = Span(
                    name=f"commit stage {sid}",
                    kind="commit",
                    start=max(root.start, c_ev.ts - c_ev.commit_s),
                    end=c_ev.ts,
                    lane=lane,
                    attrs={"tables": list(c_ev.tables)},
                )
                spans["commit"] = commit_span
                root.children.append(commit_span)
                last_stage_ts = max(last_stage_ts, commit_span.end)
            stage_spans[sid] = spans

        # interactive/query scans carry no stage — attach them to the root
        for scan in scans.get(None, ()):
            root.children.append(
                Span(
                    name=f"scan {scan.table}[{scan.shard_index}]",
                    kind="scan",
                    start=scan.ts,
                    end=scan.ts + scan.dur_s,
                    lane="run",
                    attrs={"table": scan.table, "rows_out": scan.rows_out},
                )
            )

        write = Span(
            name="audit+write",
            kind="phase",
            start=min(max(last_stage_ts, root.start), root.end),
            end=root.end,
            lane="run",
        )
        root.children.append(write)

        return cls(
            run_id=run_id,
            root=root,
            stage_spans=stage_spans,
            stage_parents=stage_parents,
            state=state,
            events=list(events),
            stage_scheduled=scheduled,
        )

    # ------------------------------------------------------------ analysis
    def coverage(self) -> float:
        """Fraction of the run's wall-clock accounted for by child spans
        (the ≥95% acceptance bar: if this drops, some phase of the run
        has gone dark and the trace is lying by omission)."""
        if self.root.dur <= 0.0:
            return 1.0
        intervals = [
            (s.start, s.end) for s in self.root.children
        ]
        return min(1.0, _union_seconds(intervals) / self.root.dur)

    def stage_latency(self, sid: int) -> float:
        """Queue + exec seconds for one stage (commit excluded: commits
        are serialized in stage-id order and overlap later stages)."""
        spans = self.stage_spans.get(sid, {})
        q = spans.get("queue")
        ex = spans.get("exec")
        return (q.dur if q else 0.0) + (ex.dur if ex else 0.0)

    def critical_path(self) -> List[int]:
        """Stage ids on the longest dependency chain by queue+exec time.

        Delegates to the scheduler's own longest-path implementation
        (``repro_torch.core.physical``) fed *observed* stage latencies — the
        table `repro trace` prints and the order Scheduler v2 dispatched
        by come from one algorithm, so they are directly comparable.
        """
        # lazy import: telemetry stays importable without the planner
        from repro_torch.core.physical import critical_path_ids

        costs = {
            sid: self.stage_latency(sid) for sid in self.stage_spans
        }
        if not costs:
            return []
        parents = {
            sid: tuple(
                p for p in self.stage_parents.get(sid, []) if p in costs
            )
            for sid in costs
        }
        return critical_path_ids(costs, parents)

    # ------------------------------------------------------------- reports
    def describe(self) -> str:
        """The ``repro trace`` critical-path table."""
        lines = [
            f"run {self.run_id}: state={self.state} "
            f"wall={self.root.dur * 1e3:.1f}ms coverage={self.coverage():.1%}"
        ]
        crit = set(self.critical_path())
        if self.stage_spans:
            show_sched = bool(self.stage_scheduled)
            header = (
                f"{'stage':>5}  {'queue_ms':>9} {'exec_ms':>9} "
                f"{'commit_ms':>9}  {'crit':>4}"
            )
            if show_sched:
                header += f"  {'est_ms':>8} {'src':>7} {'rank':>4} {'adm':>9}"
            lines.append(header + "  nodes")
            for sid in sorted(self.stage_spans):
                spans = self.stage_spans[sid]
                q = spans.get("queue")
                ex = spans.get("exec")
                co = spans.get("commit")
                nodes = (q.attrs.get("nodes") if q else None) or []
                row = (
                    f"{sid:>5}  "
                    f"{(q.dur if q else 0) * 1e3:>9.1f} "
                    f"{(ex.dur if ex else 0) * 1e3:>9.1f} "
                    f"{(co.dur if co else 0) * 1e3:>9.1f}  "
                    f"{'*' if sid in crit else '':>4}"
                )
                if show_sched:
                    sched = self.stage_scheduled.get(sid)
                    if sched is not None:
                        row += (
                            f"  {sched.est_cost_s * 1e3:>8.1f} "
                            f"{sched.cost_source:>7} {sched.cp_rank:>4} "
                            f"{sched.admission:>9}"
                        )
                    else:
                        row += f"  {'-':>8} {'-':>7} {'-':>4} {'-':>9}"
                lines.append(row + f"  {','.join(nodes)}")
            crit_s = sum(self.stage_latency(s) for s in crit)
            lines.append(
                f"critical path: stages {sorted(crit)} "
                f"({crit_s * 1e3:.1f}ms, {crit_s / max(self.root.dur, 1e-9):.0%} "
                f"of wall)"
            )
            if self.stage_scheduled:
                pred = sum(
                    e.est_cost_s for e in self.stage_scheduled.values()
                )
                actual = sum(
                    (self.stage_spans[s].get("exec").dur
                     if self.stage_spans[s].get("exec") else 0.0)
                    for s in self.stage_scheduled
                    if s in self.stage_spans
                )
                waited = sum(
                    1 for e in self.stage_scheduled.values()
                    if e.admission == "waited"
                )
                sample = next(iter(self.stage_scheduled.values()))
                lines.append(
                    f"scheduler: {sample.schedule} "
                    f"(streaming={'on' if sample.streaming else 'off'}) "
                    f"predicted {pred * 1e3:.1f}ms vs actual "
                    f"{actual * 1e3:.1f}ms exec; "
                    f"{waited} admission wait(s)"
                )
        rehydrate = [
            s for s in self.root.walk() if s.kind == "rehydrate"
        ]
        if rehydrate:
            lines.append(
                f"rehydrated {len(rehydrate)} node(s) from the differential "
                f"cache ({sum(s.attrs.get('bytes', 0) for s in rehydrate)} "
                f"bytes not recomputed)"
            )
        return "\n".join(lines)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``--chrome out.json`` payload).

        Complete ("X") events on one pid (the run id), one tid per lane —
        loadable in chrome://tracing or https://ui.perfetto.dev.
        """
        pid = max(self.run_id, 0)
        lanes: Dict[str, int] = {"run": 0}
        trace_events: List[Dict[str, Any]] = []
        for span in self.root.walk():
            tid = lanes.setdefault(span.lane, len(lanes))
            trace_events.append(
                {
                    "name": span.name,
                    "cat": span.kind,
                    "ph": "X",
                    "ts": span.start * 1e6,  # microseconds
                    "dur": span.dur * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": span.attrs,
                }
            )
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"repro run {self.run_id} [{self.state}]"},
            }
        ] + [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": lane},
            }
            for lane, tid in lanes.items()
        ]
        return {
            "traceEvents": meta + trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "run_id": self.run_id,
                "state": self.state,
                "coverage": self.coverage(),
            },
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome_trace(), fh, indent=1)
