"""Telemetry, ``repro_torch.telemetry``, against ``repro.telemetry``: the
event bus, the metrics registry and run tracing (``RunTrace``).

Traces are compared by structure, never by times: span kinds, names,
lanes and parents, the stage and node ids on them, the dependency edges,
and which stages lie on the critical path where the DAG leaves no
choice.  Event streams are compared as multisets once timestamps,
sequence numbers and durations are stripped (the reference's own
normalisation).  Each case runs one scenario through both packages'
``Client`` on lakes of their own (the port with ``device="cpu"``), and
keeps the reference test's own assertions, applied to the port.

Mirrored: ``test_telemetry.py`` without its CLI cases, which are in
``test_torch_cli.py``.
"""
import json

import pytest
import torch

from repro.core.physical import critical_path_ids as ref_critical_path_ids
from repro_torch.core.physical import critical_path_ids as port_critical_path_ids
from tests.torch_parity import BOTH, PORT, both, fanout_pipeline, handle_summary, parity

torch.set_num_threads(1)

N_ROWS = 2_000

#: the reference's normalisation: every timing-dependent field goes
_TIMING_FIELDS = {
    "ts", "seq", "wall_s", "exec_s", "commit_s", "dur_s",
    "baseline_s", "deadline_s", "admission_wait_s", "admission", "warm",
}
_TIMER_KINDS = {"SpeculationArmed", "SpeculationFired", "SpeculationWon"}


def _client(pkg, parallelism=4, **kw):
    return pkg.ephemeral(
        shard_rows=512,
        executor_config=pkg.ExecutorConfig(max_workers=8, max_concurrent_stages=parallelism),
        **kw,
    )


def _write_taxi(pkg, client, seed=7):
    pkg.seed_taxi(client, N_ROWS, seed=seed)


def _normalize(events, drop=()):
    out = []
    for e in events:
        d = e.to_json_dict()
        if d["kind"] in _TIMER_KINDS:
            continue
        for f in _TIMING_FIELDS | set(drop):
            d.pop(f, None)
        out.append(json.dumps(d, sort_keys=True))
    return sorted(out)


def trace_structure(trace):
    """A trace without its times: every span as (kind, name, lane,
    parent), the stage lanes, dependency edges and the state."""
    spans = []

    def visit(span, parent):
        attrs = {k: v for k, v in span.attrs.items() if k in ("nodes", "stage", "node", "table", "fused_with")}
        spans.append((span.kind, span.name, span.lane, parent, json.dumps(attrs, sort_keys=True, default=str)))
        for c in span.children:
            visit(c, span.name)

    visit(trace.root, None)
    return {
        "run_id": trace.run_id,
        "state": trace.state,
        "spans": sorted(spans),
        "stage_spans": {sid: sorted(s) for sid, s in sorted(trace.stage_spans.items())},
        "stage_parents": {sid: sorted(ps) for sid, ps in sorted(trace.stage_parents.items())},
        "scheduled": sorted(trace.stage_scheduled),
    }


# --------------------------------------------------------------- event bus
def _bus(pkg, path):
    T = pkg.telemetry
    bus = T.EventBus()
    slow, fast = bus.subscribe(maxlen=4), bus.subscribe(maxlen=100)
    for i in range(10):
        bus.publish(T.StageQueued(run_id=1, stage_id=i))
    kept = [e.stage_id for e in slow.poll()]
    assert kept == [6, 7, 8, 9] and slow.dropped == 6
    assert len(fast.poll()) == 10 and fast.dropped == 0
    stats = bus.stats()
    assert stats["published"] == 10 and stats["dropped"] == 6
    slow.close()
    assert bus.stats()["subscribers"] == 1

    bus = T.EventBus()
    sub = bus.subscribe()
    for run_id in (1, 2, 1, None, 2, 1, None):
        bus.publish(T.StageQueued(run_id=run_id))
    by_scope = {}
    for e in sub.poll():
        by_scope.setdefault(e.run_id, []).append(e.seq)
    assert by_scope == {1: [1, 2, 3], 2: [1, 2], None: [1, 2]}

    for kind, cls in T.EVENT_TYPES.items():
        back = T.event_from_json_dict(cls(run_id=3).to_json_dict())
        assert type(back) is cls and back.run_id == 3
    degraded = T.event_from_json_dict({"kind": "FromTheFuture", "run_id": 9, "novel_field": 1})
    assert type(degraded).__name__ == "Event" and degraded.run_id == 9
    known = T.event_from_json_dict({"kind": "RunFinished", "state": "ERROR", "novel_field": 1})
    assert isinstance(known, T.RunFinished) and known.state == "ERROR"

    spool = path / "events.jsonl"
    sbus = T.EventBus(spool_path=spool, spool_max_bytes=600)
    for i in range(12):
        sbus.publish(T.ScanShardRead(run_id=i % 2, shard_index=i))
    sbus.close()
    assert spool.with_name(spool.name + ".1").exists()
    got = [e.shard_index for e in T.read_spool(spool)]
    assert got == list(range(12))[-len(got):] and got[-1] == 11
    only_run1 = [e.shard_index for e in T.read_spool(spool, run_id=1)]
    assert only_run1 == [i for i in got if i % 2 == 1]
    assert len(T.read_spool(spool, limit=2)) == 2
    fields = {k: sorted(cls(run_id=1).to_json_dict()) for k, cls in T.EVENT_TYPES.items()}
    return kept, stats, by_scope, fields, got, only_run1


def test_event_bus_schema_and_spool(tmp_path):
    """Drop accounting, per-run sequence numbers, the JSON round trip of
    every event kind (with the same fields in both packages), and the
    spool's rotation and filtering."""
    parity(_bus, tmp_path)


def _metrics(pkg, path):
    m = pkg.telemetry.MetricsRegistry()
    m.counter("executor.tasks").inc()
    m.counter("executor.tasks").inc(4)
    m.gauge("pool.size").set(8)
    for v in range(100):
        m.histogram("lat").observe(float(v))
    snap = m.snapshot()
    assert snap["counters"]["executor.tasks"] == 5 and snap["gauges"]["pool.size"] == 8
    hist = snap["histograms"]["lat"]
    assert hist["count"] == 100 and hist["max"] == 99.0
    assert hist["p50"] == pytest.approx(49.5, abs=2.0)
    return snap


def test_metrics_registry_counters_gauges_histograms(tmp_path):
    parity(_metrics, tmp_path)


# ----------------------------------------------- determinism across knobs
def _event_sets(pkg, path):
    normalized = {}
    for p in (1, 2, 8):
        with _client(pkg, p) as client:
            _write_taxi(pkg, client)
            handle = client.run(fanout_pipeline(pkg), fusion=False, pushdown=False,
                                parallelism=p).raise_for_state()
            normalized[p] = _normalize(client.runlog.get(handle.run_id))
    assert len(normalized[1]) > 10
    assert normalized[2] == normalized[1] and normalized[8] == normalized[1]
    # the fan-out's Python nodes are each package's own code, so their
    # cache fingerprints differ between the packages
    return sorted(x for x in normalized[1] if '"fingerprint"' not in x), [
        json.loads(x)["kind"] for x in normalized[1]]


def test_event_set_is_parallelism_invariant_and_equals_the_reference(tmp_path):
    parity(_event_sets, tmp_path)


# ------------------------------------------------------------ span nesting
def _spans_nest(pkg, path):
    with _client(pkg, 8) as client:
        _write_taxi(pkg, client)
        handle = client.run(fanout_pipeline(pkg), fusion=False, pushdown=False,
                            parallelism=8).raise_for_state()
        trace = handle.trace()
    root = trace.root
    assert root.kind == "run" and trace.state == "SUCCESS"
    eps = 0.05
    for span in root.walk():
        assert root.start - eps <= span.start <= span.end <= root.end + eps
    for sid, spans in trace.stage_spans.items():
        q, ex = spans["queue"], spans["exec"]
        assert q.end == ex.start
        for child in ex.children:
            assert child.kind in ("scan", "node")
            assert ex.start - eps <= child.start and child.end <= ex.end + eps
        nodes = {c.name for c in ex.children if c.kind == "node"}
        assert nodes == {f"node {n}" for n in q.attrs["nodes"]}
    assert any(len(ps) >= 2 for ps in trace.stage_parents.values())
    cp = trace.critical_path()
    assert cp
    parents = {s: set(ps) for s, ps in trace.stage_parents.items()}
    for a, b in zip(cp, cp[1:]):
        assert a in parents.get(b, set())
    assert trace.coverage() >= 0.90
    chrome = trace.to_chrome_trace()
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert f"run {trace.run_id}" in {e["name"] for e in xs}
    assert all({"name", "ph", "ts", "dur", "pid", "tid"} <= set(e) for e in xs)
    return trace_structure(trace), sorted((e["name"], e["tid"]) for e in xs), chrome["otherData"]["state"]


def test_trace_spans_nest_and_have_the_reference_structure(tmp_path):
    parity(_spans_nest, tmp_path)


def _chain_critical_path(pkg, path):
    """The unfused Appendix pipeline: stage 0 (trips) feeds two leaves,
    the expectation (1) and pickups (2).  Which leaf takes longer is the
    host's timing, so the scenario returns each stage's observed latency
    beside the critical path."""
    with _client(pkg) as client:
        _write_taxi(pkg, client)
        h = client.run(pkg.build_taxi_pipeline(), fusion=False, pushdown=False).raise_for_state()
        trace = client.trace(h.run_id)
        assert "critical path" in trace.describe()
        latencies = {sid: trace.stage_latency(sid) for sid in trace.stage_spans}
        return trace_structure(trace), trace.critical_path(), latencies, handle_summary(h)


def test_chain_critical_path_equals_the_reference(tmp_path):
    """Structures and handles equal; each package's critical path is the
    reference's longest path over that package's own latencies, and the
    port's longest path equals the reference's on the reference's
    latencies and with either leaf made the longer one."""
    (js, jcp, jlat, jh), (ts, tcp, tlat, th) = both(_chain_critical_path, tmp_path)
    assert (ts, th) == (js, jh)
    assert sorted(jlat) == sorted(tlat) == [0, 1, 2]
    parents = {sid: tuple(p for p in js["stage_parents"].get(sid, []) if p in jlat)
               for sid in jlat}
    assert parents == {0: (), 1: (0,), 2: (0,)}
    assert jcp == ref_critical_path_ids(jlat, parents)
    assert tcp == ref_critical_path_ids(tlat, parents)
    assert port_critical_path_ids(jlat, parents) == jcp
    for leaf in (1, 2):
        slower = {**jlat, leaf: max(jlat.values()) + 1.0}
        assert (port_critical_path_ids(slower, parents) == ref_critical_path_ids(slower, parents)
                == [0, leaf])


def _warm_rehydrate(pkg, path):
    with _client(pkg) as client:
        _write_taxi(pkg, client)
        p = fanout_pipeline(pkg)
        client.run(p, fusion=False, pushdown=False).raise_for_state()
        warm = client.run(p, fusion=False, pushdown=False).raise_for_state()
        assert warm.cache["rehydrated"] >= 1
        trace = warm.trace()
    rehydrate = [s for s in trace.root.walk() if s.kind == "rehydrate"]
    assert len(rehydrate) == warm.cache["rehydrated"]
    assert all(s.attrs["bytes"] > 0 for s in rehydrate)
    assert trace.coverage() >= 0.95
    return trace_structure(trace), sorted((s.name, s.attrs["bytes"]) for s in rehydrate), warm.cache


def test_warm_run_traces_as_rehydrate_spans(tmp_path):
    parity(_warm_rehydrate, tmp_path)


# ------------------------------------------------------- failure semantics
def _audit_failure(pkg, path):
    with _client(pkg, 8) as client:
        _write_taxi(pkg, client)
        handle = client.run(fanout_pipeline(pkg, 10_000.0), fusion=False, pushdown=False,
                            parallelism=8, raise_errors=False)
        assert handle.state is pkg.RunState.AUDIT_FAILED
        events = client.runlog.get(handle.run_id)
        trace = handle.trace()
    finished = [e for e in events if isinstance(e, pkg.telemetry.RunFinished)]
    assert len(finished) == 1 and finished[0].state == "AUDIT_FAILED"
    assert finished[0].failed_checks == ["trips_expectation"]
    assert trace.state == "AUDIT_FAILED"
    return _normalize(events, drop=("fingerprint",)), trace.state


def _infra_error(pkg, path):
    with _client(pkg, 2) as client:
        p = pkg.Pipeline("missing_source")
        p.sql("x", "SELECT pickup_at FROM no_such_table")
        handle = client.run(p, raise_errors=False)
        assert handle.state is pkg.RunState.ERROR and handle.run_id > 0
        events = client.runlog.get(handle.run_id)
        assert handle.trace().state == "ERROR"
    finished = [e for e in events if isinstance(e, pkg.telemetry.RunFinished)]
    assert len(finished) == 1 and finished[0].state == "ERROR"
    return [e.kind for e in events], handle.run_id


@pytest.mark.parametrize("case", [_audit_failure, _infra_error], ids=["audit_failure", "infra_error"])
def test_failed_runs_still_emit_run_finished(tmp_path, case):
    parity(case, tmp_path)


def _telemetry_off(pkg, path):
    with pkg.ephemeral(telemetry=False) as client:
        _write_taxi(pkg, client)
        handle = client.run(fanout_pipeline(pkg), fusion=False, pushdown=False).raise_for_state()
        assert client.bus is None
        with pytest.raises(RuntimeError):
            client.events(follow=True)
        assert not client.runlog.has(handle.run_id)
        return dict(sorted(handle.artifacts.items())), handle.checks


def test_telemetry_off_is_supported_and_runs_still_work(tmp_path):
    parity(_telemetry_off, tmp_path)


def _query_events(pkg, path):
    with _client(pkg, 2) as client:
        _write_taxi(pkg, client)
        sub = client.events(follow=True)
        rows = client.query("SELECT COUNT(*) AS n FROM taxi_table")
        assert int(rows["n"][0]) == N_ROWS
        events = sub.poll()
        sub.close()
    scans = [e for e in events if e.kind == "ScanShardRead"]
    queries = [e for e in events if e.kind == "QueryExecuted"]
    assert scans and all(s.source == "query" for s in scans)
    assert len(queries) == 1 and queries[0].table == "taxi_table"
    assert queries[0].shards_read == len(scans)
    q = queries[0]
    return len(scans), (q.table, q.shards_read, q.engine_path)


def test_query_emits_scan_and_query_events(tmp_path):
    parity(_query_events, tmp_path)


# ------------------------------------------------------------- runlog GC
def _runlog_gc(pkg, path):
    with _client(pkg, 2) as client:
        _write_taxi(pkg, client)
        p = fanout_pipeline(pkg)
        old = client.run(p, fusion=False, pushdown=False).raise_for_state()
        live = client.run(p, fusion=False, pushdown=False).raise_for_state()
        ref = client.store.get_ref("runlog", f"run_{old.run_id}")
        ref["created_at"] -= 30 * 86400.0
        client.store.set_ref("runlog", f"run_{old.run_id}", ref)
        old_blob = ref["blob"]
        live_blob = client.store.get_ref("runlog", f"run_{live.run_id}")["blob"]
        dry = client.gc(runlog_ttl_s=7 * 86400.0, grace_s=0.0, dry_run=True)
        assert dry.swept_runlog_refs == 1 and client.runlog.has(old.run_id)
        real = client.gc(runlog_ttl_s=7 * 86400.0, grace_s=0.0)
        assert real.swept_runlog_refs == 1 and not client.runlog.has(old.run_id)
        with pytest.raises(KeyError):
            client.runlog.get(old.run_id)
        assert not client.store.exists(old_blob) and client.store.exists(live_blob)
        assert client.trace(live.run_id).state == "SUCCESS"
        kept = client.gc(runlog_ttl_s=None, grace_s=0.0)
        assert kept.swept_runlog_refs == 0 and client.runlog.has(live.run_id)
        return [(r.swept_runlog_refs, r.dry_run) for r in (dry, real, kept)]


def test_runlog_gc_ttl_sweeps_expired_keeps_live(tmp_path):
    parity(_runlog_gc, tmp_path)


def test_traces_of_one_run_read_back_across_packages(tmp_path):
    """A trace the port persisted loads in the JAX package's RunTrace, and
    the other way round, to the same structure."""
    out = {}
    for writer in BOTH:
        with _client(writer) as client:
            _write_taxi(writer, client)
            h = client.run(writer.build_taxi_pipeline(), fusion=False, pushdown=False).raise_for_state()
            events = client.runlog.get(h.run_id)
            jsons = [e.to_json_dict() for e in events]
        out[writer.name] = [
            trace_structure(reader.telemetry.RunTrace.from_events(
                [reader.telemetry.event_from_json_dict(d) for d in jsons], run_id=h.run_id))
            for reader in BOTH
        ]
    for structures in out.values():
        assert structures[0] == structures[1]
    assert out["repro"][0] == out[PORT.name][0]
