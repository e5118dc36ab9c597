"""The CLI — the paper's primary interaction surface (4.6).

A thin argparse skin over ``repro_torch.Client``: every verb constructs the
platform through the SDK facade (one construction path — the CLI has no
wiring of its own).  Mirrors the two core commands plus the git-like
helpers:

  python -m repro_torch.cli --lake /path/to/lake query -q "SELECT ..." [-b branch]
  python -m repro_torch.cli --lake ... run pipeline_module.py [-b branch]
                                      [--no-fusion] [--run-id N --replay]
                                      [--parallelism N] [--no-cache]
                                      [--schedule critical_path|stage_id]
                                      [--streaming | --no-streaming]
                                      [--preflight]
  python -m repro_torch.cli --lake ... lint pipeline_module.py [-b branch]
                                      [--strict] [--json PATH]
  python -m repro_torch.cli --lake ... explain (pipeline_module.py | -q SQL)
                                      [-b branch] [--engine auto|kernel|jnp]
                                      [--json PATH]
  python -m repro_torch.cli --lake ... branch [--create NAME] [--from BASE]
  python -m repro_torch.cli --lake ... log [-b branch]
  python -m repro_torch.cli --lake ... tables [-b branch]

plus the lakekeeper maintenance verbs (repro_torch.maintenance):

  python -m repro_torch.cli --lake ... gc [--dry-run] [--history N] [--grace S]
                                      [--runlog-ttl S]
  python -m repro_torch.cli --lake ... compact [TABLE] [-b branch]
                                      [--target-rows N] [--dry-run]
  python -m repro_torch.cli --lake ... cache {prune,stats}
                                      [--max-bytes N] [--ttl S] [--dry-run]

and the observability verbs (repro_torch.telemetry):

  python -m repro_torch.cli --lake ... trace RUN_ID [--chrome out.json]
  python -m repro_torch.cli --lake ... events [--follow] [--run-id N] [--limit N]

A pipeline module is a plain Python file — either the decorator SDK
(``@repro_torch.model()`` / ``@repro_torch.expectation()`` / ``repro_torch.sql``) or the
legacy ``PIPELINE = repro_torch.Pipeline(...)`` global ("code in the IDE of
choice").

Every verb runs on the card.  Without a CUDA device the CLI exits
non-zero with the reason; the global ``--device cpu`` runs it on the CPU
(``python -m repro_torch.cli --device cpu --lake ... query -q ...``).
"""
from __future__ import annotations

import argparse

from repro_torch.api import Client, LintFailed, RunState, resolve_pipeline
from repro_torch.runtime import ExecutorConfig
from repro_torch.utils.device import resolve_device


def _print_table(rows: dict, *, limit: int = 20) -> None:
    names = list(rows)
    if not names:
        print("(empty)")
        return
    n = len(rows[names[0]])
    widths = {c: max(len(c), 12) for c in names}
    print(" | ".join(c.ljust(widths[c]) for c in names))
    print("-+-".join("-" * widths[c] for c in names))
    for i in range(min(n, limit)):
        print(" | ".join(str(rows[c][i]).ljust(widths[c]) for c in names))
    if n > limit:
        print(f"... ({n - limit} more rows)")


def _format_event(event) -> str:
    """One spool event as one log line: time, kind, run, detail fields."""
    import time as _time

    d = event.to_json_dict()
    stamp = _time.strftime("%H:%M:%S", _time.localtime(d.pop("ts", 0.0)))
    kind = d.pop("kind", "Event")
    run = d.pop("run_id", None)
    d.pop("seq", None)
    detail = " ".join(
        f"{k}={v}" for k, v in sorted(d.items()) if v not in (None, [], "")
    )
    run_s = f"run={run} " if run is not None else ""
    return f"{stamp} {kind:<20} {run_s}{detail}"


def _run_summary_json(res) -> dict:
    """The ``repro run --json`` payload (machine-readable run summary)."""
    stats = res.stats or {}
    return {
        "run_id": res.run_id,
        "state": str(res.state),
        "branch": res.branch,
        "merged_commit": res.merged_commit,
        "artifacts": dict(res.artifacts),
        "checks": dict(res.checks),
        "failed_checks": res.failed_checks,
        "wall_s": stats.get("wall_s"),
        "parallelism": stats.get("parallelism"),
        # Scheduler v2 stats: ordering mode, streaming, per-stage cost
        # estimates / critical-path ranks / admission waits, and the
        # model's predicted critical path (stage ids)
        "scheduler": stats.get("scheduler", {}),
        "stage_timings": stats.get("stage_timings", {}),
        "cache": stats.get("cache", {}),
        "io": stats.get("io", {}),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.cli")
    ap.add_argument("--lake", required=True, help="lake root directory")
    ap.add_argument("--device", default=None,
                    help="where queries and stages run (default: cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    q = sub.add_parser("query", help="synchronous SQL against an artifact")
    q.add_argument("-q", "--sql", required=True)
    q.add_argument("-b", "--branch", default=None)
    q.add_argument("--commit", default=None, help="time travel to a commit")

    r = sub.add_parser("run", help="execute a pipeline (transform-audit-write)")
    r.add_argument("pipeline", help="python file: decorator SDK or PIPELINE global")
    r.add_argument("-b", "--branch", default="main")
    r.add_argument("--no-fusion", action="store_true")
    r.add_argument("--replay", action="store_true")
    r.add_argument("--run-id", type=int, default=None)
    r.add_argument(
        "--parallelism", type=int, default=None, metavar="N",
        help="max independent stages in flight at once (wave scheduler; "
        "default: executor max_concurrent_stages). Results are "
        "byte-identical at every level — this is a throughput knob, "
        "never a semantics knob",
    )
    r.add_argument(
        "--schedule", choices=("critical_path", "stage_id"),
        default="critical_path",
        help="ready-stage dispatch order: critical_path pops the stage "
        "heading the longest cost-weighted path to a sink (cost model: "
        "persisted latency medians, bytes-scanned fallback); stage_id is "
        "the legacy ascending order. Dispatch order only — artifacts are "
        "byte-identical either way",
    )
    r.add_argument(
        "--streaming",
        action=argparse.BooleanOptionalAction,
        default=None,
        help="unblock downstream stages as soon as upstream outputs exist "
        "in memory (before artifact writes land) and drive scans through "
        "the incremental shard iterator; default: on under critical_path, "
        "off under stage_id. Audits and commits keep the stage barrier",
    )
    r.add_argument(
        "--preflight", action="store_true",
        help="lint the pipeline first and refuse to launch on any "
        "error-severity finding (repro lint, wired into run)",
    )
    r.add_argument(
        "--json", action="store_true", dest="json_out",
        help="print a machine-readable run summary (state, per-stage "
        "queue/exec/commit timings, cache hit counts, io deltas) "
        "instead of the human lines",
    )
    r.add_argument(
        "--cache",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="plan around the node-granular differential cache: unchanged "
        "logical nodes restore from the object store or are elided "
        "entirely, whatever the fusion config (this is the default — the "
        "fast path is the default path; --no-cache forces a full "
        "recompute and persists nothing)",
    )

    li = sub.add_parser(
        "lint", help="static preflight: lineage, cache-poison, diagnostics"
    )
    li.add_argument(
        "pipeline", help="python file: decorator SDK or PIPELINE global"
    )
    li.add_argument("-b", "--branch", default="main",
                    help="branch whose table schemas ground the checks")
    li.add_argument("--strict", action="store_true",
                    help="warnings also fail the lint (exit 1)")
    li.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full report as JSON to PATH")

    ex = sub.add_parser(
        "explain", help="static plan explainability: scans, pushdown, "
        "kernel-vs-jnp route trace, typed checks — executes nothing"
    )
    ex.add_argument("pipeline", nargs="?", default=None,
                    help="python file: decorator SDK or PIPELINE global")
    ex.add_argument("-q", "--sql", default=None,
                    help="explain one interactive SQL query instead")
    ex.add_argument("-b", "--branch", default="main")
    ex.add_argument("--engine", default="auto",
                    choices=("auto", "kernel", "jnp"),
                    help="engine to explain the route for (matches the "
                    "query/run engine flag)")
    ex.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full explanation as JSON to PATH")

    b = sub.add_parser("branch", help="list/create branches")
    b.add_argument("--create", default=None)
    b.add_argument("--from", dest="from_branch", default=None)

    lg = sub.add_parser("log", help="commit log")
    lg.add_argument("-b", "--branch", default="main")

    t = sub.add_parser("tables", help="tables at a branch head")
    t.add_argument("-b", "--branch", default="main")

    g = sub.add_parser("gc", help="mark-and-sweep unreachable objects")
    g.add_argument("--dry-run", action="store_true",
                   help="report reclaimable garbage without deleting")
    g.add_argument("--history", type=int, default=None,
                   help="keep only the last N commits per branch "
                   "(snapshot expiry; default keeps all history)")
    g.add_argument("--grace", type=float, default=900.0, metavar="S",
                   help="never sweep objects younger than S seconds "
                   "(protects in-flight runs; default 900)")
    g.add_argument("--pin-ttl", type=float, default=86400.0, metavar="S",
                   help="ignore run pins older than S seconds "
                   "(leaked by crashed runs; default 1 day)")
    g.add_argument("--latency-ttl", type=float, default=30 * 86400.0,
                   metavar="S",
                   help="drop speculation latency baselines not refreshed "
                   "for S seconds (stale code fingerprints; default 30 days)")
    g.add_argument("--runlog-ttl", type=float, default=14 * 86400.0,
                   metavar="S",
                   help="retention window for persisted run traces: traces "
                   "older than S seconds are swept — ref and blob in one "
                   "pass (default 14 days)")

    co = sub.add_parser("compact", help="merge small shards into larger ones")
    co.add_argument("table", nargs="?", default=None,
                    help="table to compact (default: every table)")
    co.add_argument("-b", "--branch", default="main")
    co.add_argument("--target-rows", type=int, default=None,
                    help="rows per output shard (default: format shard_rows)")
    co.add_argument("--min-fill", type=float, default=0.5,
                    help="shards below min_fill*target are merge candidates")
    co.add_argument("--dry-run", action="store_true")

    ca = sub.add_parser("cache", help="differential-cache maintenance")
    ca_sub = ca.add_subparsers(dest="cache_cmd", required=True)
    cp = ca_sub.add_parser("prune", help="evict entries by LRU/TTL policy")
    cp.add_argument("--max-bytes", type=int, default=None,
                    help="byte budget for summed entry output_bytes")
    cp.add_argument("--ttl", type=float, default=None, metavar="S",
                    help="evict entries not used for S seconds")
    cp.add_argument("--dry-run", action="store_true")
    ca_sub.add_parser("stats", help="registry size and entry listing")

    tr = sub.add_parser(
        "trace", help="a recorded run's trace: critical-path table, "
        "queue/exec/commit breakdown, Chrome-trace export"
    )
    tr.add_argument("run_id", type=int)
    tr.add_argument("--chrome", default=None, metavar="PATH",
                    help="also export Chrome trace-event JSON to PATH "
                    "(open in chrome://tracing or ui.perfetto.dev)")

    ev = sub.add_parser(
        "events", help="the lake's telemetry event stream (spool file)"
    )
    ev.add_argument("--follow", action="store_true",
                    help="tail the spool live (works across processes — "
                    "a run in another shell shows up here); Ctrl-C stops")
    ev.add_argument("--run-id", type=int, default=None,
                    help="only events of this run")
    ev.add_argument("--limit", type=int, default=None,
                    help="only the last N events (non-follow mode)")

    args = ap.parse_args(argv)

    # --parallelism N widens the whole fleet: N stages in flight needs at
    # least N containers for their stage functions (plus headroom for
    # speculation backups and parallel shard reads)
    executor_config = None
    parallelism = getattr(args, "parallelism", None)
    if parallelism is not None:
        if parallelism < 1:
            raise SystemExit(f"--parallelism must be >= 1 (got {parallelism})")
        executor_config = ExecutorConfig(
            max_workers=max(4, parallelism),
            max_concurrent_stages=parallelism,
        )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (on the command line: --device cpu)")

    with Client(
        args.lake, executor_config=executor_config, device=device
    ) as client:
        if args.cmd == "branch":
            if args.create:
                client.create_branch(args.create, from_branch=args.from_branch)
                print(f"created branch {args.create!r}")
            for name in client.branches():
                print(name)
            return

        if args.cmd == "log":
            for c in client.log(args.branch):
                print(f"{c.commit_id[:12]}  {c.author:<8} {c.message}")
            return

        if args.cmd == "tables":
            for name, key in sorted(client.tables(args.branch).items()):
                snap = client.fmt.load_snapshot(key)
                print(f"{name:<32} {snap.num_rows:>10} rows  {key[:12]}")
            return

        if args.cmd == "gc":
            if args.history is not None and args.history < 1:
                raise SystemExit(
                    f"--history must be >= 1 (got {args.history}): history=N "
                    "keeps the last N commits per branch, 0 would keep nothing"
                )
            report = client.gc(
                history=args.history, grace_s=args.grace,
                pin_ttl_s=args.pin_ttl, latency_ttl_s=args.latency_ttl,
                runlog_ttl_s=args.runlog_ttl,
                dry_run=args.dry_run,
            )
            print(report.describe())
            return

        if args.cmd == "trace":
            try:
                trace = client.trace(args.run_id)
            except KeyError as e:
                raise SystemExit(str(e))
            print(trace.describe())
            if args.chrome:
                trace.write_chrome_trace(args.chrome)
                print(f"chrome trace written to {args.chrome} "
                      f"(open in chrome://tracing or ui.perfetto.dev)")
            return

        if args.cmd == "events":
            from repro_torch.api.client import SPOOL_RELPATH
            from repro_torch.telemetry.bus import follow_spool

            spool = client.path / SPOOL_RELPATH
            if args.follow:
                try:
                    for event in follow_spool(spool, run_id=args.run_id):
                        print(_format_event(event))
                except KeyboardInterrupt:
                    pass
            else:
                events = client.events(run_id=args.run_id)
                if args.limit:
                    events = events[-args.limit:]
                for event in events:
                    print(_format_event(event))
            return

        if args.cmd == "compact":
            reports = client.compact(
                args.table, branch=args.branch,
                target_rows=args.target_rows, min_fill=args.min_fill,
                dry_run=args.dry_run,
            )
            for report in reports:
                print(report.describe())
            print(f"shards merged (lifetime): "
                  f"{client.store.stats.compact_shards_merged}")
            return

        if args.cmd == "cache":
            if args.cache_cmd == "prune":
                report = client.cache.prune(
                    max_bytes=args.max_bytes, ttl_s=args.ttl,
                    dry_run=args.dry_run,
                )
                print(report.describe())
            else:  # stats
                stats = client.cache.stats()
                print(f"{stats['entries']} entries, "
                      f"{stats['total_bytes']} bytes")
                for fp, e in sorted(
                    stats["items"].items(), key=lambda kv: kv[1].last_used_at
                ):
                    label = e.node or ",".join(sorted({*e.outputs, *e.checks}))
                    print(
                        f"{fp[:16]}  {e.kind:<8} node={label:<24} "
                        f"run={e.run_id:<4} bytes={e.output_bytes:<10} "
                        f"outputs={sorted(e.outputs)}"
                    )
            return

        if args.cmd == "lint":
            report = client.lint(args.pipeline, branch=args.branch)
            print(report.describe())
            if args.json:
                import json

                with open(args.json, "w") as fh:
                    json.dump(report.to_json_dict(), fh, indent=2)
                print(f"json report written to {args.json}")
            if not report.ok(strict=args.strict):
                raise SystemExit(1)
            print("preflight clean — pipeline is clear to run")
            return

        if args.cmd == "explain":
            if (args.sql is None) == (args.pipeline is None):
                raise SystemExit(
                    "explain takes exactly one target: a pipeline file, "
                    "or -q SQL"
                )
            target = args.sql if args.sql is not None else args.pipeline
            explanation = client.explain(
                target, branch=args.branch, engine=args.engine
            )
            print(explanation.describe())
            if args.json:
                import json

                with open(args.json, "w") as fh:
                    json.dump(explanation.to_json_dict(), fh, indent=2)
                print(f"json explanation written to {args.json}")
            # pipeline mode gates on lint errors like `repro lint`; SQL
            # mode always exits 0 — a predicted RouteError IS the product
            if hasattr(explanation, "report") and not explanation.report.ok():
                raise SystemExit(1)
            return

        if args.cmd == "query":
            out = client.query(
                args.sql, branch=args.branch, commit_id=args.commit
            )
            _print_table(out)
            return

        # run / replay
        pipeline = resolve_pipeline(args.pipeline)
        if args.replay:
            if args.run_id is None:
                raise SystemExit("--replay needs --run-id")
            res = client.replay(args.run_id, pipeline)
            print(f"replayed run {args.run_id} as {res.run_id}: "
                  f"artifacts={sorted(res.artifacts)}")
            return
        try:
            res = client.run(
                pipeline, branch=args.branch, fusion=not args.no_fusion,
                pushdown=not args.no_fusion, cache=args.cache,
                parallelism=parallelism, preflight=args.preflight,
                schedule=args.schedule, streaming=args.streaming,
            )
        except LintFailed as e:
            print(e.report.describe())
            raise SystemExit(f"PREFLIGHT FAILED: {e}")
        if args.json_out:
            import json

            print(json.dumps(_run_summary_json(res), indent=2, default=str))
            if res.state is RunState.AUDIT_FAILED:
                raise SystemExit(2)
            return
        if res.state is RunState.AUDIT_FAILED:
            raise SystemExit(
                f"AUDIT FAILED: expectations failed: {res.failed_checks} "
                f"— run {res.run_id} rolled back"
            )
        print(f"run {res.run_id} merged to {args.branch!r} "
              f"@ {res.merged_commit[:12]}")
        print(f"artifacts: {sorted(res.artifacts)}  checks: {res.checks}")
        sched = res.stats.get("scheduler", {})
        print(f"wall: {res.stats['wall_s']:.2f}s  "
              f"parallelism: {res.stats.get('parallelism', 1)}  "
              f"io: {res.stats['io']}")
        if sched:
            print(
                f"scheduler: {sched.get('schedule')} "
                f"(streaming={'on' if sched.get('streaming') else 'off'})  "
                f"critical path: {sched.get('critical_path')}  "
                f"admission waits: {sched.get('admission_waits', 0)}"
            )
        cache = res.cache
        if cache.get("enabled"):
            total = cache["hits"] + cache["nodes_executed"]
            print(
                f"cache: {cache['hits']}/{total} nodes hit "
                f"({cache['rehydrated']} rehydrated, {cache['elided']} "
                f"elided), {cache['nodes_executed']} executed, "
                f"{cache['bytes_saved']} bytes saved"
            )


if __name__ == "__main__":
    main()
