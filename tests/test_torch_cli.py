"""The CLI, ``python -m repro_torch.cli``, against ``python -m repro.cli``.

Each case writes the same seeded lake and the same pipeline file (one
template, each package's import line, a directory each) and runs the
same verbs through both CLIs in process (the port with ``--device
cpu``).  Exit codes and stdout must be equal once times are masked
(seconds, and clock times in event lines); where a verb prints a
wall-clock-hashed commit id, those are masked too.  The ``--json`` run
summary is compared key by key, its timings aside.  Each case keeps the
reference test's own assertions, applied to the port.

Mirrored: ``test_cli.py`` and the CLI cases of ``test_telemetry.py``.
The maintenance verbs are in ``test_torch_maintenance.py``, ``lint`` and
``explain`` in ``test_torch_analysis.py``.  On top: the port's CLI as a
process, the way a user runs it.
"""
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from tests.torch_parity import PORT, mask_commits, mask_seconds, parity

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

PIPELINE_SRC = '''
PIPELINE = repro.Pipeline("cli_demo")
PIPELINE.sql(
    "trips",
    "SELECT pickup_location_id, passenger_count as count FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01'",
)

@PIPELINE.python
def trips_expectation(ctx, trips):
    return trips.mean("count") > 1.0

PIPELINE.sql(
    "pickups",
    "SELECT pickup_location_id, COUNT(*) AS counts FROM trips "
    "GROUP BY pickup_location_id ORDER BY counts DESC",
)
'''

TELEMETRY_SRC = '''
PIPELINE = repro.Pipeline("cli_telemetry")
PIPELINE.sql(
    "trips",
    "SELECT pickup_location_id, passenger_count as count FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01'",
)

@PIPELINE.python
def trips_expectation(ctx, trips):
    return trips.mean("count") > 1.0
'''


def _lake(pkg, path, src=PIPELINE_SRC, n=500):
    root = path / "lake"
    store = pkg.io.ObjectStore(root)
    fmt = pkg.table.TableFormat(store)
    snap = fmt.write("taxi_table", pkg.TAXI_SCHEMA, pkg.make_taxi_data(n, np.random.default_rng(0)))
    pkg.catalog.Catalog(store).commit("main", {"taxi_table": fmt.manifest_key(snap)})
    return root, pkg.write_pipeline(path, "pipeline.py", src)


def _cli_verbs(pkg, path, *verbs):
    """Run CLI verbs in order: [(code, stdout with times and ids masked)]."""
    root, pipeline = _lake(pkg, path)
    out = []
    for verb in verbs:
        argv = [pipeline if a == "PIPELINE" else a for a in verb]
        code, text = pkg.cli("--lake", root, *argv)
        out.append((code, mask_commits(text)))
    return out


def test_cli_query(tmp_path):
    ((code, out),) = parity(_cli_verbs, tmp_path, ["query", "-q", "SELECT COUNT(*) AS n FROM taxi_table"])
    assert code == 0 and "500" in out


def test_cli_run_then_query_log_and_branch(tmp_path):
    out = parity(
        _cli_verbs, tmp_path,
        ["run", "PIPELINE", "-b", "feat_1"],
        ["query", "-q", "SELECT pickup_location_id, counts FROM pickups LIMIT 3", "-b", "feat_1"],
        ["log", "-b", "feat_1"],
        ["branch"],
    )
    assert [c for c, _ in out] == [0, 0, 0, 0]
    run, query, log, branch = (o for _, o in out)
    assert "merged to 'feat_1'" in run and "counts" in query and "run 1" in log
    assert "feat_1" in branch and "main" in branch


def test_cli_run_reports_node_hit_rate(tmp_path):
    out = parity(
        _cli_verbs, tmp_path,
        ["run", "PIPELINE", "-b", "dev"],
        ["run", "PIPELINE", "-b", "dev"],
        ["run", "PIPELINE", "-b", "dev", "--no-fusion"],
        ["run", "PIPELINE", "-b", "dev", "--no-cache"],
        ["cache", "stats"],
    )
    cold, warm, flipped, nocache, stats = (o for _, o in out)
    assert "0/3 nodes hit" in cold
    assert "2/2 nodes hit" in warm and "0 executed" in warm
    assert "0 executed" in flipped and "nodes hit" not in nocache
    assert "pickups" in stats and "artifact" in stats and "check" in stats


def test_cli_tables_and_replay(tmp_path):
    out = parity(
        _cli_verbs, tmp_path,
        ["run", "PIPELINE", "-b", "dev"],
        ["tables", "-b", "dev"],
        ["run", "PIPELINE", "--replay", "--run-id", "1"],
    )
    assert "pickups" in out[1][1] and "taxi_table" in out[1][1]
    assert "replayed run 1" in out[2][1]


# ------------------------------------------------------- telemetry verbs
_TIMED = {"wall_s", "stage_timings"}


def _json_payload(out):
    return json.loads(out[out.index("{"):])


def _run_json(pkg, path):
    root, pipeline = _lake(pkg, path, TELEMETRY_SRC)
    code, out = pkg.cli("--lake", root, "run", pipeline, "--json")
    payload = _json_payload(out)
    assert code == 0 and payload["state"] == "SUCCESS"
    assert payload["run_id"] == 1 and payload["failed_checks"] == []
    assert payload["checks"] == {"trips_expectation": True} and "trips" in payload["artifacts"]
    timings = payload["stage_timings"]
    assert timings and all({"queue_s", "exec_s", "commit_s"} <= set(v) for v in timings.values())
    assert {"hits", "rehydrated"} <= set(payload["cache"])
    assert payload["io"]["puts"] > 0 and payload["wall_s"] > 0
    failing = pkg.write_pipeline(path, "failing.py", TELEMETRY_SRC.replace("> 1.0", "> 10_000.0"))
    fcode, fout = pkg.cli("--lake", root, "run", failing, "--json")
    failed = _json_payload(fout)
    assert fcode == 2 and failed["state"] == "AUDIT_FAILED"
    assert failed["failed_checks"] == ["trips_expectation"]
    summary = {}
    for p in (payload, failed):
        p = {k: v for k, v in p.items() if k not in _TIMED}
        p["merged_commit"] = p["merged_commit"] is not None
        # cost estimates and admission waits come from measured times
        p["scheduler"] = {k: v for k, v in p["scheduler"].items() if k in ("schedule", "streaming")}
        summary[p["state"]] = p
    return summary, sorted(timings)


def test_cli_run_json_summary_and_audit_failure(tmp_path):
    parity(_run_json, tmp_path)


def _trace_and_events(pkg, path):
    root, pipeline = _lake(pkg, path, TELEMETRY_SRC)
    assert pkg.cli("--lake", root, "run", pipeline)[0] == 0
    chrome_path = path / "trace.json"
    code, out = pkg.cli("--lake", root, "trace", "1", "--chrome", chrome_path)
    assert code == 0 and "run 1" in out and "critical path" in out and "coverage" in out
    chrome = json.loads(chrome_path.read_text())
    assert any(e["ph"] == "X" for e in chrome["traceEvents"])
    assert chrome["otherData"]["state"] == "SUCCESS"
    missing, _ = pkg.cli("--lake", root, "trace", "999")
    assert missing not in (0, None)
    code, events = pkg.cli("--lake", root, "events")
    assert code == 0 and "RunStarted" in events and "RunFinished" in events
    code, limited = pkg.cli("--lake", root, "events", "--limit", "2")
    assert len(limited.strip().splitlines()) == 2
    code, gc = pkg.cli("--lake", root, "gc", "--dry-run", "--runlog-ttl", "0.001")
    assert "1 run traces" in gc
    kinds = Counter(line.split()[1] for line in events.strip().splitlines())
    x_names = sorted(e["name"] for e in chrome["traceEvents"] if e["ph"] == "X")
    return (str(missing), kinds, x_names, mask_seconds(gc).split("live:")[0],
            [line.split()[0] for line in out.splitlines()[:1]])


def test_cli_trace_chrome_export_and_events(tmp_path):
    parity(_trace_and_events, tmp_path)


# ---------------------------------------------------------- as a process
def _process(*argv, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.cli", *map(str, argv)],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )


def test_cli_process_runs_the_pipeline_and_queries_on_the_cpu(tmp_path):
    root, pipeline = _lake(PORT, tmp_path)
    ran = _process("--device", "cpu", "--lake", root, "run", pipeline, "-b", "feat", cwd=tmp_path)
    assert ran.returncode == 0, ran.stderr
    assert "merged to 'feat'" in ran.stdout
    query = "SELECT pickup_location_id, counts FROM pickups ORDER BY pickup_location_id LIMIT 3"
    got = _process("--device", "cpu", "--lake", root, "query", "-q", query, "-b", "feat", cwd=tmp_path)
    assert got.returncode == 0, got.stderr
    code, inproc = PORT.cli("--lake", root, "query", "-q", query, "-b", "feat")
    assert code == 0 and got.stdout == inproc
