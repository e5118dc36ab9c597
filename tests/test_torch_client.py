"""The SDK facade, ``repro_torch.Client``, against ``repro.Client``.

Each case runs one scenario through both packages on lakes of their own
(the JAX package on the CPU, the port with ``device="cpu"``), from the
same seeded data, and compares what the user sees: run states, artifact
manifest keys (content addressed), read-back outputs, check verdicts,
cache statistics, branch heads.  Each case also keeps the reference
test's own assertions, applied to the port.

Mirrored: ``test_api_client.py``; the ``Client`` cases of
``test_parallel_runner.py`` (``run_async``, ``AsyncRunHandle``, branch
handles) and ``test_scheduler_v2.py`` (memory-budgeted admission,
``StageScheduled`` against the trace, forecasts in ``latencyhist``, the
cost source upgraded to latency, the invalid schedule).  On top: the
latency history across packages (it carries within one package, gives
no seeds across them, and ``gc`` reclaims both packages' refs).
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import repro
import repro_torch
from tests.torch_parity import (
    BOTH,
    JAX,
    PORT,
    fanout_pipeline,
    handle_summary,
    parity,
    read_artifacts,
    table_contents,
    widths_pipeline,
)

torch.set_num_threads(1)


def _client(pkg, path, **kw):
    kw.setdefault("shard_rows", 128)
    kw.setdefault("executor_config", pkg.ExecutorConfig(max_workers=2))
    return pkg.Client(path / "lake", **kw)


# ------------------------------------------------------------- public API
def test_public_api_surface_matches_the_reference():
    assert repro_torch.Client is repro_torch.api.Client
    assert set(repro_torch.__all__) == set(repro.__all__)
    for name in ("model", "expectation", "requirements", "sql", "project", "discover"):
        assert callable(getattr(repro_torch, name))
    assert repro_torch.RunState.SUCCESS.value == "SUCCESS"
    assert [s.value for s in repro_torch.RunState] == [s.value for s in repro.RunState]
    assert set(repro_torch.api.__all__) == set(repro.api.__all__)
    assert set(repro_torch.telemetry.__all__) == set(repro.telemetry.__all__)


def test_runner_shim_warns_but_works():
    repro_torch.__dict__.pop("Runner", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shim = repro_torch.Runner
    assert shim is repro_torch.core.Runner
    assert any(w.category is DeprecationWarning for w in caught)


def test_client_takes_the_device():
    with pytest.raises(TypeError):
        repro_torch.Client(None, device="cpu", nonsense=1)
    with repro_torch.Client.ephemeral(device="cpu") as c:
        assert c.device == torch.device("cpu")
        assert c.runner.device == torch.device("cpu")


# ----------------------------------------------------- Client/Runner parity
def _client_runner_matrix(pkg, path, fusion, cache):
    api = _client(pkg, path)
    pkg.seed_taxi(api)
    runs = [
        api.run(pkg.build_taxi_pipeline(), branch="feat", fusion=fusion,
                pushdown=fusion, cache=cache)
        for _ in range(2)
    ]
    store = pkg.io.ObjectStore(path / "legacy")
    catalog = pkg.catalog.Catalog(store)
    fmt = pkg.table.TableFormat(store, shard_rows=128)
    snap = fmt.write("taxi_table", pkg.TAXI_SCHEMA,
                     pkg.make_taxi_data(2000, np.random.default_rng(0)))
    catalog.commit("main", {"taxi_table": fmt.manifest_key(snap)})
    with pkg.runtime.ServerlessExecutor(pkg.ExecutorConfig(max_workers=2)) as ex:
        runner = pkg.Runner(catalog, fmt, ex)
        legacy = [
            runner.run(pkg.build_taxi_pipeline(), branch="feat", fusion=fusion,
                       pushdown=fusion, cache=cache)
            for _ in range(2)
        ]
    for h, r in zip(runs, legacy):
        assert h.state is pkg.RunState.SUCCESS and r.ok
        assert h.artifacts == r.artifacts
        assert h.checks == r.checks
        assert h.stats["cache"] == r.stats["cache"]
        assert len(h.plan.stages) == len(r.plan.stages)
    warm = runs[1]
    if cache:
        assert warm.cache["hits"] > 0 and warm.cache["nodes_executed"] == 0
    else:
        assert warm.cache["hits"] == 0 and warm.cache["enabled"] is False
    assert api.tables("feat") == catalog.tables(branch="feat")
    out = [handle_summary(h) for h in runs], table_contents(api, "feat")
    api.close()
    return out


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("fusion", [True, False])
def test_client_runner_parity_matrix(tmp_path, cache, fusion):
    parity(_client_runner_matrix, tmp_path, fusion, cache)


# ------------------------------------------------------------- RunHandle
def _audit_failure(pkg, path):
    with _client(pkg, path) as client:
        pkg.seed_taxi(client, 500, mean_count=1.0)
        before = client.catalog.head("main").commit_id
        handle = client.run(pkg.build_taxi_pipeline(), branch="main")
        assert handle.state is pkg.RunState.AUDIT_FAILED and not handle.ok
        assert handle.merged_commit is None
        assert handle.failed_checks == ["trips_expectation"]
        assert handle.run_id > 0
        with pytest.raises(pkg.api.RunFailed):
            handle.raise_for_state()
        assert client.catalog.head("main").commit_id == before
        assert "pickups" not in client.tables("main")
        assert all(not b.startswith("run_") for b in client.branches())
        again = client.replay(handle.run_id, pkg.build_taxi_pipeline())
        assert again.state is pkg.RunState.AUDIT_FAILED
        assert again.replay_of == handle.run_id and again.merged_commit is None
        return handle_summary(handle), handle_summary(again), client.branches()


def test_audit_failure_is_typed_rolled_back_and_replays_as_failed(tmp_path):
    _, again, _ = parity(_audit_failure, tmp_path)
    assert again["checks"] == {"trips_expectation": False}


def _run_error(pkg, path):
    with _client(pkg, path) as client:
        with pytest.raises(KeyError):
            client.run(pkg.build_taxi_pipeline(), branch="main")
        handle = client.run(pkg.build_taxi_pipeline(), branch="main", raise_errors=False)
        assert handle.state is pkg.RunState.ERROR
        assert isinstance(handle.error, KeyError)
        with pytest.raises(pkg.api.RunFailed):
            handle.raise_for_state()
        return handle_summary(handle)


def test_run_error_state_captured_when_asked(tmp_path):
    parity(_run_error, tmp_path)


def _artifact_read_and_replay(pkg, path):
    with _client(pkg, path) as client:
        pkg.seed_taxi(client)
        first = client.run(pkg.build_taxi_pipeline(), branch="feat")
        out = first.artifact("pickups")
        assert set(out) == {"pickup_location_id", "dropoff_location_id", "counts"}
        assert (np.sort(out["counts"])[::-1] == out["counts"]).all()
        with pytest.raises(KeyError):
            first.artifact("nope")
        again = client.replay(first.run_id, pkg.build_taxi_pipeline())
        assert again.state is pkg.RunState.SUCCESS
        assert again.replay_of == first.run_id and again.merged_commit is None
        assert again.artifacts == first.artifacts
        return handle_summary(first), read_artifacts(client, first), handle_summary(again)


def test_runhandle_artifact_read_and_replay(tmp_path):
    parity(_artifact_read_and_replay, tmp_path)


# ----------------------------------------------------------- BranchHandle
def _branch_lifecycles(pkg, path):
    with _client(pkg, path) as client:
        pkg.seed_taxi(client)
        seen = {}
        with client.branch("feat_1") as branch:
            h = branch.run(pkg.build_taxi_pipeline())
            assert h.ok and "pickups" in branch.tables()
            assert "pickups" not in client.tables("main")
        assert "pickups" in client.tables("main")
        assert "feat_1" not in client.branches()
        seen["merged"] = table_contents(client)

        with client.branch("feat_bad") as branch:
            branch.write_table(
                "taxi_table",
                pkg.make_taxi_data(300, np.random.default_rng(7), mean_count=1.0),
                schema=pkg.TAXI_SCHEMA,
            )
            assert branch.run(pkg.build_taxi_pipeline()).state is pkg.RunState.AUDIT_FAILED
        assert "feat_bad" not in client.branches()

        with pytest.raises(RuntimeError, match="boom"):
            with client.branch("feat_exc") as branch:
                branch.write_table("extra", {"x": np.arange(4, dtype=np.int32)})
                raise RuntimeError("boom")
        assert "feat_exc" not in client.branches()
        assert "extra" not in client.tables("main")

        client.create_branch("longlived")
        with client.branch("longlived") as branch:
            branch.run(pkg.build_taxi_pipeline(), cache=False).raise_for_state()
        assert "longlived" in client.branches()
        seen["longlived"] = table_contents(client, "longlived")

        feat = client.branch("feat_q", ephemeral=False)
        feat.run(pkg.build_taxi_pipeline()).raise_for_state()
        out = feat.query("SELECT COUNT(*) AS n FROM pickups")
        assert out["n"][0] > 0
        assert any("run " in c.message for c in feat.log())
        tagged = feat.tag("v1")
        assert client.tags()["v1"] == tagged == feat.head().commit_id
        seen["count"] = int(out["n"][0])
        seen["branches"] = client.branches()
        seen["log"] = [c.message for c in feat.log()]
        return seen


def test_branch_handles_merge_roll_back_attach_and_scope(tmp_path):
    parity(_branch_lifecycles, tmp_path)


# ----------------------------------------------- decorators + discovery
def _decorated_project(pkg, path):
    repro_ns = pkg.root
    with _client(pkg, path) as client:
        pkg.seed_taxi(client)
        proj = repro_ns.project("taxi_decorated")
        proj.clear()
        proj.sql(
            "trips",
            "SELECT pickup_location_id, passenger_count as count, "
            "dropoff_location_id FROM taxi_table WHERE pickup_at >= '2019-04-01'",
        )

        @proj.expectation(name="trips_expectation")
        @repro_ns.requirements({"pandas": "2.0.0"})
        def trips_are_plausible(ctx, trips):
            return trips.mean("count") > 10.0

        proj.sql(
            "pickups",
            "SELECT pickup_location_id, dropoff_location_id, COUNT(*) AS counts "
            "FROM trips GROUP BY pickup_location_id, dropoff_location_id "
            "ORDER BY counts DESC",
        )
        decorated = client.run(proj, branch="dec", cache=False)
        legacy = client.run(pkg.build_taxi_pipeline(), branch="leg", cache=False)
        assert decorated.state is pkg.RunState.SUCCESS
        assert decorated.artifacts == legacy.artifacts
        assert decorated.checks == legacy.checks

        free = repro_ns.project("taxi_free_names")
        free.clear()
        free.sql("trips", "SELECT pickup_location_id, passenger_count as count FROM taxi_table")

        @free.expectation()
        def trips_have_riders(ctx, trips):
            return trips.mean("count") > 10.0

        h = client.run(free, branch="free")
        assert h.checks == {"trips_have_riders": True}
        assert free.pipeline().expectations == ["trips_have_riders"]

        redef = repro_ns.project("taxi_redef")
        redef.clear()
        redef.sql("trips", "SELECT pickup_location_id FROM taxi_table")
        with pytest.warns(pkg.api.RedefinitionWarning):
            redef.sql("trips", "SELECT dropoff_location_id FROM taxi_table")
        assert len(redef) == 1
        assert redef.pipeline().nodes["trips"].query.projections[0][0] == "dropoff_location_id"
        fps = {n: node.fingerprint for n, node in proj.pipeline().nodes.items()}
        return handle_summary(decorated), handle_summary(h), fps


def test_decorator_projects(tmp_path):
    parity(_decorated_project, tmp_path)


_DISCOVER = (
    "repro.sql('trips', \"SELECT pickup_location_id, passenger_count as "
    "count FROM taxi_table\")\n"
    "@repro.expectation()\n"
    "def sane(ctx, trips):\n"
    "    return trips.count() > 0\n"
)


def _discovery(pkg, path):
    with _client(pkg, path) as client:
        pkg.seed_taxi(client)
        out = {}
        mod = pkg.write_pipeline(path, "my_pipeline.py", _DISCOVER)
        h = client.run(str(mod), branch="disc")
        assert h.state is pkg.RunState.SUCCESS and h.checks == {"sane": True}
        h2 = client.run(str(mod), branch="disc")
        assert h2.state is pkg.RunState.SUCCESS
        out["discover"] = handle_summary(h), handle_summary(h2)

        def node_file(rel, name, col):
            f = path / rel
            f.parent.mkdir(parents=True, exist_ok=True)
            f.write_text(
                ("import repro_torch as repro\n" if pkg.port else "import repro\n")
                + f"repro.sql('{name}', 'SELECT {col} FROM taxi_table')\n"
            )
            return str(f)

        a = node_file("pa/pipe.py", "a_node", "pickup_location_id")
        b = node_file("pb/pipe.py", "b_node", "dropoff_location_id")
        c = node_file("a_b.py", "c_node", "pickup_location_id")
        d = node_file("a/b.py", "d_node", "dropoff_location_id")
        runs = [(a, "pa"), (b, "pb"), (c, "pc"), (d, "pd"), (c, "pc2")]
        out["stems"] = [sorted(client.run(f, branch=br).artifacts) for f, br in runs]
        assert out["stems"] == [["a_node"], ["b_node"], ["c_node"], ["d_node"], ["c_node"]]

        evolving = node_file("evolving.py", "old_node", "pickup_location_id")
        v1 = sorted(client.run(evolving, branch="v1").artifacts)
        evolving = node_file("evolving.py", "new_node", "dropoff_location_id")
        v2 = sorted(client.run(evolving, branch="v2").artifacts)
        assert (v1, v2) == (["old_node"], ["new_node"])

        legacy = pkg.write_pipeline(
            path, "legacy_pipeline.py",
            "PIPELINE = repro.Pipeline('legacy')\n"
            "PIPELINE.sql('trips', 'SELECT pickup_location_id FROM taxi_table')\n",
        )
        h = client.run(str(legacy), branch="old")
        assert h.state is pkg.RunState.SUCCESS and "trips" in h.artifacts
        out["legacy"] = handle_summary(h)
        return out


def test_discovery_of_pipeline_files(tmp_path):
    parity(_discovery, tmp_path)


def test_discovered_module_names_are_the_references(tmp_path):
    """Both packages name a discovered module alike (so a file's project
    name, and its node fingerprints, do not depend on the package); that
    is why a test gives each package a file of its own."""
    f = JAX.write_pipeline(tmp_path, "same.py", "repro.sql('t', 'SELECT x FROM y')\n")
    j = JAX.api_project._load_module(f)
    t = PORT.api_project._load_module(f)
    assert j.__name__ == t.__name__
    import sys

    assert sys.modules[j.__name__] is t  # the second load replaced the first


def _write_table_append(pkg, path):
    with _client(pkg, path) as client:
        client.write_table(
            "events", {"ts": np.arange(10, dtype=np.int64).astype(np.int32),
                       "value": np.ones(10, dtype=np.float32)},
        )
        client.write_table(
            "events", {"ts": np.arange(10, 20, dtype=np.int32),
                       "value": np.zeros(10, dtype=np.float32)},
            append=True,
        )
        out = client.query("SELECT COUNT(*) AS n FROM events")
        assert out["n"][0] == 20
        return table_contents(client), {k: v.tolist() for k, v in out.items()}


def test_write_table_infers_schema_and_appends(tmp_path):
    parity(_write_table_append, tmp_path)


# ------------------------------------------------- latency history (lake)
def _latency_history(pkg, path):
    lake = path / "lake"
    cfg = pkg.ExecutorConfig(max_workers=2)
    with pkg.Client(lake, shard_rows=128, executor_config=cfg) as c1:
        pkg.seed_taxi(c1)
        runs = [c1.run(pkg.build_taxi_pipeline(), branch=f"b{i}", cache=False) for i in range(3)]
        history = c1.executor.latency_history()
    assert history
    fp, durations = max(history.items(), key=lambda kv: len(kv[1]))
    assert len(durations) >= 3
    with pkg.Client(lake, shard_rows=128, executor_config=cfg) as c2:
        inherited = c2.executor.latency_history()
        assert inherited[fp] == pytest.approx(durations)
        c2.executor.seed_latency_history({fp: [999.0]})
        assert c2.executor.latency_history()[fp] == pytest.approx(durations)
        fourth = c2.run(pkg.build_taxi_pipeline(), branch="b3", cache=False)
    sources = {s["source"] for s in fourth.stats["scheduler"]["stages"].values()}
    return [handle_summary(h) for h in runs], len(durations), sources


def test_latency_history_carries_within_a_package(tmp_path):
    """A second Client of the same package on the lake inherits the
    baselines, and its scheduler estimates from them (``src=latency``)."""
    _, _, sources = parity(_latency_history, tmp_path)
    assert sources == {"latency"}


def _sources(handle):
    return {s["source"] for s in handle.stats["scheduler"]["stages"].values()}


@pytest.mark.parametrize("first,second", [(JAX, PORT), (PORT, JAX)], ids=["jax-then-port", "port-then-jax"])
def test_latency_history_gives_no_seeds_across_packages(tmp_path, first, second):
    """The history is keyed by the stage's ``FunctionSpec`` fingerprint,
    which hashes each package's own stage function: a Client of the other
    package on the same lake finds no seeds for its stages and estimates
    from bytes, while manifests and verdicts equal the first package's."""
    lake = tmp_path / "lake"
    cfg = dict(shard_rows=128)
    with first.Client(lake, executor_config=first.ExecutorConfig(max_workers=2), **cfg) as c:
        first.seed_taxi(c)
        a = c.run(first.build_taxi_pipeline(), branch="a", cache=False)
        a2 = c.run(first.build_taxi_pipeline(), branch="a2", cache=False)
    assert _sources(a) == {"bytes"} and _sources(a2) == {"latency"}
    with second.Client(lake, executor_config=second.ExecutorConfig(max_workers=2), **cfg) as c:
        assert c.store.list_refs("latencyhist")  # the other package's refs are there
        b = c.run(second.build_taxi_pipeline(), branch="b", cache=False)
        assert _sources(b) == {"bytes"}
        b2 = c.run(second.build_taxi_pipeline(), branch="b2", cache=False)
        assert _sources(b2) == {"latency"}
    assert b.artifacts == a.artifacts and b.checks == a.checks
    assert b.state is second.RunState.SUCCESS


def test_gc_reclaims_latency_refs_of_both_packages(tmp_path):
    lake = tmp_path / "lake"
    for pkg in BOTH:
        with pkg.Client(lake, shard_rows=128, executor_config=pkg.ExecutorConfig(max_workers=2)) as c:
            if "taxi_table" not in c.tables():
                pkg.seed_taxi(c)
            c.run(pkg.build_taxi_pipeline(), branch=f"{pkg.name}_run", cache=False)
    with PORT.Client(lake) as c:
        refs = c.store.list_refs("latencyhist")
        assert len(refs) >= 2  # one stage fingerprint per package at least
        code, out = PORT.cli("--lake", lake, "gc", "--latency-ttl", "0", "--grace", "0")
        assert code == 0
        assert c.store.list_refs("latencyhist") == {}
        assert f"{len(refs)} latency" in out


def _gc_latency_ttl(pkg, path):
    with _client(pkg, path) as client:
        pkg.seed_taxi(client)
        client.run(pkg.build_taxi_pipeline(), branch="b", cache=False)
        client._save_latency_history()
        fresh = client.store.list_refs("latencyhist")
        assert fresh
        client.store.set_ref("latencyhist", "deadbeef_stale", {"durations": [0.5], "updated_at": 1.0})
        report = client.gc(grace_s=0.0, latency_ttl_s=3600.0)
        assert report.swept_latency_refs == 1
        left = client.store.list_refs("latencyhist")
        assert "deadbeef_stale" not in left and set(fresh) <= set(left)
        client.store.set_ref("latencyhist", "deadbeef_stale", {"durations": [0.5], "updated_at": 1.0})
        assert client.gc(grace_s=0.0, latency_ttl_s=None).swept_latency_refs == 0
        return len(fresh)


def test_gc_prunes_stale_latency_baselines(tmp_path):
    parity(_gc_latency_ttl, tmp_path)


# ------------------------------------------------------------ run_async
N_ASYNC = 4_000


def _async_client(pkg, parallelism=4):
    return pkg.ephemeral(
        shard_rows=512,
        executor_config=pkg.ExecutorConfig(max_workers=8, max_concurrent_stages=parallelism),
    )


def _fan(pkg, threshold=10.0):
    return fanout_pipeline(pkg, threshold, name="parallel_parity", width=3, dropoff=True)


def _run_async(pkg, path):
    with _async_client(pkg) as client:
        pkg.seed_taxi(client, N_ASYNC, seed=7)
        ah = client.run_async(_fan(pkg), fusion=False, pushdown=False)
        assert isinstance(ah, pkg.api.AsyncRunHandle)
        assert ah.state in (pkg.RunState.RUNNING, pkg.RunState.SUCCESS)
        resolved = ah.result(timeout=120)
        assert resolved.state is pkg.RunState.SUCCESS
        assert ah.state is pkg.RunState.SUCCESS and ah.done() and not ah.running
        assert ah.poll() is resolved
        assert "combine" in client.tables()
        with _async_client(pkg) as fresh:
            pkg.seed_taxi(fresh, N_ASYNC, seed=7)
            sync = fresh.run(_fan(pkg), fusion=False, pushdown=False)
        assert dict(resolved.artifacts) == dict(sync.artifacts)

        failed = client.run_async(_fan(pkg, 10_000.0), fusion=False, pushdown=False).result(timeout=120)
        assert failed.state is pkg.RunState.AUDIT_FAILED
        assert client.branches() == ["main"]
        p = pkg.Pipeline("missing_source")
        p.sql("x", "SELECT pickup_at FROM no_such_table")
        err = client.run_async(p).result(timeout=120)
        assert err.state is pkg.RunState.ERROR and isinstance(err.error, KeyError)
        return (dict(sorted(resolved.artifacts.items())), resolved.checks,
                handle_summary(failed)["checks"], type(err.error).__name__)


def test_run_async_resolves_to_the_same_handles(tmp_path):
    parity(_run_async, tmp_path)


def test_run_async_poll_is_nonblocking():
    """poll() returns None while a node blocks (the port's Python nodes
    run on the executor's worker thread, so the node itself waits)."""
    evt = threading.Event()
    p = PORT.Pipeline("slow")

    @p.python
    def slow_model(ctx, taxi_table):
        evt.wait(10.0)
        return {"score": taxi_table.column("passenger_count")[:1].to(torch.float32) * 0}

    with _async_client(PORT, 2) as client:
        PORT.seed_taxi(client, 512, seed=17)
        handle = client.run_async(p)
        try:
            assert handle.poll() is None
            assert handle.state is PORT.RunState.RUNNING
        finally:
            evt.set()
        assert handle.result(timeout=120).state is PORT.RunState.SUCCESS


def _branch_async(pkg, path):
    with _async_client(pkg) as client:
        pkg.seed_taxi(client, N_ASYNC, seed=19)
        with client.branch("feat_async") as branch:
            h = branch.run_async(_fan(pkg, 10_000.0), fusion=False, pushdown=False)
            assert h.result(timeout=120).state is pkg.RunState.AUDIT_FAILED
        assert client.branches() == ["main"] and "combine" not in client.tables()
        with client.branch("feat_join") as branch:
            joined = branch.run_async(_fan(pkg), fusion=False, pushdown=False)
        assert joined.result(timeout=1).state is pkg.RunState.SUCCESS
        assert client.branches() == ["main"] and "combine" in client.tables()
        return table_contents(client)


def test_branch_handle_async_rolls_back_and_joins(tmp_path):
    parity(_branch_async, tmp_path)


def _two_async_branches(pkg, path):
    """Two async runs on different branches at once: both merge."""
    with _async_client(pkg) as client:
        pkg.seed_taxi(client, N_ASYNC, seed=7)
        with client.branch("left") as left, client.branch("right") as right:
            hl = left.run_async(pkg.build_taxi_pipeline(), cache=False)
            hr = right.run_async(_fan(pkg), fusion=False, pushdown=False, cache=False)
            results = hl.result(timeout=120), hr.result(timeout=120)
        assert all(r.state is pkg.RunState.SUCCESS for r in results)
        assert client.branches() == ["main"]
        assert {"pickups", "combine"} <= set(client.tables())
        return [dict(sorted(r.artifacts.items())) for r in results], table_contents(client)


def test_two_async_runs_on_different_branches_both_merge(tmp_path):
    parity(_two_async_branches, tmp_path)


# ---------------------------------------------------- scheduler (Client)
def _sched_client(pkg, **cfg):
    cfg.setdefault("max_workers", 8)
    cfg.setdefault("max_concurrent_stages", 4)
    return pkg.ephemeral(shard_rows=512, executor_config=pkg.ExecutorConfig(**cfg))


def _seed_sched(pkg, client):
    pkg.seed_taxi(client, 2000, seed=11)


def _memory_budget(pkg, path, budget):
    with _sched_client(pkg, max_concurrent_stages=8, memory_budget_gb=budget) as client:
        _seed_sched(pkg, client)
        handle = client.run(widths_pipeline(pkg), fusion=False, pushdown=False).raise_for_state()
        sched = handle.stats["scheduler"]
        assert sched["memory_budget_gb"] == budget
        trace = client.trace(handle.run_id)
        if budget is None:
            assert sched["admission_waits"] == 0
        else:
            assert sched["schedule"] == "critical_path"
            assert sched["admission_waits"] >= 1
            spans = sorted((s["exec"].start, s["exec"].end)
                           for s in trace.stage_spans.values() if "exec" in s)
            assert len(spans) >= 3
            for (_, prev_end), (next_start, _) in zip(spans, spans[1:]):
                assert next_start >= prev_end - 1e-6
            waited = [e for e in trace.stage_scheduled.values() if e.admission == "waited"]
            assert len(waited) == sched["admission_waits"]
        return dict(sorted(handle.artifacts.items())), sched["admission_waits"] > 0


@pytest.mark.parametrize("budget", [1.0, None], ids=["budget-1gb", "no-budget"])
def test_memory_budget_admission(tmp_path, budget):
    parity(_memory_budget, tmp_path, budget)


def _scheduled_events_and_forecasts(pkg, path):
    with _sched_client(pkg) as client:
        _seed_sched(pkg, client)
        handle = client.run(widths_pipeline(pkg), fusion=False, pushdown=False).raise_for_state()
        sched = handle.stats["scheduler"]
        events = [e for e in client.runlog.get(handle.run_id)
                  if isinstance(e, pkg.telemetry.events.StageScheduled)]
        assert {e.stage_id for e in events} == {int(s) for s in sched["stages"]}
        for e in events:
            st = sched["stages"][str(e.stage_id)]
            assert (e.est_cost_s, e.cp_rank, e.cost_source) == (st["est_s"], st["cp_rank"], st["source"])
        assert sched["critical_path"]
        trace = client.trace(handle.run_id)
        observed = trace.critical_path()
        by_id = {s: set(ps) for s, ps in trace.stage_parents.items()}
        assert observed
        for a, b in zip(observed, observed[1:]):
            assert a in by_id.get(b, set())
        assert "scheduler:" in trace.describe()
        refs = client.store.list_refs("latencyhist")
        with_forecast = {fp: raw for fp, raw in refs.items() if "forecast" in raw}
        assert with_forecast
        for raw in with_forecast.values():
            assert raw["forecast"]["predicted_s"] > 0.0 and raw["forecast"]["actual_s"] > 0.0
            assert raw["updated_at"] > 0.0
        return (sorted(int(s) for s in sched["stages"]), len(sched["critical_path"]),
                len(refs), len(with_forecast))


def test_stage_scheduled_events_trace_and_forecasts(tmp_path):
    parity(_scheduled_events_and_forecasts, tmp_path)


def _cost_source_upgrade(pkg, path):
    with _sched_client(pkg) as client:
        _seed_sched(pkg, client)
        first = client.run(widths_pipeline(pkg), fusion=False, pushdown=False, cache=False).raise_for_state()
        second = client.run(widths_pipeline(pkg), fusion=False, pushdown=False, cache=False).raise_for_state()
        with pytest.raises(ValueError, match="schedule"):
            client.run(widths_pipeline(pkg), schedule="sjf")
        return _sources(first), _sources(second), first.artifacts == second.artifacts


def test_second_run_upgrades_cost_source_and_invalid_schedule(tmp_path):
    assert parity(_cost_source_upgrade, tmp_path) == ({"bytes"}, {"latency"}, True)
