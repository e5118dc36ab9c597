"""The pipeline run as a whole: ``Runner.run`` and ``Runner.replay``, JAX
package vs the port.

Each case writes the same seeded taxi data (2,000 rows, ``shard_rows=128``)
into two lakes, one per package, and drives the same sequence of runs
through ``repro.core.Runner`` (Pallas in interpret mode, the JAX route's
default) and the port's ``Runner`` on the CPU.  Storage is
content-addressed, so equal outputs mean equal manifest keys.  After
every run the two must agree on: artifact manifest keys, read-back
outputs, check verdicts, cache statistics (hits, restores, elisions,
nodes and stages executed), node fingerprints, stage node sets and
engine routes, and — where a run fails — the exception's type and
message.  On top of that, each case keeps the reference test's own
assertions, applied to the port's result.

Mirrored: all of ``test_e2e_taxi.py``, the ``Runner``-level tests of
``test_differential_cache.py``, and the byte-identity matrix of
``test_parallel_runner.py`` / ``test_scheduler_v2.py`` (schedule x
streaming x parallelism) driven through ``Runner`` with an
``ExecutorConfig``.  Cases that need ``repro.api`` or ``repro.maintenance``
wait for those slices of the port.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.catalog
import repro.core
import repro.core.physical
import repro.core.runner
import repro.examples_data
import repro.io
import repro.runtime
import repro.table
import repro_torch.catalog
import repro_torch.core
import repro_torch.core.physical
import repro_torch.core.runner
import repro_torch.examples_data
import repro_torch.io
import repro_torch.runtime
import repro_torch.table
from repro_torch.examples_data import APRIL_1
from repro_torch.kernels.fused_filter_agg import ops as ffa_ops

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

N_ROWS = 2_000
SEED = 0

#: Q1 of chip_smoke.py as a pipeline node: one group key, integer counts
#: and a pushed-down date filter, so the route sends it to the kernel
ZONE_RIDERS = (
    "SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01' GROUP BY pickup_location_id "
    "ORDER BY pickup_location_id"
)


def _ns(root):
    pkg = SimpleNamespace(
        Catalog=root.catalog.Catalog,
        ObjectStore=root.io.ObjectStore,
        TableFormat=root.table.TableFormat,
        Runner=root.core.Runner,
        Pipeline=root.core.Pipeline,
        PlannerConfig=root.core.PlannerConfig,
        ExpectationFailed=root.core.ExpectationFailed,
        NodeCacheEntry=root.core.NodeCacheEntry,
        NodeCacheRegistry=root.core.NodeCacheRegistry,
        RunContext=root.core.runner.RunContext,
        build_logical_plan=root.core.build_logical_plan,
        build_physical_plan=root.core.physical.build_physical_plan,
        ServerlessExecutor=root.runtime.ServerlessExecutor,
        ExecutorConfig=root.runtime.ExecutorConfig,
        TAXI_SCHEMA=root.examples_data.TAXI_SCHEMA,
        make_taxi_data=root.examples_data.make_taxi_data,
        build_taxi_pipeline=root.examples_data.build_taxi_pipeline,
    )
    return pkg


JAX = _ns(repro)
PORT = _ns(repro_torch)


class Side:
    """One package's lake, executor and runner."""

    def __init__(self, ns, path, executor_config=None, *, shard_rows=128):
        self.ns = ns
        self.store = ns.ObjectStore(path)
        self.fmt = ns.TableFormat(self.store, shard_rows=shard_rows)
        self.catalog = ns.Catalog(self.store)
        self.executor = ns.ServerlessExecutor(
            executor_config or ns.ExecutorConfig(max_workers=2)
        )
        kw = {"device": "cpu"} if ns is PORT else {}
        self.runner = ns.Runner(self.catalog, self.fmt, self.executor, **kw)

    def seed(self, n=N_ROWS, rng_seed=SEED, **kw):
        data = self.ns.make_taxi_data(n, np.random.default_rng(rng_seed), **kw)
        snap = self.fmt.write("taxi_table", self.ns.TAXI_SCHEMA, data)
        self.catalog.commit("main", {"taxi_table": self.fmt.manifest_key(snap)}, message="seed")
        return data

    def read(self, key):
        return self.fmt.read(self.fmt.load_snapshot(key))

    def close(self):
        self.executor.shutdown()


def taxi_with_zone_riders(ns, threshold=10.0):
    """The Appendix pipeline plus one SQL node the route sends to the
    fused kernel (the Appendix nodes alone never reach it): the pipeline
    chip_smoke.py runs on the card."""
    p = ns.build_taxi_pipeline(threshold)
    p.sql("zone_riders", ZONE_RIDERS)
    return p


def zone_pipeline(ns):
    """Only kernel-eligible SQL nodes, so ``sql_engine="kernel"`` can be
    forced on every one: Q1's counts (a pushed-down filter), riders by
    dropoff zone (no filter), and an audit over the first."""
    p = ns.Pipeline("zone_demo")
    p.sql("zone_riders", ZONE_RIDERS)
    p.sql(
        "dropoff_riders",
        "SELECT dropoff_location_id, SUM(passenger_count) AS riders "
        "FROM taxi_table GROUP BY dropoff_location_id",
    )

    @p.python
    def zone_riders_expectation(ctx, zone_riders):
        return zone_riders.sum("n") > 0

    return p


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:  # compared across the packages below
        return None, e


def same_outputs(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_same_result(j, t, jside, tside):
    """The two packages' results of one run agree."""
    assert t.artifacts == j.artifacts
    assert t.checks == j.checks
    assert (t.merged_commit is None) == (j.merged_commit is None)
    if "cache" in j.stats:
        assert t.stats["cache"] == j.stats["cache"]
        assert t.stats["stages"] == j.stats["stages"]
    jp, tp = j.plan, t.plan
    assert tp.node_fingerprints == jp.node_fingerprints
    assert [s.node_names for s in tp.stages] == [s.node_names for s in jp.stages]
    assert [s.fingerprint for s in tp.stages] == [s.fingerprint for s in jp.stages]
    assert [{n: r.engine_path for n, r in s.sql_routes.items()} for s in tp.stages] == [
        {n: r.engine_path for n, r in s.sql_routes.items()} for s in jp.stages
    ]
    assert (tp.rehydrate, tp.cached_checks, tp.elided) == (jp.rehydrate, jp.cached_checks, jp.elided)
    for name, key in t.artifacts.items():
        same_outputs(tside.read(key), jside.read(key))


class Pair:
    """The same lake and the same runs, once per package."""

    def __init__(self, tmp_path):
        self.jax = Side(JAX, tmp_path / "jax")
        self.port = Side(PORT, tmp_path / "torch")

    def seed(self, *a, **kw):
        out = [side.seed(*a, **kw) for side in (self.jax, self.port)]
        return out[1]

    def call(self, method, build, *a, **kw):
        """``runner.<method>(build(ns), *a, **kw)`` on both sides: both
        return equal results, or both raise the same error, re-raised."""
        (j, je), (t, te) = (
            _outcome(lambda s=s: getattr(s.runner, method)(build(s.ns), *a, **kw))
            for s in (self.jax, self.port)
        )
        if je is not None or te is not None:
            assert type(te).__name__ == type(je).__name__, (je, te)
            assert str(te) == str(je)
            raise te
        assert_same_result(j, t, self.jax, self.port)
        return t

    def run(self, build, **kw):
        return self.call("run", build, **kw)

    def replay(self, build, run_id, **kw):
        return self.call("replay", build, run_id, **kw)

    def close(self):
        self.jax.close()
        self.port.close()


def taxi(ns, **kw):
    return ns.build_taxi_pipeline(**kw)


@pytest.fixture
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


@pytest.fixture
def seeded(pair):
    return pair.seed()


def _expected_pickups(data):
    mask = data["pickup_at"] >= APRIL_1
    src = data["pickup_location_id"][mask]
    dst = data["dropoff_location_id"][mask]
    pairs, counts = np.unique(np.stack([src, dst]), axis=1, return_counts=True)
    return pairs, counts


# ------------------------------------------------------ test_e2e_taxi.py
def test_full_run_on_feature_branch(pair, seeded):
    result = pair.run(taxi, branch="feat_1")
    assert result.ok
    assert result.checks == {"trips_expectation": True}
    catalog, fmt = pair.port.catalog, pair.port.fmt
    for side in (pair.jax, pair.port):
        assert "pickups" in side.catalog.tables(branch="feat_1")
        assert "pickups" not in side.catalog.tables(branch="main")
        assert all(not b.startswith("run_") for b in side.catalog.branches())
    out = fmt.read(fmt.load_snapshot(result.artifacts["pickups"]))
    pairs, counts = _expected_pickups(seeded)
    assert len(out["counts"]) == pairs.shape[1]
    assert (np.sort(out["counts"])[::-1] == out["counts"]).all()
    got = {(int(a), int(b)): int(c) for a, b, c in zip(
        out["pickup_location_id"], out["dropoff_location_id"], out["counts"])}
    expect = {(int(pairs[0, i]), int(pairs[1, i])): int(counts[i]) for i in range(pairs.shape[1])}
    assert got == expect
    assert catalog.tables(branch="feat_1") == pair.jax.catalog.tables(branch="feat_1")


def test_fused_plan_is_single_stage(pair, seeded):
    result = pair.run(taxi, branch="f2")
    assert len(result.plan.stages) == 1
    stage = result.plan.stages[0]
    assert set(stage.node_names) == {"trips", "trips_expectation", "pickups"}
    assert stage.outputs == ("pickups",)


def test_pushdown_prunes_shards(pair, seeded):
    result = pair.run(taxi, branch="f3")
    scan = result.plan.stages[0].scans["taxi_table"]
    assert scan.predicates
    assert scan.plan.pruned_shards > 0
    assert scan.plan.rows_to_read < N_ROWS


def test_isomorphic_equals_fused_results(pair, seeded):
    fused = pair.run(taxi, branch="fa", fusion=True, cache=False)
    naive = pair.run(taxi, branch="fb", fusion=False, pushdown=False, cache=False)
    assert len(naive.plan.stages) == 3
    assert len(fused.plan.stages) == 1
    same_outputs(pair.port.read(fused.artifacts["pickups"]),
                 pair.port.read(naive.artifacts["pickups"]))
    assert fused.stats["io"]["bytes_written"] < naive.stats["io"]["bytes_written"]


def test_expectation_failure_rolls_back(tmp_path):
    pair = Pair(tmp_path)
    try:
        pair.seed(500, mean_count=2.0)
        before = {s: s.catalog.head("main").commit_id for s in (pair.jax, pair.port)}
        with pytest.raises(PORT.ExpectationFailed, match="trips_expectation"):
            pair.run(taxi, branch="main")
        for side in (pair.jax, pair.port):
            assert side.catalog.head("main").commit_id == before[side]
            assert "pickups" not in side.catalog.tables(branch="main")
            assert all(not b.startswith("run_") for b in side.catalog.branches())
    finally:
        pair.close()


def test_replay_is_bit_identical(pair, seeded):
    first = pair.run(taxi, branch="feat_r")
    for side in (pair.jax, pair.port):
        newer = side.fmt.write(
            "taxi_table", side.ns.TAXI_SCHEMA,
            side.ns.make_taxi_data(100, np.random.default_rng(99)),
        )
        side.catalog.commit("feat_r", {"taxi_table": side.fmt.manifest_key(newer)})
    again = pair.replay(taxi, first.run_id)
    assert again.artifacts == first.artifacts
    assert again.merged_commit is None


def test_replay_rejects_changed_code(pair, seeded):
    first = pair.run(taxi, branch="feat_c")
    with pytest.raises(ValueError, match="pipeline code differs"):
        pair.replay(lambda ns: ns.build_taxi_pipeline(threshold=25.0), first.run_id)


def test_sync_query_interface(pair, seeded):
    sql = ("SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
           "GROUP BY pickup_location_id ORDER BY n DESC LIMIT 3")
    out = pair.port.runner.query(sql)
    same_outputs(out, pair.jax.runner.query(sql))
    keys, counts = np.unique(seeded["pickup_location_id"], return_counts=True)
    np.testing.assert_array_equal(out["n"], np.sort(counts)[::-1][:3])


def test_query_time_travel(pair):
    rng = {s: np.random.default_rng(0) for s in (pair.jax, pair.port)}
    first = {}
    for side in (pair.jax, pair.port):
        ns = side.ns
        s1 = side.fmt.write("taxi_table", ns.TAXI_SCHEMA, ns.make_taxi_data(100, rng[side]))
        first[side] = side.catalog.commit("main", {"taxi_table": side.fmt.manifest_key(s1)})
        s2 = side.fmt.write("taxi_table", ns.TAXI_SCHEMA, ns.make_taxi_data(300, rng[side]))
        side.catalog.commit("main", {"taxi_table": side.fmt.manifest_key(s2)})
    port = pair.port
    now = port.runner.query("SELECT COUNT(*) AS n FROM taxi_table")
    then = port.runner.query("SELECT COUNT(*) AS n FROM taxi_table",
                             commit_id=first[port].commit_id)
    assert now["n"][0] == 300 and then["n"][0] == 100
    same_outputs(then, pair.jax.runner.query(
        "SELECT COUNT(*) AS n FROM taxi_table", commit_id=first[pair.jax].commit_id))


# ------------------------------------------ the kernel-routed SQL node
@pytest.mark.parametrize("fusion", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("engine", ["auto", "kernel", "jnp"])
def test_kernel_routed_nodes_under_each_engine(pair, seeded, engine, fusion):
    """Pipeline SQL nodes reach fused_filter_agg through the same route as
    a query: under auto and kernel they are routed to the kernel, under
    jnp to the reference operators; the artifacts are the same under all
    three and equal to a numpy oracle.  On CPU tensors the wrapper takes
    its plain version, so the launch counter stays put."""
    before = ffa_ops.LAUNCHES
    cfg = {s: s.ns.PlannerConfig(fusion=fusion, sql_engine=engine) for s in (pair.jax, pair.port)}
    res = {s: s.runner.run(zone_pipeline(s.ns), branch="k", cache=False, planner_config=cfg[s])
           for s in (pair.jax, pair.port)}
    t = res[pair.port]
    assert_same_result(res[pair.jax], t, pair.jax, pair.port)
    assert ffa_ops.LAUNCHES == before
    routes = {n: r.engine_path for s in t.plan.stages for n, r in s.sql_routes.items()}
    want = "jnp" if engine == "jnp" else "kernel"
    assert routes == {"zone_riders": want, "dropoff_riders": want}
    assert t.checks == {"zone_riders_expectation": True}
    out = pair.port.read(t.artifacts["zone_riders"])
    m = seeded["pickup_at"] >= APRIL_1
    keys, counts = np.unique(seeded["pickup_location_id"][m], return_counts=True)
    np.testing.assert_array_equal(out["pickup_location_id"], keys)
    np.testing.assert_array_equal(out["n"], counts)
    riders = pair.port.read(t.artifacts["dropoff_riders"])
    want_riders = np.bincount(seeded["dropoff_location_id"], seeded["passenger_count"], 64)
    np.testing.assert_array_equal(riders["riders"], want_riders[riders["dropoff_location_id"]])
    # every engine gives the reference operators' artifacts
    ref = pair.port.runner.run(
        zone_pipeline(PORT), branch="ref", cache=False,
        planner_config=PORT.PlannerConfig(fusion=fusion, sql_engine="jnp"),
    )
    assert ref.artifacts == t.artifacts


def test_engine_flip_keeps_the_cache_warm(pair, seeded):
    """The chip's pipeline (the Appendix nodes plus zone_riders): under
    auto only zone_riders takes the kernel; sql_engine is no part of any
    fingerprint, so a run under jnp after one under auto executes
    nothing."""
    cold = pair.run(taxi_with_zone_riders, branch="c")
    routes = {n: r.engine_path for s in cold.plan.stages for n, r in s.sql_routes.items()}
    assert routes == {"trips": "jnp", "pickups": "jnp", "zone_riders": "kernel"}
    assert cold.checks == {"trips_expectation": True}
    res = {s: s.runner.run(taxi_with_zone_riders(s.ns), branch="w",
                           planner_config=s.ns.PlannerConfig(sql_engine="jnp"))
           for s in (pair.jax, pair.port)}
    t = res[pair.port]
    assert_same_result(res[pair.jax], t, pair.jax, pair.port)
    assert t.stats["cache"]["nodes_executed"] == 0
    assert t.artifacts == cold.artifacts


# --------------------------------------------- test_differential_cache.py
def _run(pair, build, branch, **kw):
    kw.setdefault("fusion", False)
    kw.setdefault("pushdown", False)
    kw.setdefault("cache", True)
    return pair.run(build, branch=branch, **kw)


def test_warm_rerun_executes_zero_stages(pair, seeded):
    cold = _run(pair, taxi, "b1")
    assert cold.stats["cache"] == {
        "enabled": True, "hits": 0, "nodes_executed": 3,
        "stages_executed": 3, "rehydrated": 0, "elided": 0, "bytes_saved": 0,
    }
    warm = _run(pair, taxi, "b2")
    assert warm.stats["cache"]["hits"] == 3
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.stats["cache"]["stages_executed"] == 0
    assert warm.stats["cache"]["bytes_saved"] > 0
    assert warm.artifacts == cold.artifacts
    assert warm.checks == {"trips_expectation": True}
    assert len(pair.port.read(warm.artifacts["pickups"])["counts"]) > 0


def test_warm_rerun_same_branch_hits(pair, seeded):
    cold = _run(pair, taxi, "main")
    warm = _run(pair, taxi, "main")
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.artifacts == cold.artifacts


def test_fused_plan_publishes_node_entries(pair, seeded):
    cold = pair.run(taxi, branch="f1", cache=True)
    assert len(cold.plan.stages) == 1
    warm = pair.run(taxi, branch="f2", cache=True)
    assert warm.stats["cache"]["hits"] == 2
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.stats["cache"]["elided"] == 1
    assert warm.artifacts == cold.artifacts


def test_edited_node_recomputes_only_dirty_cone(pair, seeded):
    _run(pair, taxi, "b1")
    res = _run(pair, lambda ns: ns.build_taxi_pipeline(threshold=5.0), "b2")
    assert res.stats["cache"]["hits"] == 2
    assert res.stats["cache"]["nodes_executed"] == 1
    assert res.checks == {"trips_expectation": True}


def test_input_snapshot_change_invalidates_everything(pair):
    pair.seed(2000, rng_seed=1)
    _run(pair, taxi, "b1")
    pair.seed(2500, rng_seed=2)
    res = _run(pair, taxi, "b2")
    assert res.stats["cache"]["hits"] == 0
    assert res.stats["cache"]["nodes_executed"] == 3


def test_param_change_invalidates(pair, seeded):
    _run(pair, taxi, "b1", params={"x": 1})
    hit = _run(pair, taxi, "b2", params={"x": 1})
    assert hit.stats["cache"]["nodes_executed"] == 0
    miss = _run(pair, taxi, "b3", params={"x": 2})
    assert miss.stats["cache"]["nodes_executed"] == 3


def test_fusion_flip_warm_run_executes_zero_nodes(pair, seeded):
    cold = pair.run(taxi, branch="c", fusion=True)
    flip = pair.run(taxi, branch="w1", fusion=False, pushdown=False)
    assert flip.stats["cache"]["nodes_executed"] == 0
    assert flip.artifacts["pickups"] == cold.artifacts["pickups"]
    res = {s: s.runner.run(taxi(s.ns), branch="w2",
                           planner_config=s.ns.PlannerConfig(fusion=True, max_stage_nodes=1))
           for s in (pair.jax, pair.port)}
    assert_same_result(res[pair.jax], res[pair.port], pair.jax, pair.port)
    assert res[pair.port].stats["cache"]["nodes_executed"] == 0


def test_unfused_to_fused_flip_is_warm(pair, seeded):
    _run(pair, taxi, "c")
    warm = pair.run(taxi, branch="w", fusion=True)
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.stats["cache"]["hits"] == 3


def test_fused_chain_cut_at_cache_boundary(pair, seeded):
    _run(pair, taxi, "c")
    res = pair.run(lambda ns: ns.build_taxi_pipeline(threshold=5.0), branch="w", fusion=True)
    assert res.stats["cache"]["nodes_executed"] == 1
    (stage,) = res.plan.stages
    assert stage.node_names == ("trips_expectation",)
    assert "trips" in stage.internal_inputs
    assert "trips" in res.plan.rehydrate


def test_no_cache_bypasses_in_both_directions(pair, seeded):
    _run(pair, taxi, "b1", cache=False)
    assert PORT.NodeCacheRegistry(pair.port.store).entries() == {}
    _run(pair, taxi, "b2", cache=True)
    res = _run(pair, taxi, "b3", cache=False)
    assert res.stats["cache"] == {
        "enabled": False, "hits": 0, "nodes_executed": 3,
        "stages_executed": 3, "rehydrated": 0, "elided": 0, "bytes_saved": 0,
    }


def test_replay_never_uses_the_cache(pair, seeded):
    first = pair.run(taxi, branch="r1", cache=True)
    pair.run(taxi, branch="r2", cache=True)
    again = pair.replay(taxi, first.run_id)
    assert again.artifacts == first.artifacts


def test_failed_audit_rolls_back_cache_entries(pair):
    pair.seed(500, mean_count=2.0)
    with pytest.raises(PORT.ExpectationFailed):
        _run(pair, taxi, "main")
    for side in (pair.jax, pair.port):
        assert side.ns.NodeCacheRegistry(side.store).entries() == {}
        assert side.runner.registry.get(1).stage_cache == {}
    pair.seed(2000, rng_seed=3)
    res = _run(pair, taxi, "main")
    assert res.stats["cache"]["hits"] == 0


def _legacy_plan(side, pipeline):
    ns = side.ns
    snap = side.fmt.load_snapshot(side.catalog.table_key("taxi_table"))
    logical = ns.build_logical_plan(pipeline, external_schemas={"taxi_table": snap.schema})
    kw = {"device": "cpu"} if ns is PORT else {}
    return ns.build_physical_plan(
        logical, {"taxi_table": snap},
        config=ns.PlannerConfig(fusion=False, pushdown=False),
        ctx=ns.RunContext("main", 1, {}), **kw,
    )


def test_legacy_stage_entries_upgrade_one_way(pair, seeded):
    cold = _run(pair, taxi, "b1", cache=False)
    for side in (pair.jax, pair.port):
        reg = side.ns.NodeCacheRegistry(side.store)
        assert reg.entries() == {}
        for stage in _legacy_plan(side, taxi(side.ns)).stages:
            reg.put_legacy(side.ns.NodeCacheEntry(
                fingerprint=stage.transitive_fingerprint,
                outputs={n: cold.artifacts[n] for n in stage.outputs},
                checks={c: True for c in stage.checks},
                output_bytes=128, run_id=cold.run_id, created_at=time.time(),
            ))
        assert side.store.list_refs("stagecache")
    warm = _run(pair, taxi, "b2")
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.artifacts == cold.artifacts
    for side in (pair.jax, pair.port):
        assert side.store.list_refs("stagecache") == {}
        assert {e.node for e in side.ns.NodeCacheRegistry(side.store).entries().values()} == {
            "trips", "trips_expectation", "pickups",
        }
    fused = pair.run(taxi, branch="b3", fusion=True)
    assert fused.stats["cache"]["nodes_executed"] == 0


def test_failed_audit_leaves_legacy_adoption_unapplied(pair):
    pair.seed(800, mean_count=2.0)
    ok = _run(pair, lambda ns: ns.build_taxi_pipeline(threshold=1.0), "ok", cache=False)
    for side in (pair.jax, pair.port):
        trips_stage = next(
            s for s in _legacy_plan(side, taxi(side.ns)).stages if s.node_names == ("trips",)
        )
        side.ns.NodeCacheRegistry(side.store).put_legacy(side.ns.NodeCacheEntry(
            fingerprint=trips_stage.transitive_fingerprint,
            outputs={"trips": ok.artifacts["trips"]}, checks={},
            output_bytes=64, run_id=1, created_at=time.time(),
        ))
    with pytest.raises(PORT.ExpectationFailed):
        _run(pair, taxi, "main")
    for side in (pair.jax, pair.port):
        assert side.store.list_refs("nodecache") == {}
        assert len(side.store.list_refs("stagecache")) == 1


# ------------------------------------ test_parallel_runner.py, via Runner
PARITY_ROWS = 4_000
PARALLELISMS = (1, 2, 8)
SCHEDULE_MATRIX = [
    (schedule, streaming, p)
    for schedule in ("stage_id", "critical_path")
    for streaming in (False, True)
    for p in PARALLELISMS
]


def fanout_pipeline(ns, threshold=10.0):
    """A diamond with a 3-way fan-out middle, as in test_parallel_runner.py:
    trips -> (m0, m1, m2) -> combine, plus an audit.  The python nodes use
    each package's own array library."""
    p = ns.Pipeline("parallel_parity")
    p.sql(
        "trips",
        """
        SELECT pickup_location_id, passenger_count as count,
               dropoff_location_id
        FROM taxi_table
        WHERE pickup_at >= '2019-04-01'
        """,
    )

    @p.python
    def trips_expectation(ctx, trips):
        return trips.mean("count") > threshold

    if ns is PORT:
        def sorted_f32(col):
            return torch.sort(col.to(torch.float32)).values
    else:
        def sorted_f32(col):
            import jax.numpy as jnp

            return jnp.sort(col.astype(jnp.float32))

    for i in range(3):

        def make_model(i):
            def fn(ctx, trips):
                return {"stat": sorted_f32(trips.column("count")) * (i + 1)}

            fn.__name__ = f"m{i}"
            return fn

        p.python(make_model(i))

    @p.python
    def combine(ctx, m0, m1):
        return {"delta": m1.column("stat") - m0.column("stat")}

    return p


def _parity_run(tmp_path, ns, parallelism, *, threshold=10.0, schedule="critical_path",
                streaming=None, name=""):
    cfg = ns.ExecutorConfig(max_workers=8, max_concurrent_stages=parallelism)
    side = Side(ns, tmp_path / f"{name}{schedule}-{streaming}-{parallelism}", cfg,
                shard_rows=512)
    try:
        side.seed(PARITY_ROWS, rng_seed=7)
        try:
            res = side.runner.run(
                fanout_pipeline(ns, threshold), fusion=False, pushdown=False,
                parallelism=parallelism, schedule=schedule, streaming=streaming,
            )
            state, err = "SUCCESS", None
        except ns.ExpectationFailed as e:
            res, state, err = None, "AUDIT_FAILED", e
        out = {
            "state": state,
            "artifacts": dict(res.artifacts) if res else {},
            "checks": dict(res.checks) if res else {"trips_expectation": False},
            "cache_entries": {
                fp: dict(e.outputs)
                for fp, e in ns.NodeCacheRegistry(side.store).entries().items()
            },
            "node_fps": dict(res.plan.node_fingerprints) if res else None,
            "scheduler": res.stats["scheduler"] if res else {},
            "parallelism": res.stats["parallelism"] if res else None,
            "branches": side.catalog.branches(),
            "head_tables": side.catalog.tables(),
            "outputs": {n: side.read(k) for n, k in (res.artifacts.items() if res else ())},
            "error": str(err) if err else None,
        }
        if res is not None:
            out["messages"] = _stage_commit_messages(side, res)
        return out
    finally:
        side.close()


def _stage_commit_messages(side, res):
    merge = side.catalog.get_commit(res.merged_commit)
    messages = []
    cur = side.catalog.get_commit_opt(merge.extra_parent_id)
    while cur is not None and cur.author == "runner":
        messages.append(cur.message)
        cur = side.catalog.get_commit_opt(cur.parent_id)
    return [m for m in reversed(messages) if f"run {res.run_id} stage" in m]


@pytest.fixture(scope="module")
def parity_base(tmp_path_factory):
    """The sequential anchor (stage_id, streaming off, parallelism 1) on
    each package."""
    tmp = tmp_path_factory.mktemp("parity")
    return {
        "jax": _parity_run(tmp, JAX, 1, schedule="stage_id", streaming=False, name="jax-"),
        "torch": _parity_run(tmp, PORT, 1, schedule="stage_id", streaming=False, name="torch-"),
    }


def test_parity_anchor_equals_the_jax_package(parity_base):
    j, t = parity_base["jax"], parity_base["torch"]
    assert t["state"] == j["state"] == "SUCCESS"
    assert t["artifacts"] == j["artifacts"]
    assert t["checks"] == j["checks"]
    assert t["head_tables"] == j["head_tables"]
    assert t["messages"] == j["messages"]
    for name in t["outputs"]:
        same_outputs(t["outputs"][name], j["outputs"][name])
    assert len(t["artifacts"]) == 5  # trips, m0..m2, combine
    # the python nodes hash their own source, which differs between the
    # packages; the SQL node and the audit's text are the same
    assert t["node_fps"]["trips"] == j["node_fps"]["trips"]


@pytest.mark.parametrize(
    "schedule,streaming,parallelism",
    [c for c in SCHEDULE_MATRIX if c != ("stage_id", False, 1)],
)
def test_parallelism_parity_matrix(tmp_path, parity_base, schedule, streaming, parallelism):
    """Ordering mode, streaming handoff and parallelism change throughput
    only: byte-identical manifests, verdicts, cache entries, fingerprints
    and stage-ordered commit history against the sequential anchor."""
    base = parity_base["torch"]
    got = _parity_run(tmp_path, PORT, parallelism, schedule=schedule, streaming=streaming)
    assert got["state"] == "SUCCESS"
    assert got["parallelism"] == parallelism
    for key in ("artifacts", "checks", "cache_entries", "node_fps", "head_tables", "messages"):
        assert got[key] == base[key], key
    assert got["scheduler"]["schedule"] == schedule
    assert got["scheduler"]["streaming"] is streaming
    # combine consumes m0 and m1: it ran after both (m1 = 2 m0, delta = m0)
    np.testing.assert_allclose(got["outputs"]["combine"]["delta"], got["outputs"]["m0"]["stat"])


@pytest.mark.parametrize("schedule,streaming,parallelism", [
    ("stage_id", False, 1), ("stage_id", True, 8),
    ("critical_path", False, 8), ("critical_path", True, 8),
])
def test_parallel_audit_failure_rolls_back_identically(tmp_path, schedule, streaming, parallelism):
    """A mid-DAG audit failure rolls back the same way in every mode:
    head unmoved, nothing cached, no run_* branch left; the sequential
    case also against the JAX package's error."""
    kw = dict(threshold=10_000.0, schedule=schedule, streaming=streaming)
    t = _parity_run(tmp_path, PORT, parallelism, name="torch-", **kw)
    assert t["state"] == "AUDIT_FAILED"
    assert t["head_tables"] == {"taxi_table": t["head_tables"]["taxi_table"]}
    assert t["cache_entries"] == {}
    assert [b for b in t["branches"] if b.startswith("run_")] == []
    if parallelism == 1:
        j = _parity_run(tmp_path, JAX, parallelism, name="jax-", **kw)
        assert (t["error"], t["head_tables"]) == (j["error"], j["head_tables"])


# ------------------------------------------------------------- the guard
def test_run_and_replay_need_a_serverless_executor(tmp_path):
    side = Side(PORT, tmp_path / "lake")
    try:
        side.seed()
        runner = PORT.Runner(side.catalog, side.fmt, device="cpu")
        with pytest.raises(TypeError, match="ServerlessExecutor"):
            runner.run(taxi(PORT))
        with pytest.raises(TypeError, match="ServerlessExecutor"):
            runner.replay(taxi(PORT), 1)
        # the query path keeps working without one (serial scan)
        assert runner.query("SELECT COUNT(*) AS n FROM taxi_table")["n"][0] == N_ROWS
    finally:
        side.close()
