"""Pipeline planning: the port's ``core/pipeline.py``, ``logical.py``,
``snapshot.py`` and ``physical.py`` against the JAX package's.

The same seeded taxi data (2,000 rows, ``shard_rows=128``) goes into one
lake per package; the same pipelines are planned by both.  Held equal:
pipeline and node fingerprints, logical plans, and every field of the
physical plans that does not hold code — stage node sets, scans
(predicates, columns, pruned shards, bytes), inputs, outputs, checks,
parent stages, resources, engine routes (with their traces), node
fingerprints, ``Stage.fingerprint`` and the transitive (legacy cache)
fingerprint — plus the scheduler's cost arithmetic and the errors
planning raises.  The one thing not held equal is the fingerprint of
the ``FunctionSpec`` a stage is dispatched under: it hashes the stage
function's own source, which is each package's ``_make_stage_fn``.
"""
import numpy as np
import pytest
import torch

import repro.core
import repro.core.physical as jphys
import repro.core.runner
import repro.core.snapshot
import repro.examples_data
import repro.io
import repro.table
import repro_torch.core
import repro_torch.core.physical as pphys
import repro_torch.core.runner
import repro_torch.core.snapshot
import repro_torch.examples_data
import repro_torch.io
import repro_torch.table
from repro_torch.core import PipelineError

torch.set_num_threads(1)

N_ROWS = 2_000

ZONE_RIDERS = (
    "SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01' GROUP BY pickup_location_id "
    "ORDER BY pickup_location_id"
)


def taxi(root, **kw):
    return root.examples_data.build_taxi_pipeline(**kw)


def taxi_with_zone_riders(root):
    p = root.examples_data.build_taxi_pipeline()
    p.sql("zone_riders", ZONE_RIDERS)
    return p


def zone_pipeline(root):
    p = root.core.Pipeline("zone_demo")
    p.sql("zone_riders", ZONE_RIDERS)
    p.sql("dropoff_riders", "SELECT dropoff_location_id, SUM(passenger_count) AS riders "
                            "FROM taxi_table GROUP BY dropoff_location_id")

    @p.python
    def zone_riders_expectation(ctx, zone_riders):
        return zone_riders.sum("n") > 0

    return p


def mixed_pipeline(root):
    """Fan-out, a join of two nodes and a node fed by a node: fusion cuts,
    parent stages and pushdown refusal all show."""
    p = root.core.Pipeline("mixed")
    p.sql("trips", "SELECT pickup_location_id, passenger_count FROM taxi_table "
                   "WHERE pickup_at >= '2019-04-01' AND passenger_count > 20")
    p.sql("by_zone", "SELECT pickup_location_id, SUM(passenger_count) AS riders "
                     "FROM trips GROUP BY pickup_location_id")
    p.sql("late", "SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
                  "WHERE pickup_at >= '2019-04-20' GROUP BY pickup_location_id")
    p.sql("joined", "SELECT b.pickup_location_id, b.riders, l.n FROM by_zone AS b "
                    "JOIN late AS l ON b.pickup_location_id = l.pickup_location_id",
          materialize=True)
    p.sql("top", "SELECT pickup_location_id, riders FROM joined ORDER BY riders DESC LIMIT 5")

    @p.python
    def joined_expectation(ctx, joined):
        return joined.count() > 0

    return p


PIPELINES = {
    "taxi": taxi,
    "taxi_threshold_5": lambda root: taxi(root, threshold=5.0),
    "taxi_with_zone_riders": taxi_with_zone_riders,
    "zone": zone_pipeline,
    "mixed": mixed_pipeline,
}

CONFIGS = {
    "fused": dict(),
    "isomorphic": dict(fusion=False, pushdown=False),
    "unfused_pushdown": dict(fusion=False),
    "max_stage_nodes_1": dict(max_stage_nodes=1),
    "engine_kernel": dict(sql_engine="kernel"),
    "engine_jnp": dict(sql_engine="jnp"),
}


class Lake:
    def __init__(self, root, path):
        self.root = root
        store = root.io.ObjectStore(path)
        self.store = store
        self.fmt = root.table.TableFormat(store, shard_rows=128)
        data = root.examples_data.make_taxi_data(N_ROWS, np.random.default_rng(0))
        self.snap = self.fmt.write("taxi_table", root.examples_data.TAXI_SCHEMA, data)
        self.snapshots = {"taxi_table": self.snap}

    def plan(self, pipeline, config, *, params=None, cache=None, run_id=1, branch="main",
             input_fingerprints=None):
        core = self.root.core
        logical = core.build_logical_plan(
            pipeline, external_schemas={t: s.schema for t, s in self.snapshots.items()}
        )
        kw = {"device": "cpu"} if self.root is repro_torch else {}
        plan = self.root.core.physical.build_physical_plan(
            logical, self.snapshots, config=core.PlannerConfig(**config),
            ctx=self.root.core.runner.RunContext(branch, run_id, dict(params or {})),
            cache=cache, input_fingerprints=input_fingerprints, **kw,
        )
        return logical, plan


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    base = tmp_path_factory.mktemp("plan")
    return Lake(repro, base / "jax"), Lake(repro_torch, base / "torch")


def scan_view(spec):
    p = spec.plan
    return (spec.table, spec.estimated_bytes, list(p.columns), p.projection,
            [(x.column, x.op, x.value) for x in p.predicates],
            [s.to_json_dict() for s in p.shards], p.pruned_shards, p.pruned_columns)


def stage_view(s):
    return {
        "stage_id": s.stage_id,
        "node_names": s.node_names,
        "scans": {t: scan_view(v) for t, v in s.scans.items()},
        "internal_inputs": s.internal_inputs,
        "input_order": s.input_order,
        "outputs": s.outputs,
        "checks": s.checks,
        "resources": (s.resources.memory_gb, s.resources.devices, s.resources.estimated_bytes),
        "fingerprint": s.fingerprint,
        "transitive_fingerprint": s.transitive_fingerprint,
        "parent_stages": s.parent_stages,
        "sql_routes": {n: r.to_json_dict() for n, r in s.sql_routes.items()},
    }


def plan_view(logical, plan):
    return {
        "order": tuple(logical.order),
        "outputs": tuple(logical.outputs),
        "pipeline_fingerprint": logical.pipeline_fingerprint,
        "schemas": {t: s.to_json_dict() for t, s in logical.external_schemas.items()},
        "node_fingerprints": plan.node_fingerprints,
        "stages": [stage_view(s) for s in plan.stages],
        "rehydrate": plan.rehydrate,
        "cached_checks": plan.cached_checks,
        "elided": plan.elided,
        "num_materializations": plan.num_materializations,
        "nodes_executed": plan.nodes_executed,
        "describe": plan.describe(),
    }


def test_node_fingerprints_equal_the_jax_packages():
    """The Appendix pipeline's text is the same in both packages, so its
    pipeline and node fingerprints are too."""
    for build in (taxi, taxi_with_zone_riders):
        j, t = build(repro), build(repro_torch)
        assert t.fingerprint == j.fingerprint
        assert {n: v.fingerprint for n, v in t.nodes.items()} == \
            {n: v.fingerprint for n, v in j.nodes.items()}
        assert (t.artifacts, t.expectations, t.external_sources()) == \
            (j.artifacts, j.expectations, j.external_sources())


@pytest.mark.parametrize("config", CONFIGS, ids=str)
@pytest.mark.parametrize("pipeline", PIPELINES, ids=str)
def test_plans_equal_the_jax_packages(lakes, pipeline, config):
    jl, tl = lakes
    build, cfg = PIPELINES[pipeline], CONFIGS[config]
    if cfg.get("sql_engine") == "kernel" and pipeline != "zone":
        # forcing the kernel on a node it cannot take is a planning error
        errors = []
        for lake in lakes:
            with pytest.raises(Exception) as info:
                lake.plan(build(lake.root), cfg)
            errors.append(info.value)
        assert type(errors[1]).__name__ == type(errors[0]).__name__ == "RouteError"
        assert str(errors[1]) == str(errors[0])
        return
    j = plan_view(*jl.plan(build(repro), cfg))
    t = plan_view(*tl.plan(build(repro_torch), cfg))
    assert t == j


def test_kernel_route_in_the_chips_pipeline(lakes):
    """Under auto only zone_riders takes the kernel: pickups groups by two
    keys and reads the node-sourced trips, which has no shard statistics."""
    _, plan = lakes[1].plan(taxi_with_zone_riders(repro_torch), {})
    routes = {n: r.engine_path for s in plan.stages for n, r in s.sql_routes.items()}
    assert routes == {"trips": "jnp", "pickups": "jnp", "zone_riders": "kernel"}
    stage = next(s for s in plan.stages if "zone_riders" in s.node_names)
    assert stage.node_names == ("zone_riders",) and stage.scans["taxi_table"].predicates


def test_function_spec_fingerprint_is_the_one_difference(lakes):
    """Not held equal, by design: the FunctionSpec a stage is dispatched
    under hashes the stage function's source (fingerprint_fn), and each
    package composes stages in its own _make_stage_fn."""
    j = jphys.stage_function_spec("taxi_demo", lakes[0].plan(taxi(repro), {})[1].stages[0])
    t = pphys.stage_function_spec("taxi_demo", lakes[1].plan(taxi(repro_torch), {})[1].stages[0])
    assert (t.name, t.static_config, vars(t.resources), t.jit) == \
        (j.name, j.static_config, vars(j.resources), j.jit)
    assert t.fingerprint != j.fingerprint


def test_planning_is_free_of_run_identity_and_params_change_everything(lakes):
    tl = lakes[1]
    a = tl.plan(taxi(repro_torch), CONFIGS["isomorphic"])[1]
    b = tl.plan(taxi(repro_torch), CONFIGS["isomorphic"], run_id=99, branch="feat")[1]
    c = tl.plan(taxi(repro_torch), CONFIGS["isomorphic"], params={"x": 1})[1]
    fps = lambda p: [s.transitive_fingerprint for s in p.stages]  # noqa: E731
    assert fps(a) == fps(b) and len(set(fps(a))) == len(fps(a))
    assert a.node_fingerprints == b.node_fingerprints
    assert not set(c.node_fingerprints.values()) & set(a.node_fingerprints.values())
    j = lakes[0].plan(taxi(repro), CONFIGS["isomorphic"], params={"x": 1})[1]
    assert c.node_fingerprints == j.node_fingerprints


def test_node_fingerprints_ignore_fusion_config(lakes):
    tl = lakes[1]
    fps = [tl.plan(taxi(repro_torch), cfg)[1].node_fingerprints
           for cfg in (CONFIGS["fused"], CONFIGS["isomorphic"], CONFIGS["max_stage_nodes_1"])]
    assert fps[0] == fps[1] == fps[2]
    assert len(set(fps[0].values())) == 3


@pytest.mark.parametrize("pipeline", PIPELINES, ids=str)
def test_blast_radius_equals_the_jax_packages(lakes, pipeline):
    build = PIPELINES[pipeline]
    jl, tl = lakes
    j = jphys.fingerprint_blast_radius(jl.plan(build(repro), {})[0])
    t = pphys.fingerprint_blast_radius(tl.plan(build(repro_torch), {})[0])
    assert t == j


def _cache_with(root, store, entries):
    reg = root.core.NodeCacheRegistry(store)
    reg.clear()
    for e in entries:
        reg.put(e)
    return root.core.snapshot.CacheView(reg)


@pytest.mark.parametrize("config", ["fused", "isomorphic", "max_stage_nodes_1"])
@pytest.mark.parametrize("cached", [("pickups",), ("trips", "pickups"),
                                    ("trips", "trips_expectation", "pickups")])
def test_plans_around_the_cache_equal_the_jax_packages(lakes, config, cached):
    """A cache view holding some nodes: the same rehydrations, elisions,
    cut stages and restored-parent fingerprints in both packages."""
    views = []
    for lake in lakes:
        root = lake.root
        _, cold = lake.plan(taxi(root), CONFIGS[config])
        entries = [
            root.core.NodeCacheEntry(
                fingerprint=cold.node_fingerprints[n],
                outputs={} if n.endswith("_expectation") else {n: f"key-{n}"},
                checks={n: True} if n.endswith("_expectation") else {},
                output_bytes=100, run_id=1, created_at=0.0, node=n,
            )
            for n in cached
        ]
        cache = _cache_with(root, lake.store, entries)
        views.append(plan_view(*lake.plan(taxi(root), CONFIGS[config], cache=cache)))
    assert views[1] == views[0]


def test_pipeline_errors_equal_the_jax_packages(lakes):
    """Planning and declaration errors: the same type and message."""

    def cases(root):
        Pipeline = root.core.Pipeline

        def unknown_table():
            p = Pipeline("bad")
            p.sql("x", "SELECT a FROM nowhere")
            return p

        def unknown_column():
            p = Pipeline("bad")
            p.sql("x", "SELECT nope FROM taxi_table")
            return p

        def cycle():
            p = Pipeline("bad")
            p.sql("a", "SELECT pickup_at FROM b")
            p.sql("b", "SELECT pickup_at FROM a")
            return p

        def duplicate():
            p = Pipeline("bad")
            p.sql("a", "SELECT pickup_at FROM taxi_table")
            p.sql("a", "SELECT pickup_at FROM taxi_table")

        def no_ctx():
            p = Pipeline("bad")

            @p.python
            def f(trips):
                return trips

        def no_parents():
            p = Pipeline("bad")

            @p.python
            def g(ctx):
                return {}

        return [unknown_table, unknown_column, cycle, duplicate, no_ctx, no_parents]

    for jcase, tcase in zip(cases(repro), cases(repro_torch)):
        got = []
        for lake, case in zip(lakes, (jcase, tcase)):
            with pytest.raises(Exception) as info:
                p = case()
                lake.plan(p, {})
            got.append(info.value)
        assert type(got[1]).__name__ == type(got[0]).__name__, jcase.__name__
        assert str(got[1]) == str(got[0]), jcase.__name__
        if type(got[0]).__name__ == "PipelineError":
            assert isinstance(got[1], PipelineError)


# ------------------------------------- the scheduler's cost arithmetic
DAGS = [
    ({0: 1.0, 1: 2.0, 2: 4.0}, {0: (), 1: (0,), 2: (1,)}),
    ({0: 1.0, 1: 0.5, 2: 10.0, 3: 1.0}, {0: (), 1: (0,), 2: (0,), 3: (1, 2)}),
    ({0: 1.0, 1: 5.0, 2: 2.0}, {0: (), 1: (), 2: (0,)}),
    ({0: 1.0, 1: 1.0}, {0: (), 1: ()}),
    ({}, {}),
]


@pytest.mark.parametrize("costs,parents", DAGS)
def test_longest_path_and_critical_path_equal_the_jax_packages(costs, parents):
    assert pphys.longest_path_weights(costs, parents) == jphys.longest_path_weights(costs, parents)
    assert pphys.critical_path_ids(costs, parents) == jphys.critical_path_ids(costs, parents)


def test_longest_path_on_the_diamond():
    costs, parents = DAGS[1]
    assert pphys.longest_path_weights(costs, parents) == {0: 12.0, 1: 1.5, 2: 11.0, 3: 1.0}
    assert pphys.critical_path_ids(costs, parents) == [0, 2, 3]


def test_stage_costs_equal_the_jax_packages(lakes):
    """Cold (bytes heuristic) and seeded (latency medians keyed by each
    package's own spec fingerprints) estimates, on the mixed pipeline."""
    jl, tl = lakes
    jstages = jl.plan(mixed_pipeline(repro), {"fusion": False})[1].stages
    tstages = tl.plan(mixed_pipeline(repro_torch), {"fusion": False})[1].stages
    assert pphys.estimate_stage_costs(tstages, "p", {}) == _as_port(
        jphys.estimate_stage_costs(jstages, "p", {}))
    jm = {jphys.stage_function_spec("p", s).fingerprint: 0.5 + s.stage_id for s in jstages[::2]}
    tm = {pphys.stage_function_spec("p", s).fingerprint: 0.5 + s.stage_id for s in tstages[::2]}
    got = pphys.estimate_stage_costs(tstages, "p", tm)
    assert got == _as_port(jphys.estimate_stage_costs(jstages, "p", jm))
    assert {c.source for c in got.values()} == {"latency", "bytes"}


def _as_port(costs):
    return {sid: pphys.StageCost(**vars(c)) for sid, c in costs.items()}


def test_registry_roundtrip_and_invalidate(tmp_path):
    reg = repro_torch.core.StageCacheRegistry(repro_torch.io.ObjectStore(tmp_path / "lake"))
    entry = repro_torch.core.StageCacheEntry(
        fingerprint="abc123", outputs={"t": "key1"}, checks={"c": True},
        output_bytes=42, run_id=7, created_at=0.0,
    )
    reg.put(entry)
    assert reg.get("abc123") == entry
    assert reg.entries() == {"abc123": entry}
    reg.invalidate("abc123")
    assert reg.get("abc123") is None
    assert reg.get("missing") is None
