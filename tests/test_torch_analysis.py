"""The static analysis plane, ``repro_torch.analysis``, against
``repro.analysis``: the lint preflight and the explain plane.

Lint cases register the same function objects and SQL text into each
package's ``Pipeline`` / ``Project`` and compare the two reports whole
(``to_json_dict``: rule ids, nodes, severities, messages, hints, file
and line, snippets, suppressions, blast radius).  Explain cases run the
same queries and pipelines through each package's ``Client`` on lakes of
their own and compare ``to_json_dict()`` whole; each also checks, as the
reference does, that the static verdict equals what the runtime did.
Each case keeps the reference test's own assertions, applied to the port.

Mirrored: ``test_lint.py`` and ``test_explain.py``, with their Client
and CLI cases.  Not mirrored: ``test_examples_lint_clean``, whose
example files import the JAX package (the port's examples are not
written yet).  On top: the port's D102 also flags torch's global-stream
draws made without ``generator=``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import BOTH, JAX, PORT, handle_summary, parity

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def taxi_schemas(pkg):
    return {"taxi_table": pkg.table.Schema.of(
        pickup_at="int32", pickup_location_id="int32",
        passenger_count="int32", dropoff_location_id="int32",
    )}


def joined_schemas(pkg):
    S = pkg.table.Schema
    return {
        "trips": S.of(zone="int32", zone_i8="int8", score="float32", fare="int32"),
        "zones": S.of(zone_id="int32", borough="int32", weight="int32"),
    }


#: module-level shared state the C-rule cases deliberately traffic in
SHARED_LOG: list = []
TOTALS: dict = {}


# ---------------------------------------------------- node functions
# Defined once and registered into both packages, so the two linters read
# the same source lines.
def doubled(ctx, trips):
    return {"x": trips["fare_amount"] * 2}  # not a trips column


def stats(ctx, taxi_table):
    return {"m": np.asarray([taxi_table.mean("nonexistent")])}


def stamped(ctx, taxi_table):
    import time

    return {"t": np.asarray([time.time()], dtype=np.float32)}


def noisy(ctx, taxi_table):
    rng = np.random.default_rng()
    return {"x": rng.random(4).astype(np.float32)}


def quiet(ctx, taxi_table):
    rng = np.random.default_rng(7)
    return {"x": rng.random(4).astype(np.float32)}


def legacy(ctx, taxi_table):
    return {"x": np.random.rand(4).astype(np.float32)}


def tagged(ctx, taxi_table):
    import uuid

    run_tag = uuid.uuid4()
    return {"x": np.asarray([run_tag.int % 7], dtype=np.int32)}


def configured(ctx, taxi_table):
    import os

    mode = os.environ.get("MODE", "fast")
    return {"x": np.asarray([len(mode)], dtype=np.int32)}


def sneaky(ctx, taxi_table):
    with open("side.csv") as fh:
        n = len(fh.read())
    return {"x": np.asarray([n], dtype=np.int32)}


def leaky(ctx, taxi_table):
    global _COUNTER  # noqa: PLW0603
    _COUNTER = 1
    return {"x": np.asarray([_COUNTER], dtype=np.int32)}


def mutator(ctx, taxi_table):
    taxi_table.columns["pickup_at"] = np.zeros(1, dtype=np.int32)
    return {"x": np.zeros(1, dtype=np.int32)}


def noisy_scoped(ctx, taxi_table):
    rng = np.random.default_rng()  # repro: noqa[D102]
    return {"x": rng.random(4).astype(np.float32)}


def noisy_bare(ctx, taxi_table):
    import time
    t = time.time()  # repro: noqa
    return {"x": np.asarray([t], dtype=np.float32)}


def noisy_wrong(ctx, taxi_table):
    rng = np.random.default_rng()  # repro: noqa[D101]
    return {"x": rng.random(4).astype(np.float32)}


def check(ctx, taxi_table):  # audits the raw input, not an artifact
    return True


def first_writer(ctx, taxi_table):
    SHARED_LOG.append("first")
    return {"x": np.zeros(1, dtype=np.int32)}


def second_writer(ctx, taxi_table):
    SHARED_LOG.append("second")
    return {"x": np.zeros(1, dtype=np.int32)}


def base_writer(ctx, taxi_table):
    SHARED_LOG.append("base")
    return {"x": np.zeros(1, dtype=np.int32)}


def downstream_writer(ctx, base_writer):
    SHARED_LOG.append("down")
    return {"x": np.zeros(1, dtype=np.int32)}


def totals_writer(ctx, taxi_table):
    TOTALS["rows"] = 1
    return {"x": np.zeros(1, dtype=np.int32)}


def totals_reader(ctx, taxi_table):
    n = TOTALS.get("rows", 0)
    return {"x": np.full(1, n, dtype=np.int32)}


def muted_one(ctx, taxi_table):
    SHARED_LOG.append("a")  # repro: noqa[C502]
    return {"x": np.zeros(1, dtype=np.int32)}


def muted_two(ctx, taxi_table):
    SHARED_LOG.append("b")  # repro: noqa[C502]
    return {"x": np.zeros(1, dtype=np.int32)}


def torch_draws(ctx, taxi_table):
    g = torch.Generator().manual_seed(0)
    seeded = torch.rand(4, generator=g)
    drawn = torch.randn(4)
    return {"x": seeded + drawn}


def torch_like_draw(ctx, taxi_table):
    return {"x": torch.rand_like(taxi_table.column("pickup_at").float())}


def torch_seeded_draws(ctx, taxi_table):
    g = torch.Generator().manual_seed(0)
    perm = torch.randperm(4, generator=g)
    coin = torch.bernoulli(torch.full((4,), 0.5), generator=g)
    return {"x": perm.float() + coin}


# ---------------------------------------------------------- lint cases
def _project(pkg, name, *fns, sql=(), expectations=()):
    proj = pkg.api_project.Project(name)
    for node, text in sql:
        proj.sql(node, text)
    for fn in fns:
        proj.model()(fn)
    for fn in expectations:
        proj.expectation()(fn)
    return proj.pipeline()


def _pipe(pkg, name, *sql):
    p = pkg.Pipeline(name)
    for node, text in sql:
        p.sql(node, text)
    return p


TRIPS_2 = [("trips", "SELECT pickup_at, passenger_count FROM taxi_table")]

#: case -> (build(pkg) -> pipeline, schemas(pkg) or None, rule ids the
#: reference test expects to fire)
LINT_CASES = {
    "l001_sql": (lambda k: _pipe(k, "t", ("trips", "SELECT total_fare FROM taxi_table")),
                 taxi_schemas, {"L001"}),
    "l001_python_ast": (lambda k: _project(k, "l001_py", doubled, sql=TRIPS_2), taxi_schemas, {"L001"}),
    "l001_columnar_method_arg": (lambda k: _project(k, "l001_method", stats), taxi_schemas, {"L001"}),
    "l002_group_key_type": (
        lambda k: _pipe(k, "t", ("by_amount", "SELECT amount, COUNT(*) AS n FROM orders GROUP BY amount")),
        lambda k: {"orders": k.table.Schema.of(amount="float32")}, {"L002"}),
    "l003_order_by": (lambda k: _pipe(k, "t", (
        "pickups", "SELECT pickup_location_id, COUNT(*) AS counts FROM taxi_table "
        "GROUP BY pickup_location_id ORDER BY passenger_count DESC")), taxi_schemas, {"L003"}),
    "l004_unknown_table": (lambda k: _pipe(k, "t", ("trips", "SELECT x FROM no_such_table")),
                           taxi_schemas, {"L004"}),
    "l004_without_catalog": (lambda k: _pipe(k, "t", ("trips", "SELECT x FROM no_such_table")),
                             None, {"!L004"}),
    "clean": (lambda k: _pipe(k, "t", (
        "pickups", "SELECT pickup_location_id, COUNT(*) AS counts FROM taxi_table "
        "GROUP BY pickup_location_id ORDER BY counts DESC")), taxi_schemas, {"!L001", "!L003"}),
    "schema_propagates": (lambda k: _pipe(k, "t", ("narrow", "SELECT pickup_at FROM taxi_table"),
                                          ("later", "SELECT passenger_count FROM narrow")),
                          taxi_schemas, {"L001"}),
    "d101": (lambda k: _project(k, "d101", stamped), taxi_schemas, {"D101"}),
    "d102": (lambda k: _project(k, "d102", noisy), taxi_schemas, {"D102"}),
    "d102_seeded": (lambda k: _project(k, "d102_ok", quiet), taxi_schemas, {"!D102"}),
    "d102_legacy_global": (lambda k: _project(k, "d102_legacy", legacy), taxi_schemas, {"D102"}),
    "d103": (lambda k: _project(k, "d103", tagged), taxi_schemas, {"D103"}),
    "d104": (lambda k: _project(k, "d104", configured), taxi_schemas, {"D104"}),
    "d105": (lambda k: _project(k, "d105", sneaky), taxi_schemas, {"D105"}),
    "d106": (lambda k: _project(k, "d106", leaky), taxi_schemas, {"D106"}),
    "d107": (lambda k: _project(k, "d107", mutator), taxi_schemas, {"D107"}),
    "noqa_scoped": (lambda k: _project(k, "noqa_scoped", noisy_scoped), taxi_schemas, {"!D102"}),
    "noqa_bare": (lambda k: _project(k, "noqa_bare", noisy_bare), taxi_schemas, {"!D101"}),
    "noqa_wrong_rule": (lambda k: _project(k, "noqa_wrong", noisy_wrong), taxi_schemas, {"D102"}),
    "g301_orphan_expectation": (
        lambda k: _project(k, "orphan", sql=[("trips", "SELECT pickup_at FROM taxi_table")],
                           expectations=[check]), taxi_schemas, {"G301"}),
    "g302_cycle": (lambda k: _pipe(k, "cyclic", ("a", "SELECT x FROM b"), ("b", "SELECT x FROM a")),
                   None, {"G302"}),
    "g303_unreachable": (lambda k: _pipe(k, "cyclic2", ("a", "SELECT x FROM b"), ("b", "SELECT x FROM a"),
                                         ("c", "SELECT x FROM a")), None, {"G302", "G303"}),
    "blast_radius_chain": (lambda k: _pipe(k, "chain", ("a", "SELECT pickup_at FROM taxi_table"),
                                           ("b", "SELECT pickup_at FROM a"),
                                           ("c", "SELECT pickup_at FROM b")), taxi_schemas, set()),
    # the explain plane's typed (T) and concurrency (C) rules
    "t401_float_join_key": (lambda k: _pipe(k, "t401", (
        "bad", "SELECT t.fare FROM trips AS t JOIN zones AS z ON t.score = z.zone_id")),
        joined_schemas, {"T401"}),
    "t402_join_key_widening": (lambda k: _pipe(k, "t402", (
        "j", "SELECT t.fare FROM trips AS t JOIN zones AS z ON t.zone_i8 = z.zone_id")),
        joined_schemas, {"T402"}),
    "t404_left_join_zero_fill": (lambda k: _pipe(k, "t404", (
        "agg", "SELECT z.borough, SUM(z.weight) AS w FROM trips AS t "
        "LEFT JOIN zones AS z ON t.zone = z.zone_id GROUP BY z.borough")), joined_schemas, {"T404"}),
    "t404_inner_join_clean": (lambda k: _pipe(k, "t404_inner", (
        "agg", "SELECT z.borough, SUM(z.weight) AS w FROM trips AS t "
        "JOIN zones AS z ON t.zone = z.zone_id GROUP BY z.borough")), joined_schemas, {"!T404"}),
    "t404_unqualified": (lambda k: _pipe(k, "t404_plain", (
        "agg", "SELECT borough, COUNT(*) AS n FROM trips AS t "
        "LEFT JOIN zones AS z ON t.zone = z.zone_id GROUP BY borough")), joined_schemas, {"T404"}),
    "c502_co_schedulable_writers": (lambda k: _project(k, "c502_pair", first_writer, second_writer),
                                    taxi_schemas, {"C502"}),
    "c502_dependency_orders_writes": (lambda k: _project(k, "c502_dep", base_writer, downstream_writer),
                                      taxi_schemas, {"!C502", "!C503"}),
    "c503_writer_and_reader": (lambda k: _project(k, "c503", totals_writer, totals_reader),
                               taxi_schemas, {"C503"}),
    "c502_noqa_at_write_site": (lambda k: _project(k, "c502_noqa", muted_one, muted_two),
                                taxi_schemas, {"!C502"}),
}


def _noqa_t401(pkg, how):
    p = pkg.Pipeline(f"t401_noqa_{how}")
    if how == "scoped":
        p.sql("bad", "SELECT t.fare FROM trips AS t JOIN zones AS z ON t.score = z.zone_id")  # repro: noqa[T401]
    elif how == "bare":
        p.sql("bad", "SELECT t.fare FROM trips AS t JOIN zones AS z ON t.score = z.zone_id")  # repro: noqa
    else:
        p.sql("bad", "SELECT t.fare FROM trips AS t JOIN zones AS z ON t.score = z.zone_id")  # repro: noqa[T402]
    return p


LINT_CASES.update({
    f"noqa_t401_{how}": ((lambda k, how=how: _noqa_t401(k, how)), joined_schemas,
                         {"T401"} if how == "wrong" else {"!T401"})
    for how in ("scoped", "bare", "wrong")
})


def _lint(pkg, build, schemas):
    pipeline = build(pkg)
    kw = {} if schemas is None else {"external_schemas": schemas(pkg)}
    return pkg.analysis.lint_pipeline(pipeline, **kw)


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_lint_report_equals_the_reference(case):
    build, schemas, expected = LINT_CASES[case]
    j, t = (_lint(pkg, build, schemas) for pkg in BOTH)
    assert t.to_json_dict() == j.to_json_dict()
    assert t.describe() == j.describe()
    fired = {f.rule for f in t.findings}
    assert {r for r in expected if not r.startswith("!")} <= fired
    assert not {r[1:] for r in expected if r.startswith("!")} & fired


def test_lint_details_the_reference_pins():
    """The reference tests' specific assertions, on the port's reports."""
    Sev = PORT.analysis.Severity
    r = _lint(PORT, *LINT_CASES["l001_sql"][:2])
    (f,) = r.by_rule("L001")
    assert f.severity is Sev.ERROR and "total_fare" in f.message and "taxi_table" in f.message
    assert f.file.endswith("test_torch_analysis.py") and f.line and "total_fare" in (f.snippet or "")
    (f,) = _lint(PORT, *LINT_CASES["l001_python_ast"][:2]).by_rule("L001")
    assert f.node == "doubled" and "fare_amount" in f.message and "fare_amount" in f.snippet
    assert "float32" in _lint(PORT, *LINT_CASES["l002_group_key_type"][:2]).by_rule("L002")[0].message
    assert _lint(PORT, *LINT_CASES["clean"][:2]).ok(strict=True)
    (f,) = _lint(PORT, *LINT_CASES["schema_propagates"][:2]).by_rule("L001")
    assert f.node == "later" and "passenger_count" in f.message
    assert "time.time" in _lint(PORT, *LINT_CASES["d101"][:2]).by_rule("D101")[0].message
    assert len(_lint(PORT, *LINT_CASES["d104"][:2]).by_rule("D104")) == 1
    assert "taxi_table" in _lint(PORT, *LINT_CASES["d107"][:2]).by_rule("D107")[0].message
    assert _lint(PORT, *LINT_CASES["noqa_scoped"][:2]).suppressed == 1
    assert _lint(PORT, *LINT_CASES["noqa_wrong_rule"][:2]).suppressed == 0
    cyc = _lint(PORT, *LINT_CASES["g302_cycle"][:2])
    (f,) = cyc.by_rule("G302")
    assert f.severity is Sev.ERROR and "test_torch_analysis.py" in f.message
    assert not cyc.ok() and cyc.blast_radius == {}
    assert {f.node for f in _lint(PORT, *LINT_CASES["g303_unreachable"][:2]).by_rule("G303")} == {"c"}
    radius = _lint(PORT, *LINT_CASES["blast_radius_chain"][:2]).blast_radius
    assert radius == {"a": ["b", "c"], "b": ["c"], "c": []}
    (f,) = _lint(PORT, *LINT_CASES["t401_float_join_key"][:2]).by_rule("T401")
    assert f.severity is Sev.ERROR and "t.score" in f.message and "int32" in f.hint
    (f,) = _lint(PORT, *LINT_CASES["t402_join_key_widening"][:2]).by_rule("T402")
    assert f.severity is Sev.INFO
    found = _lint(PORT, *LINT_CASES["t404_left_join_zero_fill"][:2]).by_rule("T404")
    assert len(found) == 2 and "zero-fill" in found[0].message and "zero-filled" in found[1].message
    (f,) = _lint(PORT, *LINT_CASES["t404_unqualified"][:2]).by_rule("T404")
    assert "'borough'" in f.message
    (f,) = _lint(PORT, *LINT_CASES["c502_co_schedulable_writers"][:2]).by_rule("C502")
    assert "SHARED_LOG" in f.message and "artifact" in f.hint
    r = _lint(PORT, *LINT_CASES["c503_writer_and_reader"][:2])
    assert "TOTALS" in r.by_rule("C503")[0].message and r.by_rule("C502") == []
    assert _lint(PORT, *LINT_CASES["c502_noqa_at_write_site"][:2]).suppressed >= 1
    assert _lint(PORT, *LINT_CASES["noqa_t401_scoped"][:2]).suppressed == 1


def _redefinition(pkg):
    proj = pkg.api_project.Project("redef_g304")
    proj.sql("trips", "SELECT pickup_at FROM taxi_table")
    with pytest.warns(pkg.api.RedefinitionWarning):
        proj.sql("trips", "SELECT passenger_count FROM taxi_table")
    same = pkg.api_project.Project("redef_same")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error", pkg.api.RedefinitionWarning)
        same.sql("trips", "SELECT pickup_at FROM taxi_table")
        same.sql("trips", "SELECT pickup_at FROM taxi_table")
    schemas = {"external_schemas": taxi_schemas(pkg)}
    return (pkg.analysis.lint_pipeline(proj.pipeline(), **schemas),
            pkg.analysis.lint_pipeline(same.pipeline(), **schemas))


def test_g304_redefinition_and_silent_reregistration():
    (j, j_same), (t, t_same) = (_redefinition(pkg) for pkg in BOTH)
    assert t.to_json_dict() == j.to_json_dict()
    assert t_same.to_json_dict() == j_same.to_json_dict()
    (f,) = t.by_rule("G304")
    assert "trips" in f.message and "replaced" in f.message
    assert t_same.by_rule("G304") == []


def test_c501_shadowing_a_lake_table():
    out = []
    for pkg in BOTH:
        p = pkg.Pipeline("shadow")
        p.sql("orders", "SELECT pickup_at FROM taxi_table")
        q = pkg.Pipeline("shadow_noqa")
        q.sql("orders", "SELECT pickup_at FROM taxi_table")  # repro: noqa[C501]
        run = pkg.analysis.run_concurrency_rules
        out.append((
            [f.to_json_dict() for f in run(p, catalog_tables={"orders"})[0]],
            run(p, catalog_tables={"orders"})[1], run(p)[0], run(q, catalog_tables={"orders"})[1],
        ))
    assert out[1] == out[0]
    (f,), suppressed, none, muted = out[1]
    assert f["rule"] == "C501" and "shadows" in f["message"] and "rename" in f["hint"]
    assert (suppressed, none, muted) == (0, [], 1)


# --------------------------------------------------- the D102 choice
def _d102(pkg, fn):
    return _lint(pkg, lambda k: _project(k, f"d102_{fn.__name__}", fn), taxi_schemas)


def test_d102_flags_torch_global_stream_draws():
    """The port's D102 also flags torch's draws from the global stream
    made without ``generator=`` (``torch.randn(4)``, ``torch.rand_like``);
    draws given a generator stay clean.  The rule's id, severity and text
    are the reference's, and on numpy code both packages agree."""
    (f,) = _d102(PORT, torch_draws).by_rule("D102")
    assert "torch.randn" in f.message and "generator=" in f.message
    assert f.severity is PORT.analysis.Severity.WARNING
    assert "torch.randn(4)" in f.snippet
    assert len(_d102(PORT, torch_like_draw).by_rule("D102")) == 1
    assert _d102(PORT, torch_seeded_draws).by_rule("D102") == []
    # the reference does not look at torch calls
    assert _d102(JAX, torch_draws).by_rule("D102") == []
    assert [(r.id, r.severity.value, r.summary, r.example) for r in PORT.analysis.FUNCTION_RULES] == [
        (r.id, r.severity.value, r.summary, r.example) for r in JAX.analysis.FUNCTION_RULES]


# -------------------------------------------------------- SQL positions
@pytest.mark.parametrize("sql", [
    "SELECT pickup_at FROM taxi_table WHERE pickup_at >",
    "SELECT pickup_at $ FROM taxi_table",
])
def test_sql_errors_carry_the_same_position(sql):
    errs = []
    for pkg in BOTH:
        with pytest.raises(pkg.engine_sql.SqlError) as ei:
            pkg.engine_sql.parse_sql(sql)
        assert isinstance(ei.value, SyntaxError)
        errs.append((ei.value.pos, ei.value.fragment, str(ei.value)))
    assert errs[1] == errs[0]
    assert errs[1][0] > 0 and "position" in errs[1][2]


def test_parsed_query_keeps_raw_sql_out_of_fingerprint():
    q1 = PORT.engine_sql.parse_sql("SELECT pickup_at FROM taxi_table")
    q2 = PORT.engine_sql.parse_sql("SELECT  pickup_at  FROM  taxi_table")
    assert q1.raw_sql != q2.raw_sql and q1 == q2
    assert "raw_sql" not in q1.to_json_dict()
    assert q1.to_json_dict() == JAX.engine_sql.parse_sql("SELECT pickup_at FROM taxi_table").to_json_dict()


# ------------------------------------------------------------ route traces
ROUTE_CASES = {
    "kernel_every_check": ("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone",
                           dict(stats={"zone": (0, 15), "fare": (1, 50)}, total_rows=10_000)),
    "bails_at_first_failed": ("SELECT fare FROM t WHERE zone > 3", {}),
    "engine_jnp_pinned": ("SELECT zone, COUNT(*) AS n FROM t GROUP BY zone", dict(engine="jnp")),
    "forced_kernel_skips_exactness": ("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone",
                                      dict(engine="kernel", stats={"zone": (0, 15)}, total_rows=None)),
    "forced_two_keys_refused": ("SELECT zone, fare, COUNT(*) AS n FROM t GROUP BY zone, fare",
                                dict(engine="kernel", stats={"zone": (0, 9)})),
    "forced_min_refused": ("SELECT zone, MIN(fare) AS m FROM t GROUP BY zone",
                           dict(engine="kernel", stats={"zone": (0, 9)})),
}


def _route(pkg, sql, kw):
    try:
        r = pkg.engine_route.plan_route(pkg.engine_sql.parse_sql(sql), **kw)
    except pkg.engine_route.RouteError as e:
        return ("RouteError", str(e), e.pos, e.fragment, e.hint, e.trace.to_json_dict())
    return r.to_json_dict()


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_traces_equal_the_reference(case):
    sql, kw = ROUTE_CASES[case]
    j, t = (_route(pkg, sql, kw) for pkg in BOTH)
    assert t == j
    route = PORT.engine_route
    if case == "kernel_every_check":
        r = route.plan_route(PORT.engine_sql.parse_sql(sql), **kw)
        ids = [c.check for c in r.trace.checks]
        assert {f"R20{i}" for i in range(1, 10)} <= set(ids)
        assert all(c.passed for c in r.trace.checks) and all(c in route.ROUTE_CHECKS for c in ids)
        bare = route.RouteDecision(engine_path=r.engine_path, reason=r.reason, num_groups=r.num_groups,
                                   key_offset=r.key_offset, native_filter=r.native_filter)
        assert r == bare and hash(r) == hash(bare) and bare.trace is None
    elif case == "bails_at_first_failed":
        assert t["reason"] == "not an aggregation"
        last = t["trace"]["checks"][-1]
        assert last["check"] == "R201" and not last["passed"] and last["hint"]
    elif case == "engine_jnp_pinned":
        assert [c["check"] for c in t["trace"]["checks"]] == ["R200"]
    elif case == "forced_kernel_skips_exactness":
        ids = {c["check"] for c in t["trace"]["checks"]}
        assert t["engine_path"] == "kernel" and not {"R207", "R208"} & ids
    else:
        name, msg, pos, fragment, hint, trace = t
        assert pos > 0 and "position" in msg and "fix:" in msg and hint
        failed = [c for c in trace["checks"] if not c["passed"]][0]["check"]
        assert failed == ("R202" if "two_keys" in case else "R203")


def test_t403_findings_equal_the_reference():
    out = []
    for pkg in BOTH:
        sql, S = pkg.engine_sql.parse_sql, pkg.table.Schema
        schemas = {"t": S.of(zone="int32", fare="int32")}
        qtf = pkg.analysis.query_type_findings
        bound = pkg.engine_route.EXACT_BOUND
        count = sql("SELECT zone, COUNT(*) AS n FROM t GROUP BY zone")
        total = sql("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone")
        runs = [
            qtf(count, schemas, stats={"zone": (0, 15)}, total_rows=bound),
            qtf(count, schemas, stats={"zone": (0, 15)}, total_rows=bound - 1),
            qtf(total, schemas, stats={"zone": (0, 15), "fare": (0, 100_000)}, total_rows=1_000),
            qtf(total, schemas),
        ]
        out.append([[f.to_json_dict() for f in findings] for findings, _ in runs])
    assert out[1] == out[0]
    at_bound, under, from_stats, no_stats = out[1]
    (f,) = [x for x in at_bound if x["rule"] == "T403"]
    assert f["severity"] == "warning" and "2^24" in f["message"]
    assert [x for x in under if x["rule"] == "T403"] == [] and no_stats == []
    (f,) = [x for x in from_stats if x["rule"] == "T403"]
    assert "fare" in f["message"] and "sql line 1" in f["message"] and f["hint"]


# ================================================= the rule catalog
def test_rule_catalog_equals_the_reference_and_the_readme():
    text = PORT.analysis.rule_catalog_markdown()
    assert text == JAX.analysis.rule_catalog_markdown()
    readme = (ROOT / "README.md").read_text()
    cat = PORT.analysis_catalog
    start = readme.index(cat.CATALOG_BEGIN) + len(cat.CATALOG_BEGIN)
    assert readme[start:readme.index(cat.CATALOG_END)].strip("\n") == text
    a = PORT.analysis
    for rid in [r.id for r in a.FUNCTION_RULES + a.TYPE_RULES + a.CONCURRENCY_RULES] + list(
            PORT.engine_route.ROUTE_CHECKS):
        assert f"`{rid}`" in text, rid


# ====================================================== client surface
def _lake(pkg, path):
    rng = np.random.default_rng(0)
    c = pkg.Client(path / "lake")
    c.write_table("taxi_table", pkg.make_taxi_data(500, rng), schema=pkg.TAXI_SCHEMA)
    c.write_table("orders", {
        "user_id": rng.integers(0, 50, 2000).astype(np.int32),
        "amount": rng.integers(0, 100, 2000).astype(np.int32),
        "famount": (rng.random(2000) * 100).astype(np.float32),
        "country": rng.integers(0, 20, 2000).astype(np.int32),
        "wid": rng.integers(0, 100_000, 2000).astype(np.int32),
    })
    c.write_table("big_orders_src", {
        "k": rng.integers(0, 10, 2000).astype(np.int32),
        "v": rng.integers(0, 2 ** 15, 2000).astype(np.int32),
    })
    return c


def _broken(pkg):
    p = pkg.Pipeline("broken")
    p.sql("trips", "SELECT total_fare FROM taxi_table")
    return p


def _clean(pkg):
    p = pkg.Pipeline("clean")
    p.sql("trips", "SELECT pickup_at FROM taxi_table WHERE passenger_count > 1")
    return p


def _client_lint(pkg, path):
    with _lake(pkg, path) as client:
        puts = client.store.stats.puts
        broken = client.lint(_broken(pkg))
        assert not broken.ok()
        assert client.store.stats.puts == puts and client._executor is None
        clean = client.lint(_clean(pkg))
        assert clean.ok(strict=True)
        ghost = pkg.Pipeline("ghost")
        ghost.sql("x", "SELECT a FROM phantom_table")
        ghost_r = client.lint(ghost)
        assert "L004" in {f.rule for f in ghost_r.findings}
        t403 = pkg.Pipeline("t403_lake")
        t403.sql("sums", "SELECT k, SUM(v) AS s FROM big_orders_src GROUP BY k")
        t403_r = client.lint(t403)
        assert "T403" in {f.rule for f in t403_r.findings}
        shadow = pkg.Pipeline("shadow_lake")
        shadow.sql("orders", "SELECT pickup_at FROM taxi_table")
        (f,) = client.lint(shadow).by_rule("C501")
        assert "orders" in f.message
        return [r.to_json_dict() for r in (broken, clean, ghost_r, t403_r)], f.to_json_dict()


def test_client_lint_is_read_only_and_resolves_the_catalog(tmp_path):
    parity(_client_lint, tmp_path)


def _preflight(pkg, path):
    with _lake(pkg, path) as client:
        with pytest.raises(pkg.analysis.LintFailed) as ei:
            client.run(_broken(pkg), preflight=True)
        assert ei.value.report.by_rule("L001") and "trips" not in client.tables("main")
        refused = client.run(_broken(pkg), preflight=True, raise_errors=False)
        assert refused.state is pkg.RunState.ERROR
        assert isinstance(refused.error, pkg.analysis.LintFailed)
        clean = client.run(_clean(pkg), preflight=True)
        assert clean.state is pkg.RunState.SUCCESS and "trips" in client.tables("main")
        warn = _project(pkg, "warn_only", noisy_capacity)
        report = client.lint(warn)
        assert report.errors == [] and report.warnings
        warned = client.run(warn, preflight=True)
        assert warned.state is pkg.RunState.SUCCESS
        return (str(ei.value), handle_summary(refused)["state"], handle_summary(clean),
                report.to_json_dict(), warned.checks, sorted(warned.artifacts))


def noisy_capacity(ctx, taxi_table):
    rng = np.random.default_rng()
    return {"x": rng.random(taxi_table.capacity).astype(np.float32)}


def test_preflight_refuses_errors_and_lets_warnings_through(tmp_path):
    parity(_preflight, tmp_path)


AGREE_QUERIES = [
    "SELECT country, SUM(amount) AS rev FROM orders WHERE amount > 10 GROUP BY country",
    "SELECT user_id, amount FROM orders WHERE amount > 80",
    "SELECT country, SUM(famount) AS s FROM orders GROUP BY country",
    "SELECT country, user_id, COUNT(*) AS n FROM orders GROUP BY country, user_id",
    "SELECT wid, COUNT(*) AS n FROM orders GROUP BY wid",
    "SELECT country, MIN(amount) AS m FROM orders GROUP BY country",
]


def _explain_agrees(pkg, path, engine):
    out = []
    with _lake(pkg, path) as client:
        for sql in AGREE_QUERIES:
            ex = client.explain(sql, engine=engine)
            if ex.error is not None:
                with pytest.raises(pkg.engine_route.RouteError) as ei:
                    client.query(sql, engine=engine)
                assert str(ei.value) == ex.error, sql
                ran = "error"
            else:
                result = client.query(sql, engine=engine)
                ran = [e for e in client.events() if type(e).__name__ == "QueryExecuted"][-1].engine_path
                assert ex.engine_path == ran, (sql, engine)
                if engine != "kernel":
                    # float sums on the forced kernel may differ in the last
                    # ulp; compared exactly everywhere else
                    ran = (ran, {k: np.asarray(v).tolist() for k, v in result.items()})
            out.append((ex.to_json_dict(), ran))
    return out


@pytest.mark.parametrize("engine", ["auto", "jnp", "kernel"])
def test_explain_agrees_with_runtime_matrix(tmp_path, engine):
    parity(_explain_agrees, tmp_path, engine)


def _explain_sql(pkg, path):
    with _lake(pkg, path) as client:
        puts = client.store.stats.puts
        ex = client.explain("SELECT country, SUM(amount) AS rev FROM orders WHERE amount > 10 GROUP BY country")
        assert ex.engine_path == "kernel" and ex.error is None and ex.trace.failed is None
        assert ex.pushdown and "amount" in ex.pushdown[0] and ex.scans["orders"]["rows"] == 2000
        assert [n for n, _ in ex.output_schema] == ["country", "rev"]
        assert "route trace" in ex.describe() and "execute   kernel" in ex.describe()
        bail = client.explain("SELECT k, SUM(v) AS s FROM big_orders_src GROUP BY k")
        assert bail.engine_path == "jnp" and bail.trace.failed.check == "R208"
        assert any(f.rule == "T403" for f in bail.findings)
        sql = "SELECT country, MIN(amount) AS m FROM orders GROUP BY country"
        refused = client.explain(sql, engine="kernel")
        assert refused.engine_path is None and refused.route is None
        assert refused.error is not None and refused.trace.failed.check == "R203"
        with pytest.raises(pkg.engine_sql.SqlError) as ei:
            client.explain("SELECT x FROM phantom")
        assert ei.value.pos == len("SELECT x FROM ") and "phantom" in str(ei.value)
        assert client.store.stats.puts == puts and client._executor is None
        with pytest.raises(pkg.engine_route.RouteError) as ri:
            client.query(sql, engine="kernel")
        assert str(ri.value) == refused.error
        return ([e.to_json_dict() for e in (ex, bail, refused)], [e.describe() for e in (ex, bail, refused)],
                str(ei.value))


def test_explain_sql_verdicts_equal_the_reference(tmp_path):
    parity(_explain_sql, tmp_path)


def _route_pipeline(pkg):
    p = pkg.Pipeline("routes")
    p.sql("pickup_counts", "SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
          "GROUP BY pickup_location_id")
    p.sql("narrow", "SELECT pickup_at FROM taxi_table WHERE passenger_count > 2")
    p.sql("top", "SELECT n FROM pickup_counts")
    return p


def _explain_pipeline(pkg, path):
    with _lake(pkg, path) as client:
        puts = client.store.stats.puts
        p = _route_pipeline(pkg)
        pe = client.explain(p)
        snap = client.fmt.load_snapshot(client.catalog.table_key("taxi_table"))
        logical = pkg.core_logical.build_logical_plan(p, external_schemas={"taxi_table": snap.schema})
        plan = pkg.core_physical.build_physical_plan(
            logical, {"taxi_table": snap}, ctx=pkg.core_runner.RunContext("main", 1, {}))
        planned = {}
        for stage in plan.stages:
            planned.update(stage.sql_routes)
        assert set(pe.routes) == {"pickup_counts", "narrow", "top"} and pe.routes == planned
        assert pe.report.ok()
        by_name = {n.name: n for n in pe.nodes}
        assert by_name["pickup_counts"].trace.checks
        assert dict(by_name["pickup_counts"].output_schema)["n"] == "int32"
        top = by_name["top"]
        assert top.route is None or top.route.engine_path == "jnp"
        assert "explain pipeline" in pe.describe() and "route:" in pe.describe()
        forced_p = pkg.Pipeline("forced")
        forced_p.sql("narrow", "SELECT pickup_at FROM taxi_table WHERE passenger_count > 2")
        forced = client.explain(forced_p, engine="kernel")
        (node,) = [n for n in forced.nodes if n.name == "narrow"]
        assert node.route is None and "engine='kernel' forced" in node.error and forced.routes == {}
        broken = client.explain(_broken(pkg))
        assert not broken.report.ok() and broken.report.by_rule("L001") and len(broken.nodes) == 1
        assert client.store.stats.puts == puts and client._executor is None
        return ([e.to_json_dict() for e in (pe, forced, broken)],
                {n: r.to_json_dict() for n, r in planned.items()})


def test_explain_pipeline_equals_the_reference_and_the_planner(tmp_path):
    parity(_explain_pipeline, tmp_path)


def _left_join_zero_fill(pkg, path, kind):
    n = 64
    if kind == "bool":
        left_keys, right_keys = (np.arange(n) % 2).astype(bool), np.array([True])
    else:
        left_keys, right_keys = (np.arange(n) % 10).astype(kind), np.arange(5).astype(kind)
    with pkg.Client(path / "lake") as c:
        c.write_table("users", {"uid": left_keys, "score": np.arange(n, dtype=np.int32)})
        c.write_table("bonus", {"uid": right_keys,
                                "extra": (np.arange(len(right_keys)) + 7).astype(np.int8)})
        sql = "SELECT u.score, b.extra FROM users AS u LEFT JOIN bonus AS b ON u.uid = b.uid"
        ex = c.explain(sql)
        out = c.query(sql)
        assert dict(ex.output_schema) == {name: str(arr.dtype) for name, arr in out.items()}
        matched = np.isin(left_keys, right_keys)
        assert not matched.all() and (out["extra"][~matched] == 0).all()
        return ex.to_json_dict(), {k: (str(v.dtype), v.tolist()) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["int32", "int8", "bool"])
def test_left_join_zero_fill_schema_matches_exec(tmp_path, kind):
    parity(_left_join_zero_fill, tmp_path, kind)


# ================================================================= CLI
CLEAN_SRC = """
clean = repro.project("cli_lint_clean")
clean.sql("trips", "SELECT pickup_at FROM taxi_table WHERE passenger_count > 1")
"""

WARN_SRC = CLEAN_SRC.replace("cli_lint_clean", "cli_lint_warn") + """
import numpy as np

@repro.model(project="cli_lint_warn")
def noisy(ctx, trips):
    rng = np.random.default_rng()
    return {"x": rng.random(4).astype(np.float32)}
"""


def broken_source(pkg):
    """``tests/fixtures/lint_broken_pipeline.py`` for this package: the
    fixture imports ``repro``, so the port gets a twin."""
    src = (ROOT / "tests" / "fixtures" / "lint_broken_pipeline.py").read_text()
    return src.replace("import repro\n", "", 1)


def _cli_lake(pkg, path):
    with pkg.Client(path / "lake") as c:
        c.write_table("taxi_table", pkg.make_taxi_data(200, np.random.default_rng(0)), schema=pkg.TAXI_SCHEMA)
    return path / "lake"


def _local(out, path):
    return out.replace(str(path / PORT.name), "<dir>").replace(str(path / JAX.name), "<dir>")


def _cli_lint(pkg, path):
    lake = _cli_lake(pkg, path)
    clean = pkg.write_pipeline(path, "clean_pipe.py", CLEAN_SRC)
    broken = pkg.write_pipeline(path, "lint_broken_pipeline.py", broken_source(pkg))
    warn = pkg.write_pipeline(path, "warn_pipe.py", WARN_SRC)
    report = path / "report.json"
    runs = [
        pkg.cli("--lake", lake, "lint", clean),
        pkg.cli("--lake", lake, "lint", broken),
        pkg.cli("--lake", lake, "lint", broken, "--json", report),
        pkg.cli("--lake", lake, "lint", warn),
        pkg.cli("--lake", lake, "lint", warn, "--strict"),
        pkg.cli("--lake", lake, "run", broken, "--preflight"),
    ]
    (c0, o0), (c1, o1), (c2, _), (c3, _), (c4, _), (c5, _) = runs
    assert c0 == 0 and "preflight clean" in o0
    assert c1 == 1 and "L001" in o1 and "D102" in o1 and "lint_broken_pipeline.py" in o1
    data = json.loads(report.read_text())
    assert data["errors"] >= 1 and data["warnings"] >= 1
    assert {f["rule"] for f in data["findings"]} >= {"L001", "D102"}
    assert all("file" in f and "line" in f for f in data["findings"])
    assert (c3, c4) == (0, 1) and "PREFLIGHT FAILED" in str(c5)
    for f in data["findings"]:
        f["file"] = Path(f["file"]).name
    return [(code, _local(out, path).replace(str(report), "<json>")) for code, out in runs], data


def test_cli_lint(tmp_path):
    parity(_cli_lint, tmp_path)


def _cli_explain(pkg, path):
    lake = _cli_lake(pkg, path)
    clean = pkg.write_pipeline(path, "clean_pipe.py", CLEAN_SRC.replace("cli_lint_clean", "cli_explain_clean"))
    broken = pkg.write_pipeline(path, "lint_broken_pipeline.py", broken_source(pkg))
    sql = ("SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table GROUP BY pickup_location_id")
    sql_json, pipe_json = path / "sql.json", path / "pipe.json"
    runs = [
        pkg.cli("--lake", lake, "explain", "-q", sql),
        pkg.cli("--lake", lake, "explain", "--engine", "kernel", "-q",
                "SELECT pickup_location_id, MIN(passenger_count) AS m FROM taxi_table "
                "GROUP BY pickup_location_id"),
        pkg.cli("--lake", lake, "explain", clean),
        pkg.cli("--lake", lake, "explain", broken),
        pkg.cli("--lake", lake, "explain"),
        pkg.cli("--lake", lake, "explain", clean, "-q", "SELECT 1"),
        pkg.cli("--lake", lake, "explain", "-q", sql, "--json", sql_json),
        pkg.cli("--lake", lake, "explain", clean, "--json", pipe_json),
    ]
    codes = [c for c, _ in runs]
    assert codes[:3] == [0, 0, 0] and codes[3] == 1 and codes[6:] == [0, 0]
    assert "exactly one target" in str(codes[4]) and codes[5] != 0
    assert "route trace" in runs[0][1] and "REFUSED" in runs[1][1] and "fix:" in runs[1][1]
    assert "explain pipeline" in runs[2][1] and "trips" in runs[2][1]
    sql_data, pipe_data = json.loads(sql_json.read_text()), json.loads(pipe_json.read_text())
    assert sql_data["engine_path"] in ("kernel", "jnp") and sql_data["trace"]["checks"]
    assert {n["name"] for n in pipe_data["nodes"]} == {"trips"} and pipe_data["lint"]["errors"] == 0
    for n in pipe_data["nodes"]:
        n.pop("file", None)
    outs = [(c, _local(o, path).replace(str(sql_json), "<sql>").replace(str(pipe_json), "<pipe>"))
            for c, o in runs]
    return outs, sql_data, pipe_data


def test_cli_explain(tmp_path):
    parity(_cli_explain, tmp_path)
