"""Port's execute_query vs the JAX package's, on the same relations.

The same seeded numpy columns go into ``repro.engine`` (JAX) and
``repro_torch.engine`` (torch, on the CPU).  Column names, dtypes, row
order and values must be exactly equal after ``to_numpy()``; only float
sums and means may differ, at rtol=1e-6, because the two frameworks add
in another order.  Inside the port, the kernel route must be
byte-identical to the reference operators on route-eligible queries.
"""
import numpy as np
import pytest
import torch

from repro.engine import Columnar as JColumnar
from repro.engine import execute_query as jax_execute
from repro.engine import parse_sql as jax_parse
from repro.engine.route import plan_route as jax_plan_route
from repro_torch.engine import Columnar, Query, col, compile_query, execute_query, parse_sql
from repro_torch.engine.route import plan_route
from repro_torch.kernels.fused_filter_agg import ops

torch.set_num_threads(1)  # tiny tensors: extra threads only contend


def _rel(rng, n=400, key_dtype=np.int32):
    return {
        "loc": rng.integers(0, 16, n).astype(key_dtype),
        "dst": rng.integers(0, 8, n).astype(np.int32),
        "count": rng.integers(0, 10, n).astype(np.int32),
        "fare": (rng.random(n) * 50).astype(np.float32),
        "small": rng.integers(-3, 4, n).astype(np.int8),
        "flag": rng.random(n) < 0.3,
    }


def _zones(n=16):
    return {
        "zone_id": np.arange(n, dtype=np.int32),
        "borough": (np.arange(n, dtype=np.int32) % 4) + 100,
    }


def _float_agg_columns(sql):
    q = parse_sql(sql)
    return {a.name for a in q.aggregates if a.fn in ("sum", "mean")}


def assert_same(got, want, *, loose=()):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, k
        if k in loose and want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def run_both(sql, data, joined=None):
    j_joined = {t: JColumnar.from_numpy(d) for t, d in (joined or {}).items()}
    t_joined = {t: Columnar.from_numpy(d, device="cpu") for t, d in (joined or {}).items()}
    want = jax_execute(
        jax_parse(sql), JColumnar.from_numpy(data), joined=j_joined or None
    ).to_numpy()
    got = execute_query(
        parse_sql(sql), Columnar.from_numpy(data, device="cpu"), joined=t_joined or None
    ).to_numpy()
    assert_same(got, want, loose=_float_agg_columns(sql))
    return got


SINGLE_TABLE = [
    # filters and projections
    "SELECT fare FROM t WHERE count > 4",
    "SELECT fare, fare * 2 AS double, count + 1 AS c1, count / 2 AS half FROM t",
    "SELECT loc, fare - 1.5 AS f FROM t WHERE loc = 3 OR fare > 40",
    "SELECT fare FROM t WHERE loc IN (1, 4, 9)",
    "SELECT fare FROM t WHERE loc NOT IN (1, 4, 9)",
    "SELECT count FROM t WHERE dst BETWEEN 2 AND 5",
    "SELECT count FROM t WHERE dst NOT BETWEEN 2 AND 5",
    "SELECT fare FROM t WHERE (loc = 1 OR loc = 2) AND fare < 10",
    "SELECT small, small + 1 AS s1 FROM t WHERE small < 0",
    "SELECT fare FROM t WHERE count > 2.5",
    "SELECT flag, loc FROM t WHERE flag",
    "SELECT * FROM t WHERE count > 7",
    # sorts and limits
    "SELECT fare FROM t ORDER BY fare DESC LIMIT 10",
    "SELECT loc, fare FROM t ORDER BY loc, fare DESC",
    "SELECT loc, count FROM t ORDER BY count DESC, loc LIMIT 25",
    # one- and two-key aggregation
    "SELECT loc, COUNT(*) AS n FROM t GROUP BY loc",
    "SELECT loc, SUM(fare) AS s, COUNT(*) AS n FROM t GROUP BY loc ORDER BY s DESC",
    "SELECT loc, SUM(count) AS s, AVG(count) AS m FROM t WHERE fare > 10 GROUP BY loc",
    "SELECT loc, MIN(fare) AS lo, MAX(fare) AS hi, AVG(fare) AS m FROM t GROUP BY loc",
    "SELECT loc, MIN(count) AS lo, MAX(small) AS hi FROM t GROUP BY loc ORDER BY loc DESC",
    "SELECT loc, dst, COUNT(*) AS counts FROM t GROUP BY loc, dst ORDER BY counts DESC",
    "SELECT loc, dst, SUM(fare) AS s, MIN(count) AS lo FROM t WHERE count > 2 "
    "GROUP BY loc, dst ORDER BY s DESC LIMIT 7",
    "SELECT loc, SUM(small) AS s FROM t GROUP BY loc",
    "SELECT flag, COUNT(*) AS n, SUM(count) AS s FROM t GROUP BY flag",
    "SELECT small, COUNT(*) AS n FROM t GROUP BY small ORDER BY n DESC",
    "SELECT COUNT(*) AS n, SUM(fare) AS s, MAX(count) AS hi FROM t WHERE loc < 4",
    # empty after filter
    "SELECT loc, COUNT(*) AS n FROM t WHERE fare > 1000 GROUP BY loc",
    "SELECT fare FROM t WHERE fare > 1000",
]


@pytest.mark.parametrize("sql", SINGLE_TABLE)
def test_single_table_matches_jax(sql, rng):
    run_both(sql, _rel(rng))


@pytest.mark.parametrize("key_dtype", [np.int32, np.int8, np.bool_])
def test_group_key_dtypes_match_jax(key_dtype, rng):
    data = _rel(rng, key_dtype=key_dtype)
    if key_dtype is np.bool_:
        data["loc"] = rng.random(400) < 0.5
    run_both(
        "SELECT loc, COUNT(*) AS n, SUM(count) AS s, AVG(fare) AS m FROM t "
        "WHERE dst > 2 GROUP BY loc ORDER BY loc", data,
    )


JOINS = [
    "SELECT t.loc, t.fare, z.borough FROM trips AS t JOIN zones AS z ON t.loc = z.zone_id",
    "SELECT t.loc, t.fare, z.borough FROM trips AS t LEFT JOIN zones AS z ON t.loc = z.zone_id",
    "SELECT * FROM trips AS t JOIN zones AS z ON t.loc = z.zone_id LIMIT 50",
    "SELECT z.borough, COUNT(*) AS count, SUM(t.count) AS total FROM trips AS t "
    "JOIN zones AS z ON t.loc = z.zone_id WHERE t.dst > 2 GROUP BY z.borough ORDER BY z.borough",
    "SELECT z.borough, COUNT(*) AS n FROM trips AS t LEFT JOIN zones AS z "
    "ON z.zone_id = t.loc GROUP BY z.borough ORDER BY n DESC",
]


@pytest.mark.parametrize("sql", JOINS)
def test_joins_with_duplicate_and_missing_keys_match_jax(sql, rng):
    trips = _rel(rng)
    trips["loc"][:25] = 99  # no match on the right
    zones = _zones()
    # duplicate right keys: the first match in storage order must win
    zones["zone_id"] = np.concatenate([zones["zone_id"][:12], zones["zone_id"][:4]])
    run_both(sql, trips, joined={"zones": zones})


def test_join_key_dtype_error_message_matches_jax(rng):
    trips = {"loc": rng.random(16).astype(np.float32)}
    sql = "SELECT * FROM trips AS t JOIN zones AS z ON t.loc = z.zone_id"
    with pytest.raises(TypeError) as want:
        jax_execute(jax_parse(sql), JColumnar.from_numpy(trips),
                    joined={"zones": JColumnar.from_numpy(_zones())})
    with pytest.raises(TypeError) as got:
        execute_query(parse_sql(sql), Columnar.from_numpy(trips, device="cpu"),
                      joined={"zones": Columnar.from_numpy(_zones(), device="cpu")})
    assert str(got.value) == str(want.value)


def test_builder_queries_match_jax(rng):
    from repro.engine import Query as JQuery
    from repro.engine import col as jcol

    data = _rel(rng)
    jq = (JQuery("t").where(jcol("count") > 2).group_by("loc")
          .agg("sum", jcol("fare"), "s").count("n").sort("n", desc=True).take(5))
    q = (Query("t").where(col("count") > 2).group_by("loc")
         .agg("sum", col("fare"), "s").count("n").sort("n", desc=True).take(5))
    want = jax_execute(jq, JColumnar.from_numpy(data)).to_numpy()
    got = execute_query(q, Columnar.from_numpy(data, device="cpu")).to_numpy()
    assert_same(got, want, loose={"s"})


def test_group_capacity_overflow_matches_jax(rng):
    data = _rel(rng)
    sql = "SELECT loc, COUNT(*) AS n FROM t GROUP BY loc"
    want = jax_execute(jax_parse(sql), JColumnar.from_numpy(data), group_capacity=5).to_numpy()
    got = execute_query(parse_sql(sql), Columnar.from_numpy(data, device="cpu"),
                        group_capacity=5).to_numpy()
    assert_same(got, want)


def test_float_group_sums_repeatable(rng):
    data = _rel(rng, n=5000)
    rel = Columnar.from_numpy(data, device="cpu")
    q = parse_sql("SELECT loc, SUM(fare) AS s FROM t GROUP BY loc")
    a = execute_query(q, rel).to_numpy()["s"]
    b = execute_query(q, rel).to_numpy()["s"]
    assert a.tobytes() == b.tobytes()


def test_compile_query_is_cached_and_matches_eager(rng):
    rel = Columnar.from_numpy(_rel(rng), device="cpu")
    q = Query("t").where(col("fare") < 25.0).group_by("dst").agg("sum", col("fare"), "s")
    compiled = compile_query(q)
    assert compile_query(q) is compiled
    eager = execute_query(q, rel).to_numpy()
    assert_same(compiled(rel).to_numpy(), eager)


def test_columnar_statistics_match_jax(rng):
    data = _rel(rng)
    j = JColumnar.from_numpy(data)
    t = Columnar.from_numpy(data, device="cpu")
    keep = data["count"] > 3
    j, t = j.mask_where(keep), t.mask_where(torch.from_numpy(keep))
    for name in ("count", "small", "flag"):
        assert t.sum(name).dtype == torch.int32
        assert int(t.sum(name)) == int(j.sum(name))
    assert int(t.num_valid()) == int(j.num_valid())
    np.testing.assert_allclose(float(t.sum("fare")), float(j.sum("fare")), rtol=1e-6)
    assert float(t.mean("count")) == float(j.mean("count"))
    assert float(t.min("fare")) == float(j.min("fare"))
    assert int(t.max("count")) == int(j.max("count"))


def test_from_numpy_narrows_like_jax():
    data = {
        "i64": np.arange(5, dtype=np.int64),
        "f64": np.linspace(0, 1, 5),
        "u8": np.arange(5, dtype=np.uint8),
        "b": np.ones(5, dtype=bool),
        "i8": np.arange(5, dtype=np.int8),
    }
    j = JColumnar.from_numpy(data).to_numpy()
    t = Columnar.from_numpy(data, device="cpu").to_numpy()
    for k in data:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k])


# ------------------------------------------- kernel/reference parity (port)
PARITY_SQL = (
    "SELECT zone, COUNT(*) AS n, SUM(fare) AS s, AVG(fare) AS m "
    "FROM t WHERE dist > 5 GROUP BY zone"
)


def _parity_case(rng, *, n, groups, key_dtype, sql):
    data = {
        "zone": rng.integers(0, groups, n).astype(key_dtype),
        "fare": rng.integers(1, 50, n).astype(np.int32),
        "dist": rng.integers(0, 30, n).astype(np.int32),
    }
    stats = dict(zone=(0, groups - 1), fare=(1, 50), dist=(0, 30))
    rel = Columnar.from_numpy(data, device="cpu")
    q = parse_sql(sql)
    route = plan_route(q, engine="kernel", stats=stats, total_rows=n)
    assert route.engine_path == "kernel"
    launches = ops.LAUNCHES
    got = execute_query(q, rel, route=route).to_numpy()
    assert ops.LAUNCHES == launches  # CPU relation: the plain version ran
    want = execute_query(q, rel).to_numpy()
    assert_same(got, want)
    # and the JAX package's kernel route (interpret mode) agrees
    jq = jax_parse(sql)
    jroute = jax_plan_route(jq, engine="kernel", stats=stats, total_rows=n)
    jgot = jax_execute(jq, JColumnar.from_numpy(data), route=jroute).to_numpy()
    assert_same(got, jgot)


@pytest.mark.parametrize("key_dtype", [np.int32, np.int8, np.bool_])
def test_kernel_parity_key_dtypes(rng, key_dtype):
    groups = 2 if key_dtype is np.bool_ else 13
    _parity_case(rng, n=700, groups=groups, key_dtype=key_dtype, sql=PARITY_SQL)


@pytest.mark.parametrize("groups", [1, 7, 128, 1000])
def test_kernel_parity_group_cardinalities(rng, groups):
    _parity_case(rng, n=2_000, groups=groups, key_dtype=np.int32, sql=PARITY_SQL)


@pytest.mark.parametrize("sql", [
    "SELECT zone, COUNT(*) AS n, SUM(fare) AS s FROM t WHERE dist > 1000 GROUP BY zone",
    "SELECT zone, SUM(fare) AS s FROM t GROUP BY zone",
    "SELECT zone, COUNT(*) AS n FROM t GROUP BY zone",
    "SELECT zone, COUNT(*) AS n FROM t WHERE dist > 5 OR fare < 10 GROUP BY zone "
    "ORDER BY n DESC",
    "SELECT zone, AVG(fare) AS m FROM t WHERE dist IN (1, 2, 3) GROUP BY zone LIMIT 4",
])
def test_kernel_parity_filters_and_shapes(rng, sql):
    _parity_case(rng, n=900, groups=11, key_dtype=np.int32, sql=sql)


def test_route_decisions_match_jax():
    """The port's router is the reference's minus ``interpret``: the same
    query and statistics give the same decision."""
    cases = [
        ("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone",
         dict(zone=(0, 15), fare=(1, 50)), 10_000),
        ("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone", dict(zone=(0, 15)), 10_000),
        ("SELECT zone, COUNT(*) AS n FROM t GROUP BY zone", dict(zone=(0, 10**6)), 1_000),
        ("SELECT zone, SUM(fare) AS s FROM t GROUP BY zone",
         dict(zone=(0, 15), fare=(0, 2**20)), 2**20),
        ("SELECT zone, COUNT(*) AS n FROM t WHERE fare > 3 GROUP BY zone",
         dict(zone=(2, 9), fare=(0, 9)), 100),
    ]
    for sql, stats, rows in cases:
        for engine in ("auto", "jnp"):
            got = plan_route(parse_sql(sql), engine=engine, stats=stats, total_rows=rows)
            want = jax_plan_route(jax_parse(sql), engine=engine, stats=stats, total_rows=rows)
            assert got.to_json_dict() == want.to_json_dict(), (sql, engine)
