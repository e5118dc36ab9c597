"""The interactive query path as a whole: JAX package vs the port.

One lake per package (separate temp dirs), written from the same seeded
``make_taxi_data`` with ``shard_rows=128``.  Storage is content-addressed,
so the two lakes hold the same manifest keys.  The same statements go
through ``repro.Client.query`` and the port's ``Runner.query`` (on the
CPU) under every engine; outputs, ``QueryExecuted.engine_path`` and error
messages must be equal, and the port must answer queries over the lake
the JAX package wrote.
"""
import numpy as np
import pytest
import torch

import repro
from repro.examples_data import TAXI_SCHEMA as J_TAXI_SCHEMA
from repro.examples_data import make_taxi_data as j_make_taxi_data
from repro_torch.catalog import Catalog
from repro_torch.core import Runner
from repro_torch.engine.route import RouteError
from repro_torch.engine.sql import SqlError
from repro_torch.examples_data import APRIL_1, TAXI_SCHEMA, make_taxi_data
from repro_torch.io import ObjectStore
from repro_torch.table import TableFormat
from repro_torch.telemetry import EventBus

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

N_ROWS = 4_000
SEED = 7

STATEMENTS = [
    # Q1: single-key COUNT over a pushed-down date filter (routes kernel)
    "SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01' GROUP BY pickup_location_id "
    "ORDER BY pickup_location_id",
    # Q2: the mask-feed path (OR residual after pushdown)
    "SELECT pickup_location_id, COUNT(*) AS n, SUM(passenger_count) AS riders, "
    "AVG(passenger_count) AS mean_riders FROM taxi_table "
    "WHERE pickup_at >= '2019-04-01' AND (passenger_count > 35 OR "
    "dropoff_location_id < 8) GROUP BY pickup_location_id ORDER BY riders DESC",
    # Q3: the Appendix `pickups` shape, two keys
    "SELECT pickup_location_id, dropoff_location_id, COUNT(*) AS counts "
    "FROM taxi_table WHERE pickup_at >= '2019-04-01' "
    "GROUP BY pickup_location_id, dropoff_location_id ORDER BY counts DESC",
    # native in-kernel filter (single col-cmp-literal, not pushed: no residual)
    "SELECT dropoff_location_id, SUM(passenger_count) AS s FROM taxi_table "
    "GROUP BY dropoff_location_id ORDER BY dropoff_location_id",
    "SELECT pickup_location_id AS loc, passenger_count FROM taxi_table "
    "WHERE pickup_at < '2019-02-10' AND passenger_count BETWEEN 20 AND 25 LIMIT 40",
    "SELECT pickup_location_id, MAX(passenger_count) AS hi, MIN(pickup_at) AS first "
    "FROM taxi_table WHERE dropoff_location_id IN (3, 5, 8) GROUP BY pickup_location_id",
    "SELECT COUNT(*) AS n, AVG(passenger_count) AS m FROM taxi_table "
    "WHERE pickup_at >= '2019-04-20'",
    # join: trips x zones
    "SELECT z.borough, COUNT(*) AS n, SUM(t.passenger_count) AS riders "
    "FROM taxi_table AS t JOIN zones AS z ON t.pickup_location_id = z.zone_id "
    "WHERE t.pickup_at >= '2019-04-01' GROUP BY z.borough ORDER BY z.borough",
    "SELECT t.pickup_location_id, z.borough FROM taxi_table AS t LEFT JOIN zones AS z "
    "ON t.dropoff_location_id = z.zone_id ORDER BY t.pickup_location_id LIMIT 30",
]

ERRORS = [
    "SELECT x FROM nope",
    "SELECT missing FROM taxi_table",
    "SELECT z.missing FROM taxi_table AS t JOIN zones AS z "
    "ON t.pickup_location_id = z.zone_id",
    "SELECT q.passenger_count FROM taxi_table AS t",
    "SELECT passenger_count FROM taxi_table LIMIT 5x",
]


def _zones():
    # ids 0..47 only, so the left join has misses
    return {
        "zone_id": np.arange(48, dtype=np.int32),
        "borough": (np.arange(48, dtype=np.int32) % 5) + 100,
    }


class PortLake:
    def __init__(self, path):
        self.store = ObjectStore(path)
        self.fmt = TableFormat(self.store, shard_rows=128)
        self.catalog = Catalog(self.store)
        self.bus = EventBus()
        self.events = self.bus.subscribe(maxlen=1 << 16)
        self.runner = Runner(self.catalog, self.fmt, bus=self.bus, device="cpu")

    def write(self, name, data, schema=None):
        from repro_torch.table import Schema

        schema = schema or Schema.of(**{c: str(v.dtype) for c, v in data.items()})
        snap = self.fmt.write(name, schema, data)
        commit = self.catalog.commit(
            "main", {name: self.fmt.manifest_key(snap)}, message=f"write_table {name}"
        )
        return self.fmt.manifest_key(snap), commit.commit_id

    def query(self, sql, **kw):
        out = self.runner.query(sql, **kw)
        ev = [e for e in self.events.drain() if type(e).__name__ == "QueryExecuted"]
        return out, ev[-1].engine_path


@pytest.fixture(scope="module")
def lakes(tmp_path_factory):
    base = tmp_path_factory.mktemp("lakes")
    jax_client = repro.Client(base / "jax", shard_rows=128)
    port = PortLake(base / "torch")
    keys = {}
    jdata = j_make_taxi_data(N_ROWS, np.random.default_rng(SEED))
    pdata = make_taxi_data(N_ROWS, np.random.default_rng(SEED))
    jsnap = jax_client.write_table("taxi_table", jdata, schema=J_TAXI_SCHEMA)
    keys["taxi_table"] = (jax_client.fmt.manifest_key(jsnap),
                          port.write("taxi_table", pdata, TAXI_SCHEMA)[0])
    jz = jax_client.write_table("zones", _zones())
    keys["zones"] = (jax_client.fmt.manifest_key(jz), port.write("zones", _zones())[0])
    yield jax_client, port, keys
    jax_client.close()


def _jax_query(client, sql, **kw):
    out = client.query(sql, **kw)
    ev = [e for e in client.events() if type(e).__name__ == "QueryExecuted"]
    return out, ev[-1].engine_path


def assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_manifest_keys_equal(lakes):
    _, _, keys = lakes
    for table, (jkey, pkey) in keys.items():
        assert jkey == pkey, table


@pytest.mark.parametrize("engine", ["auto", "kernel", "jnp"])
@pytest.mark.parametrize("sql", STATEMENTS)
def test_queries_match_jax(lakes, sql, engine):
    jax_client, port, _ = lakes
    try:
        want, want_path = _jax_query(jax_client, sql, engine=engine)
    except Exception as e:  # the reference refused: the port must refuse alike
        assert type(e).__name__ == "RouteError"
        with pytest.raises(RouteError) as got:
            port.query(sql, engine=engine)
        assert str(got.value) == str(e)
        return
    got, got_path = port.query(sql, engine=engine)
    assert got_path == want_path
    assert_same(got, want)


def test_main_path_routes(lakes):
    """Q1 auto-routes the kernel, Q2 takes the kernel when forced (mask
    feed), Q3 (two keys) takes the reference operators."""
    _, port, _ = lakes
    q1, q2, q3 = STATEMENTS[:3]
    assert port.query(q1)[1] == "kernel"
    assert port.query(q2, engine="kernel")[1] == "kernel"
    assert port.query(q3)[1] == "jnp"
    for sql in (q1, q2):
        assert_same(port.query(sql, engine="kernel")[0], port.query(sql, engine="jnp")[0])


@pytest.mark.parametrize("sql", ERRORS)
def test_sql_errors_match_jax(lakes, sql):
    jax_client, port, _ = lakes
    with pytest.raises(Exception) as want:
        jax_client.query(sql)
    with pytest.raises(SqlError) as got:
        port.query(sql)
    assert type(want.value).__name__ == "SqlError"
    assert str(got.value) == str(want.value)


def test_route_error_matches_jax(lakes):
    jax_client, port, _ = lakes
    sql = STATEMENTS[2]  # two group keys: the kernel cannot run it
    with pytest.raises(Exception) as want:
        jax_client.query(sql, engine="kernel")
    with pytest.raises(RouteError) as got:
        port.query(sql, engine="kernel")
    assert type(want.value).__name__ == "RouteError"
    assert str(got.value) == str(want.value)


def test_time_travel_by_commit_id(tmp_path):
    """Each lake queried at its own first commit sees the first version."""
    jax_client = repro.Client(tmp_path / "jax", shard_rows=128)
    port = PortLake(tmp_path / "torch")
    first = make_taxi_data(600, np.random.default_rng(1))
    second = make_taxi_data(900, np.random.default_rng(2))
    jax_client.write_table("taxi_table", first, schema=J_TAXI_SCHEMA)
    j_first = jax_client.log("main")[0].commit_id
    jax_client.write_table("taxi_table", second, schema=J_TAXI_SCHEMA)
    _, p_first = port.write("taxi_table", first, TAXI_SCHEMA)
    port.write("taxi_table", second, TAXI_SCHEMA)
    sql = STATEMENTS[0]
    for engine in ("auto", "jnp"):
        want, _ = _jax_query(jax_client, sql, commit_id=j_first, engine=engine)
        got, _ = port.query(sql, commit_id=p_first, engine=engine)
        assert_same(got, want)
        assert int(got["n"].sum()) == int((first["pickup_at"] >= APRIL_1).sum())
        head, _ = port.query(sql, engine=engine)
        assert int(head["n"].sum()) == int((second["pickup_at"] >= APRIL_1).sum())
    jax_client.close()


def test_port_reads_a_lake_the_jax_package_wrote(lakes):
    jax_client, _, _ = lakes
    store = ObjectStore(jax_client.store.root)
    runner = Runner(Catalog(store), TableFormat(store, shard_rows=128), device="cpu")
    for sql in STATEMENTS[:4] + STATEMENTS[7:8]:
        for engine in ("auto", "jnp"):
            want, _ = _jax_query(jax_client, sql, engine=engine)
            assert_same(runner.query(sql, engine=engine), want)
