"""Lakekeeper maintenance, ``repro_torch.maintenance``, against
``repro.maintenance``: mark-and-sweep GC, cache eviction, compaction.

Each case drives the same runs and the same maintenance calls through
both packages on lakes of their own (the JAX package on the CPU, the
port's ``Runner`` with ``device="cpu"``), from the same seeded data.
Storage is content addressed, so the two lakes must end with equal
object key sets: the keys a GC pass swept and the keys it kept are
compared, as are the GC and compaction reports (counts, bytes, roots),
the compacted manifests and what the branch heads read back.  Each case
keeps the reference test's own assertions, applied to the port.

Mirrored: all of ``test_maintenance.py`` and
``test_differential_cache.py::test_compaction_rewrite_keeps_cache_warm``.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from tests.torch_parity import parity

torch.set_num_threads(1)


class Lake:
    """One package's store, catalog, format and runner."""

    def __init__(self, pkg, path, *, shard_rows=128, executor=True):
        self.pkg = pkg
        self.store = pkg.io.ObjectStore(path / "lake")
        self.catalog = pkg.catalog.Catalog(self.store)
        self.fmt = pkg.table.TableFormat(self.store, shard_rows=shard_rows)
        self.m = pkg.maintenance
        self.executor = (
            pkg.runtime.ServerlessExecutor(pkg.ExecutorConfig(max_workers=2))
            if executor else None
        )
        self.runner = pkg.Runner(self.catalog, self.fmt, self.executor) if executor else None

    def close(self):
        if self.executor is not None:
            self.executor.shutdown()

    def seed(self, n=2000, *, seed=0, **kw):
        data = self.pkg.make_taxi_data(n, np.random.default_rng(seed), **kw)
        snap = self.fmt.write("taxi_table", self.pkg.TAXI_SCHEMA, data)
        self.catalog.commit("main", {"taxi_table": self.fmt.manifest_key(snap)}, message="seed")
        return data

    def fragmented(self, n=2000, step=100, *, seed=0):
        """taxi_table from many small appends -> many small shards."""
        data = self.pkg.make_taxi_data(n, np.random.default_rng(seed))
        snap = None
        for start in range(0, n, step):
            chunk = {c: v[start:start + step] for c, v in data.items()}
            snap = self.fmt.write("taxi_table", self.pkg.TAXI_SCHEMA, chunk,
                                  parent=snap, append=snap is not None)
        self.catalog.commit("main", {"taxi_table": self.fmt.manifest_key(snap)})
        return data

    def run(self, pipeline, branch="main", **kw):
        kw.setdefault("fusion", False)
        kw.setdefault("pushdown", False)
        kw.setdefault("cache", True)
        return self.runner.run(pipeline, branch=branch, **kw)

    def taxi(self, threshold=10.0):
        return self.pkg.build_taxi_pipeline(threshold)

    def dated(self, since="2019-04-01"):
        """The taxi pipeline with its trips date as the edit knob: a date
        edit changes the data each run writes, so runs make garbage."""
        p = self.pkg.Pipeline("taxi_demo")
        p.sql(
            "trips",
            f"""
            SELECT pickup_location_id, passenger_count as count, dropoff_location_id
            FROM taxi_table WHERE pickup_at >= '{since}'
            """,
        )

        def trips_expectation(ctx, trips):
            return trips.mean("count") > 10.0

        p.python(self.pkg.core.requirements({"pandas": "2.0.0"})(trips_expectation))
        p.sql(
            "pickups",
            """
            SELECT pickup_location_id, dropoff_location_id, COUNT(*) AS counts
            FROM trips GROUP BY pickup_location_id, dropoff_location_id
            ORDER BY counts DESC
            """,
        )
        return p

    def keys(self):
        return set(self.store.keys())

    def store_bytes(self):
        return sum(self.store.object_size(k) or 0 for k in self.store.keys())

    def registry(self):
        return self.pkg.core.StageCacheRegistry(self.store)

    def read_table(self, name="taxi_table", commit_id=None):
        key = self.catalog.table_key(name, commit_id=commit_id)
        return self.fmt.read(self.fmt.load_snapshot(key))


def report_dict(report) -> dict:
    return dataclasses.asdict(report)


def gc(lake, **kw):
    """One GC pass: (report, swept keys, kept keys)."""
    before = lake.keys()
    report = lake.m.collect_garbage(lake.store, lake.catalog, lake.fmt, **kw)
    after = lake.keys()
    return report_dict(report), sorted(before - after), sorted(after)


def prune_all(lake):
    """Evict every node-cache entry: a byte budget of 0 and every entry
    past a TTL of 0.  The budget alone stops once the bytes fit, and keeps
    whichever 0-byte entry (an expectation node's) a run touched last,
    which depends on which of its stages finished last."""
    report = lake.m.prune_cache(lake.registry(), lake.m.EvictionPolicy(max_bytes=0, ttl_s=0.0),
                                now=time.time() + 1.0)
    assert lake.registry().entries() == {}
    return report


def lake_case(fn):
    """``fn(lake)`` as a parity scenario that closes its executor."""
    def scenario(pkg, path, *args):
        lake = Lake(pkg, path)
        try:
            return fn(lake, *args)
        finally:
            lake.close()
    scenario.__name__ = fn.__name__
    return scenario


def as_lists(cols):
    return {c: (str(v.dtype), np.asarray(v).tolist()) for c, v in sorted(cols.items())}


# ------------------------------------------------------------------- mark
@lake_case
def _mark_roots(lake):
    lake.seed()
    res = lake.run(lake.taxi())
    lake.catalog.tag("v1", res.merged_commit)
    lake.pkg.core_snapshot.RunRegistry(lake.store).pin_run(999, res.merged_commit)
    live = lake.m.mark(lake.store, lake.catalog, lake.fmt)
    assert live.roots == {
        "branches": 1, "tags": 1, "pinned_runs": 1,
        "cache_entries": len(lake.registry().entries()),
        "runlogs": 0,
    }
    for key in lake.catalog.tables().values():
        assert lake.fmt.snapshot_object_keys(key) <= live.objects
    r1 = lake.run(lake.dated("2019-04-05"))
    full = lake.m.mark(lake.store, lake.catalog, lake.fmt)
    heads_only = lake.m.mark(lake.store, lake.catalog, lake.fmt, history=1)
    assert len(heads_only.commits) < len(full.commits)
    assert lake.catalog.head("main").commit_id in heads_only.commits
    return (live.roots, sorted(live.objects), sorted(full.objects),
            sorted(heads_only.objects), len(full.commits), len(heads_only.commits),
            sorted(r1.artifacts.values()))


def test_mark_roots_and_history_bound(tmp_path):
    parity(_mark_roots, tmp_path)


# --------------------------------------------------------------------- gc
@lake_case
def _gc_default_keeps_history(lake):
    lake.seed()
    lake.run(lake.dated("2019-04-01"))
    lake.run(lake.dated("2019-04-05"))
    report, swept, kept = gc(lake)
    assert report["swept_objects"] == 0 and report["swept_commits"] == 0
    return report, swept, kept


def _failed_audit(lake):
    lake.seed(800, mean_count=2.0)
    with pytest.raises(lake.pkg.core.ExpectationFailed):
        lake.run(lake.taxi())


@lake_case
def _gc_reclaims_failed_run(lake):
    _failed_audit(lake)
    before = lake.store_bytes()
    report, swept, kept = gc(lake)
    assert report["swept_objects"] > 0 and report["bytes_reclaimed"] > 0
    assert lake.store_bytes() < before
    assert len(lake.read_table()["pickup_at"]) == 800
    return report, swept, kept


@lake_case
def _gc_dry_run(lake):
    _failed_audit(lake)
    before = lake.keys()
    dry = report_dict(lake.m.collect_garbage(lake.store, lake.catalog, lake.fmt, dry_run=True))
    assert dry["dry_run"] and dry["swept_objects"] > 0
    assert lake.keys() == before
    assert lake.store.stats.gc_objects_swept == 0
    real, swept, kept = gc(lake)
    assert (real["swept_objects"], real["bytes_reclaimed"]) == (dry["swept_objects"], dry["bytes_reclaimed"])
    return dry, real, swept, kept


@pytest.mark.parametrize("case", [_gc_default_keeps_history, _gc_reclaims_failed_run, _gc_dry_run],
                         ids=lambda c: c.__name__.strip("_"))
def test_gc_sweeps_the_same_keys(tmp_path, case):
    parity(case, tmp_path)


def _grace_and_dedup(pkg, path):
    store = pkg.io.ObjectStore(path / "lake")
    live_key = store.put(b"still referenced")
    garbage = store.put(b"unreachable but fresh")
    r1 = store.sweep({live_key}, grace_s=3600.0)
    assert r1.swept == 0 and r1.kept_young == 1 and store.exists(garbage)
    r2 = store.sweep({live_key}, grace_s=0.0)
    assert r2.swept == 1 and store.exists(live_key) and not store.exists(garbage)
    key = store.put(b"shared content")
    os.utime(store._object_path(key), (1.0, 1.0))
    assert store.object_age_s(key) > 3600
    store.put(b"shared content")
    assert store.object_age_s(key) < 60
    r3 = store.sweep(set(), grace_s=3600.0)
    assert r3.swept == 0 and store.exists(key)
    return [(r.swept, r.kept_young) for r in (r1, r2, r3)], sorted(store.keys())


def test_gc_grace_spares_young_objects_and_dedup_rearms_it(tmp_path):
    parity(_grace_and_dedup, tmp_path)


@lake_case
def _run_pins(lake):
    lake.seed()
    pinned = lake.catalog.head("main").commit_id
    lake.run(lake.dated("2019-04-05"))
    lake.pkg.core_snapshot.RunRegistry(lake.store).pin_run(123, pinned)
    first = gc(lake, history=1)
    assert len(lake.read_table(commit_id=pinned)["pickup_at"]) == 2000
    second = gc(lake, history=1, pin_ttl_s=0.0)
    assert lake.catalog.get_commit_opt(pinned) is None
    res = lake.run(lake.taxi())
    lake.runner.replay(lake.taxi(), res.run_id)
    # the runner unpins its own runs after run and replay (only the
    # hand-made pin 123 may remain)
    pins = lake.pkg.core_snapshot.RunRegistry(lake.store).pinned_commits()
    assert set(pins) <= {123}
    return first, second, sorted(pins)


def test_gc_respects_run_pins_until_ttl_and_runner_unpins(tmp_path):
    parity(_run_pins, tmp_path)


# ------------------------------------------------- gc roots across catalog
@lake_case
def _tag_survives(lake):
    lake.seed()
    r1 = lake.run(lake.dated("2019-04-01"))
    lake.catalog.tag("release", r1.merged_commit)
    lake.run(lake.dated("2019-04-05"))
    lake.run(lake.dated("2019-04-09"))
    out = gc(lake, history=1)
    tagged = lake.catalog.get_commit(lake.catalog.resolve_tag("release"))
    for key in tagged.tables.values():
        assert lake.fmt.read(lake.fmt.load_snapshot(key))
    q = lake.runner.query("SELECT pickup_location_id, counts FROM pickups", commit_id=r1.merged_commit)
    assert len(q["counts"]) > 0
    return out, as_lists(q)


@lake_case
def _merged_then_deleted(lake):
    lake.seed()
    lake.run(lake.taxi(), branch="feat")
    lake.catalog.merge("feat", "main", delete_source=True)
    assert not lake.catalog.has_branch("feat")
    out = gc(lake)
    q = lake.runner.query("SELECT pickup_location_id, counts FROM pickups")
    assert len(q["counts"]) > 0
    for key in lake.catalog.tables().values():
        assert lake.fmt.snapshot_object_keys(key)
    return out, as_lists(q)


@lake_case
def _replay_after_gc(lake):
    lake.seed()
    first = lake.run(lake.taxi())
    out = gc(lake)
    again = lake.runner.replay(lake.taxi(), first.run_id)
    assert again.artifacts == first.artifacts
    return out, sorted(again.artifacts.items())


@lake_case
def _unmerged_deleted_branch(lake):
    lake.seed()
    res = lake.run(lake.dated("2019-03-01"), branch="scratch")
    lake.catalog.delete_branch("scratch")
    young = gc(lake, grace_s=3600.0)
    assert young[0]["swept_commits"] == 0
    dry = report_dict(lake.m.collect_garbage(lake.store, lake.catalog, lake.fmt, dry_run=True))
    assert dry["swept_objects"] == 0  # the cache still roots the artifacts
    prune_all(lake)
    out = gc(lake, grace_s=0.0)
    assert out[0]["swept_objects"] > 0 and out[0]["swept_commits"] > 0
    assert not lake.store.exists(res.artifacts["trips"])
    assert len(lake.read_table())
    return young, out


@pytest.mark.parametrize("case", [_tag_survives, _merged_then_deleted, _replay_after_gc,
                                  _unmerged_deleted_branch], ids=lambda c: c.__name__.strip("_"))
def test_gc_roots_across_the_catalog(tmp_path, case):
    parity(case, tmp_path)


# ------------------------------------------------------- acceptance: taxi
@lake_case
def _acceptance(lake):
    lake.seed()
    dates = ["2019-02-01", "2019-02-05", "2019-02-09", "2019-02-13"]
    for since in dates:
        res = lake.run(lake.dated(since))
    lake.catalog.tag("latest", res.merged_commit)
    baseline = lake.runner.query("SELECT pickup_location_id, counts FROM pickups")
    before = lake.store_bytes()
    last_run_bytes = sum(e.output_bytes for e in lake.registry().entries().values()
                         if e.run_id == res.run_id)
    evicted = lake.m.prune_cache(lake.registry(), lake.m.EvictionPolicy(max_bytes=last_run_bytes))
    out = gc(lake, history=1, grace_s=0.0)
    frac = 1.0 - lake.store_bytes() / before
    assert out[0]["bytes_reclaimed"] > 0 and frac >= 0.5
    q = lake.runner.query("SELECT pickup_location_id, counts FROM pickups")
    np.testing.assert_array_equal(q["counts"], baseline["counts"])
    tagged = lake.catalog.get_commit(lake.catalog.resolve_tag("latest"))
    assert lake.fmt.read(lake.fmt.load_snapshot(tagged.tables["pickups"]))
    warm = lake.run(lake.dated(dates[-1]))
    assert warm.stats["cache"]["hits"] >= 2 and warm.stats["cache"]["stages_executed"] <= 1
    return out, evicted.entries_evicted, frac, warm.stats["cache"], as_lists(q)


def test_gc_acceptance_reclaims_half_while_readers_survive(tmp_path):
    parity(_acceptance, tmp_path)


# --------------------------------------------------------------- eviction
def _eviction(pkg, path):
    Entry = pkg.core_snapshot.StageCacheEntry
    m = pkg.maintenance

    def registry(name):
        store = pkg.io.ObjectStore(path / name)
        return store, pkg.core.StageCacheRegistry(store)

    def entry(fp, *, bytes_=100, used=0.0):
        return Entry(fingerprint=fp, outputs={}, checks={}, output_bytes=bytes_,
                     run_id=1, created_at=used, last_used_at=used)

    _, reg = registry("ttl")
    reg.put(entry("old", used=100.0))
    reg.put(entry("fresh", used=900.0))
    ttl = m.prune_cache(reg, m.EvictionPolicy(ttl_s=500.0), now=1000.0)
    assert ttl.entries_evicted == 1 and set(reg.entries()) == {"fresh"}

    store, reg = registry("lru")
    for i in range(5):
        reg.put(entry(f"e{i}", used=float(i)))
    lru = m.prune_cache(reg, m.EvictionPolicy(max_bytes=250))
    assert lru.entries_evicted == 3 and set(reg.entries()) == {"e3", "e4"}
    assert reg.total_bytes() == 200 and store.stats.cache_entries_evicted == 3

    store, reg = registry("dry")
    reg.put(entry("a"))
    dry = m.prune_cache(reg, m.EvictionPolicy(max_bytes=0), dry_run=True)
    assert dry.entries_evicted == 1 and dry.dry_run
    assert set(reg.entries()) == {"a"} and store.stats.cache_entries_evicted == 0
    return [report_dict(r) for r in (ttl, lru, dry)]


def test_eviction_ttl_lru_and_dry_run(tmp_path):
    parity(_eviction, tmp_path)


@lake_case
def _lru_clock_and_release(lake):
    lake.seed()
    reg = lake.registry()
    lake.run(lake.taxi())
    before = reg.entries()
    warm = lake.run(lake.taxi())
    assert warm.stats["cache"]["hits"] > 0
    after = reg.entries()
    assert any(after[fp].last_used_at > before[fp].last_used_at for fp in before)
    assert all(after[fp].created_at == before[fp].created_at for fp in before)
    res = lake.run(lake.dated("2019-03-01"), branch="scratch")
    lake.catalog.delete_branch("scratch")
    assert lake.m.collect_garbage(lake.store, lake.catalog, lake.fmt, dry_run=True).swept_objects == 0
    pruned = prune_all(lake)
    out = gc(lake)
    assert out[0]["swept_objects"] > 0 and not lake.store.exists(res.artifacts["trips"])
    return sorted(before), pruned.entries_evicted, pruned.bytes_released, out


def test_cache_hits_touch_the_lru_clock_and_eviction_releases_blobs(tmp_path):
    parity(_lru_clock_and_release, tmp_path)


@lake_case
def _content_memos(lake):
    rng = np.random.default_rng(0)
    s1 = lake.fmt.write("taxi_table", lake.pkg.TAXI_SCHEMA, lake.pkg.make_taxi_data(1000, rng))
    lake.catalog.commit("main", {"taxi_table": lake.fmt.manifest_key(s1)})
    lake.run(lake.taxi())
    s2 = lake.fmt.write("taxi_table", lake.pkg.TAXI_SCHEMA, lake.pkg.make_taxi_data(1500, rng))
    lake.catalog.commit("main", {"taxi_table": lake.fmt.manifest_key(s2)})
    lake.run(lake.taxi())
    assert set(lake.store.list_refs("contenthash")) == {s1.snapshot_id, s2.snapshot_id}
    prune_all(lake)
    out = gc(lake, history=1, grace_s=0.0)
    assert out[0]["swept_content_refs"] == 1
    assert set(lake.store.list_refs("contenthash")) == {s2.snapshot_id}
    return out


@lake_case
def _history_zero_refused(lake):
    lake.seed()
    with pytest.raises(ValueError, match="history") as e1:
        lake.m.collect_garbage(lake.store, lake.catalog, lake.fmt, history=0)
    with pytest.raises(ValueError, match="history") as e2:
        lake.m.mark(lake.store, lake.catalog, lake.fmt, history=-1)
    assert lake.catalog.head("main") and lake.read_table()
    return str(e1.value), str(e2.value), sorted(lake.keys())


@pytest.mark.parametrize("case", [_content_memos, _history_zero_refused],
                         ids=lambda c: c.__name__.strip("_"))
def test_gc_memos_and_refusals(tmp_path, case):
    parity(case, tmp_path)


# ------------------------------------------------------------- compaction
def _manifest(lake, key):
    snap = lake.fmt.load_snapshot(key)
    return key, [(s.num_rows, sorted(s.column_stats.items())) for s in snap.shards]


@lake_case
def _compaction(lake):
    data = lake.fragmented()
    old_key = lake.catalog.table_key("taxi_table")
    before = lake.fmt.load_snapshot(old_key)
    assert len(before.shards) == 20
    report = lake.m.compact_table(lake.catalog, lake.fmt, "taxi_table", target_rows=1000)
    assert report.shards_merged == 20 and report.shards_after < report.shards_before
    after = lake.fmt.load_snapshot(lake.catalog.table_key("taxi_table"))
    assert len(after.shards) == report.shards_after
    a, b = lake.fmt.read(before), lake.fmt.read(after)
    for col in lake.pkg.TAXI_SCHEMA.names:
        np.testing.assert_array_equal(a[col], b[col])
    assert lake.store.stats.compact_shards_merged == 20
    parent = lake.catalog.head("main").parent_id
    assert lake.catalog.table_key("taxi_table", commit_id=parent) == old_key
    swept = gc(lake, history=1)
    assert not lake.store.exists(old_key)
    np.testing.assert_array_equal(lake.read_table()["pickup_at"], data["pickup_at"])
    rep = report_dict(report)
    rep.pop("commit_id")
    return rep, _manifest(lake, lake.catalog.table_key("taxi_table")), swept


@lake_case
def _compaction_guards(lake):
    data = lake.fragmented()
    pred = lake.pkg.table.Predicate("pickup_at", ">=", float(data["pickup_at"][1200]))
    before = lake.fmt.load_snapshot(lake.catalog.table_key("taxi_table"))
    lake.m.compact_table(lake.catalog, lake.fmt, "taxi_table", target_rows=500, guard_predicates=[pred])
    after = lake.fmt.load_snapshot(lake.catalog.table_key("taxi_table"))
    for shard in after.shards:
        col = lake.fmt.read_shard(shard, ["pickup_at"])["pickup_at"]
        assert shard.column_stats["pickup_at"]["min"] == float(col.min())
        assert shard.column_stats["pickup_at"]["max"] == float(col.max())
    scan = lake.pkg.table_scan
    plan_b, plan_a = scan.plan_scan(before, predicates=[pred]), scan.plan_scan(after, predicates=[pred])
    assert plan_a.pruned_shards > 0
    eff = scan.pruning_effectiveness(after, [pred])
    assert eff > 0.0
    rows_b = scan.execute_scan(lake.fmt, plan_b)["pickup_at"]
    rows_a = scan.execute_scan(lake.fmt, plan_a)["pickup_at"]
    np.testing.assert_array_equal(np.asarray(rows_b), np.asarray(rows_a))
    return _manifest(lake, lake.catalog.table_key("taxi_table")), plan_a.pruned_shards, eff


@lake_case
def _compaction_noop_and_dry_run(lake):
    rng = np.random.default_rng(0)
    snap = lake.fmt.write("t", lake.pkg.TAXI_SCHEMA, lake.pkg.make_taxi_data(1000, rng))
    lake.catalog.commit("main", {"t": lake.fmt.manifest_key(snap)})
    noop = lake.m.compact_table(lake.catalog, lake.fmt, "t", target_rows=100)
    assert noop.shards_merged == 0 and noop.commit_id is None
    assert lake.catalog.table_key("t") == lake.fmt.manifest_key(snap)
    lake.fragmented()
    head, puts = lake.catalog.head("main").commit_id, lake.store.stats.puts
    dry = lake.m.compact_table(lake.catalog, lake.fmt, "taxi_table", target_rows=1000, dry_run=True)
    assert dry.dry_run and dry.shards_merged == 20
    assert lake.catalog.head("main").commit_id == head and lake.store.stats.puts == puts
    return report_dict(noop), report_dict(dry)


@lake_case
def _compaction_conflict(lake):
    lake.fragmented()
    old_key = lake.catalog.table_key("taxi_table")
    newer = lake.fmt.write("taxi_table", lake.pkg.TAXI_SCHEMA,
                           lake.pkg.make_taxi_data(50, np.random.default_rng(1)))
    newer_key = lake.fmt.manifest_key(newer)
    original = lake.fmt.load_snapshot

    def racy_load(key):
        snap = original(key)
        if key == old_key:
            lake.catalog.commit("main", {"taxi_table": newer_key})
        return snap

    lake.fmt.load_snapshot = racy_load
    try:
        with pytest.raises(lake.pkg.catalog_nessie.MergeConflict) as e:
            lake.m.compact_table(lake.catalog, lake.fmt, "taxi_table", target_rows=1000)
    finally:
        lake.fmt.load_snapshot = original
    assert lake.catalog.table_key("taxi_table") == newer_key
    return newer_key, type(e.value).__name__


@lake_case
def _compaction_keeps_cache_warm(lake):
    lake.seed()
    cold = lake.run(lake.taxi())
    before = lake.fmt.load_snapshot(lake.catalog.table_key("taxi_table"))
    report = lake.m.compact_table(lake.catalog, lake.fmt, "taxi_table", target_rows=1000)
    assert report.shards_merged > 0
    after = lake.fmt.load_snapshot(lake.catalog.table_key("taxi_table"))
    assert after.snapshot_id != before.snapshot_id
    assert lake.fmt.content_fingerprint(after) == lake.fmt.content_fingerprint(before)
    warm = lake.run(lake.taxi())
    assert warm.stats["cache"]["nodes_executed"] == 0
    assert warm.artifacts == cold.artifacts
    return _manifest(lake, lake.catalog.table_key("taxi_table")), warm.stats["cache"], sorted(warm.artifacts.items())


@pytest.mark.parametrize("case", [_compaction, _compaction_guards, _compaction_noop_and_dry_run,
                                  _compaction_conflict, _compaction_keeps_cache_warm],
                         ids=lambda c: c.__name__.strip("_"))
def test_compaction_gives_the_same_manifests(tmp_path, case):
    parity(case, tmp_path)


# -------------------------------------------------------------------- cli
def _cli_maintenance(pkg, path):
    lake = Lake(pkg, path, executor=False)
    lake.fragmented(1000, 100)
    orphan = lake.store.put(b"orphan blob")
    root = path / "lake"
    outs = []
    for argv, needle in [
        (["gc", "--dry-run", "--grace", "0"], "would reclaim"),
        (["gc", "--grace", "0"], "reclaimed"),
        (["compact", "taxi_table", "--target-rows", "500"], "shards merged"),
        (["cache", "stats"], "0 entries"),
        (["cache", "prune", "--max-bytes", "0"], "evicted 0/0"),
    ]:
        code, out = pkg.cli("--lake", root, *argv)
        assert code == 0 and needle in out, (argv, out)
        outs.append(out.replace(str(root), "<lake>"))
        if argv[:2] == ["gc", "--dry-run"]:
            assert lake.store.exists(orphan)
    assert not lake.store.exists(orphan)
    assert "rewrote" in outs[2]
    # commit ids hash wall-clock timestamps
    import re

    return [re.sub(r"\b[0-9a-f]{12,}\b", "<id>", o) for o in outs]


def test_cli_maintenance_verbs(tmp_path):
    parity(_cli_maintenance, tmp_path)
