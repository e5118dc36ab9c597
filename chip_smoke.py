#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``), then build the
   ``fused_filter_agg`` CUDA kernel from ``src/`` and print the build
   time and ptxas's report;
2. hold the kernel against its plain PyTorch version at n = 2^23 and
   2^23 + 1000 rows, for 64, 265 and 1024 groups and all six predicate
   ops: counts and integer-valued sums exactly equal, float sums within
   1e-5 * sum|v| of a float64 oracle, two launches on the same float
   input bitwise equal;
3. the interactive query path at full size: write 2^23 rows of
   ``make_taxi_data`` (seed 0) into a temporary lake through the port and
   run Q1-Q3 through ``Runner.query`` on ``cuda``.  Each must equal a
   numpy int64 oracle; Q1 and Q2 must equal the same query with
   ``engine="jnp"`` byte for byte, and the kernel's launch count must have
   grown on the kernel routes.  Then each query runs 5 more times and the
   median of each phase is printed;
4. at the inputs Q2 hands the kernel, hold the kernel against its plain
   version (exactly equal: the sums are of integers), time the kernel,
   its plain version and ``torch.bincount`` (CUDA events, L2 flushed
   between launches, median of 25; launches queued ahead so the events
   bracket device time only where the function does not synchronise,
   ``wrapper_ms`` the kernel one launch at a time with the wrapper's
   host time) and
   print one ``{"kernels": [...]}`` line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_MAIN = 2 ** 23
OPS = ("ge", "gt", "le", "lt", "eq", "ne")
TIMING_REPS = 25
LATENCY_REPS = 5
#: card cycles to hold the stream while the host queues the timed
#: launches (about 25 ms at the H100's clock), so host time is hidden
QUEUE_CYCLES = 50_000_000

#: device memory rate by card, bytes/s (NVIDIA data sheets)
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_RATE = 3.35e12
#: float32 rate outside the tensor cores (H100 SXM data sheet)
FP32_RATE = 67e12

Q1 = ("SELECT pickup_location_id, COUNT(*) AS n FROM taxi_table "
      "WHERE pickup_at >= '2019-04-01' GROUP BY pickup_location_id "
      "ORDER BY pickup_location_id")
Q2 = ("SELECT pickup_location_id, COUNT(*) AS n, SUM(passenger_count) AS riders, "
      "AVG(passenger_count) AS mean_riders FROM taxi_table "
      "WHERE pickup_at >= '2019-04-01' AND (passenger_count > 35 OR "
      "dropoff_location_id < 8) GROUP BY pickup_location_id ORDER BY riders DESC")
Q3 = ("SELECT pickup_location_id, dropoff_location_id, COUNT(*) AS counts "
      "FROM taxi_table WHERE pickup_at >= '2019-04-01' "
      "GROUP BY pickup_location_id, dropoff_location_id ORDER BY counts DESC")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    return H100_SXM_RATE


# --------------------------------------------------------------- phase 1
def build_kernels(ops):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    ops.load()
    secs = time.perf_counter() - t0
    print(f"build: fused_filter_agg.cu in {secs:.2f} s "
          f"(nvcc {build.BUILD_SECONDS.get('fused_filter_agg', 0.0):.2f} s)")
    for line in build.BUILD_LOG.get("fused_filter_agg", "").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


# --------------------------------------------------------------- phase 2
def kernel_vs_plain(torch, ops, ref):
    worst = 0.0
    dev = torch.device("cuda")
    for n in (N_MAIN, N_MAIN + 1000):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for G in (64, 265, 1024):
            # keys span [-1, G]: -1 and G must be dropped
            keys = torch.randint(-1, G + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
            vals_i = torch.randint(-50, 51, (n,), generator=gen, device=dev, dtype=torch.int32)
            vals_f = torch.randn(n, generator=gen, device=dev)
            filt_i = torch.randint(0, 100, (n,), generator=gen, device=dev, dtype=torch.int32)
            filt_f = filt_i.to(torch.float32)
            for op in OPS:
                kw = dict(op=op, threshold=42.0, num_groups=G)
                # integer values, int32 filter: exact against plain and int64
                s_k, c_k = ops.fused_filter_agg(keys, vals_i, filt_i, **kw)
                torch.cuda.synchronize()
                s_p, c_p = ref.fused_filter_agg_ref(keys, vals_i, filt_i, **kw)
                keep = ref._mask(filt_i, op, 42.0) & (keys >= 0) & (keys < G)
                idx = keys[keep].long()
                s64 = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
                    0, idx, vals_i[keep].long())
                c64 = torch.bincount(idx, minlength=G)
                check(torch.equal(c_k, c_p), f"counts vs plain n={n} G={G} {op}")
                check(torch.equal(c_k.long(), c64), f"counts vs int64 n={n} G={G} {op}")
                check(torch.equal(s_k, s_p), f"int sums vs plain n={n} G={G} {op}")
                check(torch.equal(s_k.long(), s64), f"int sums vs int64 n={n} G={G} {op}")
                # float values, float32 filter: tolerance + bitwise repeatability
                s_k, c_k = ops.fused_filter_agg(keys, vals_f, filt_f, **kw)
                s_k2, _ = ops.fused_filter_agg(keys, vals_f, filt_f, **kw)
                torch.cuda.synchronize()
                s_p, c_p = ref.fused_filter_agg_ref(keys, vals_f, filt_f, **kw)
                f64 = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(
                    0, idx, vals_f[keep].double())
                a64 = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(
                    0, idx, vals_f[keep].double().abs())
                err = (s_k.double() - f64).abs()
                check(bool((err <= 1e-5 * a64).all()), f"float sums vs f64 n={n} G={G} {op}")
                check(torch.equal(s_k.view(torch.int32), s_k2.view(torch.int32)),
                      f"repeat launch not bitwise equal n={n} G={G} {op}")
                check(torch.equal(c_k, c_p), f"float-run counts n={n} G={G} {op}")
                worst = max(worst, float((s_k - s_p).abs().max()))
                torch.cuda.synchronize()
    print(f"kernel vs plain: 72 cases pass (2 sizes x 3 group counts x 6 ops x "
          f"int/float); max |kernel - plain| float sum {worst!r}")
    return worst


# --------------------------------------------------------------- phase 3
def oracle_q1(data, april_1, np):
    m = data["pickup_at"] >= april_1
    keys, counts = np.unique(data["pickup_location_id"][m].astype(np.int64), return_counts=True)
    return {"pickup_location_id": keys.astype(np.int32), "n": counts.astype(np.int32)}


def oracle_q2(data, april_1, np):
    pc = data["passenger_count"].astype(np.int64)
    m = (data["pickup_at"] >= april_1) & ((pc > 35) | (data["dropoff_location_id"] < 8))
    pick = data["pickup_location_id"][m].astype(np.int64)
    keys, inv, counts = np.unique(pick, return_inverse=True, return_counts=True)
    riders = np.zeros(len(keys), np.int64)
    np.add.at(riders, inv, pc[m])
    order = np.lexsort((keys, -riders))
    mean = riders.astype(np.float32) / counts.astype(np.float32)
    return {
        "pickup_location_id": keys[order].astype(np.int32),
        "n": counts[order].astype(np.int32),
        "riders": riders[order].astype(np.int32),
        "mean_riders": mean[order].astype(np.float32),
    }


def oracle_q3(data, april_1, np):
    m = data["pickup_at"] >= april_1
    pick = data["pickup_location_id"][m].astype(np.int64)
    drop = data["dropoff_location_id"][m].astype(np.int64)
    pairs, counts = np.unique(pick * 64 + drop, return_counts=True)
    p, d = pairs // 64, pairs % 64
    order = np.lexsort((d, p, -counts))
    return {
        "pickup_location_id": p[order].astype(np.int32),
        "dropoff_location_id": d[order].astype(np.int32),
        "counts": counts[order].astype(np.int32),
    }


def same_bytes(a, b) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a
    )


def query_path(np, torch, ops):
    from repro_torch.catalog import Catalog
    from repro_torch.core import Runner
    from repro_torch.examples_data import APRIL_1, TAXI_SCHEMA, make_taxi_data
    from repro_torch.io import ObjectStore
    from repro_torch.table import TableFormat
    from repro_torch.telemetry import EventBus

    data = make_taxi_data(N_MAIN, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = ObjectStore(Path(tmp) / "lake")
        fmt = TableFormat(store)
        catalog = Catalog(store)
        snap = fmt.write("taxi_table", TAXI_SCHEMA, data)
        catalog.commit("main", {"taxi_table": fmt.manifest_key(snap)},
                       message="write_table taxi_table")
        print(f"lake: {snap.num_rows} rows in {len(snap.shards)} shards "
              f"written in {time.perf_counter() - t0:.2f} s")

        bus = EventBus()
        sub = bus.subscribe(maxlen=65536)
        runner = Runner(catalog, fmt, bus=bus)  # the default device: cuda
        check(runner.device.type == "cuda", f"runner on {runner.device}")

        def run(name, sql, engine, want_path):
            before = ops.LAUNCHES
            out = runner.query(sql, engine=engine)
            ev = [e for e in sub.drain() if type(e).__name__ == "QueryExecuted"][-1]
            launched = ops.LAUNCHES - before
            check(ev.engine_path == want_path,
                  f"{name} engine={engine} routed {ev.engine_path}, want {want_path}")
            if want_path == "kernel":
                check(launched > 0, f"{name} routed kernel but launched nothing")
            else:
                check(launched == 0, f"{name} on {want_path} launched the kernel")
            print(f"{name} engine={engine}: path={ev.engine_path} rows={ev.rows_out} "
                  f"shards={ev.shards_read} launches={launched} parse_s={ev.parse_s!r} "
                  f"plan_s={ev.plan_s!r} scan_s={ev.scan_s!r} exec_s={ev.exec_s!r} "
                  f"wall_s={ev.wall_s!r}")
            return out

        # the main path: every launch count starts at 0 here
        ops.LAUNCHES = 0
        q1 = run("Q1", Q1, "auto", "kernel")
        q2 = run("Q2", Q2, "kernel", "kernel")
        q3 = run("Q3", Q3, "auto", "jnp")
        q1_ref = run("Q1", Q1, "jnp", "jnp")
        q2_ref = run("Q2", Q2, "jnp", "jnp")
        launches = ops.LAUNCHES
        check(launches > 0, "the main path never launched fused_filter_agg")

        for name, got, want in (("Q1", q1, oracle_q1(data, APRIL_1, np)),
                                ("Q2", q2, oracle_q2(data, APRIL_1, np)),
                                ("Q3", q3, oracle_q3(data, APRIL_1, np))):
            check(same_bytes(got, want), f"{name} differs from the numpy oracle")
        check(same_bytes(q1, q1_ref), "Q1 kernel route differs from engine='jnp'")
        check(same_bytes(q2, q2_ref), "Q2 kernel route differs from engine='jnp'")
        print(f"query path: Q1-Q3 equal the numpy oracle; Q1, Q2 byte-identical "
              f"to engine='jnp'; fused_filter_agg launches on the main path: {launches}")

        # steady state: the runs above include first-use costs (lazy
        # module loads, allocator growth), so time each query again
        phases = ("parse_s", "plan_s", "scan_s", "exec_s", "wall_s")
        for name, sql, engine in (("Q1", Q1, "auto"), ("Q2", Q2, "kernel"),
                                  ("Q3", Q3, "auto"), ("Q1", Q1, "jnp"),
                                  ("Q2", Q2, "jnp")):
            evs = []
            for _ in range(LATENCY_REPS):
                runner.query(sql, engine=engine)
                evs.append([e for e in sub.drain()
                            if type(e).__name__ == "QueryExecuted"][-1])
            print(f"{name} engine={engine} median of {LATENCY_REPS}: " + " ".join(
                f"{p}={statistics.median(getattr(e, p) for e in evs)!r}" for p in phases))

    # Q2's kernel inputs: the scan keeps rows with pickup_at >= April 1 (in
    # storage order); the OR residual feeds the kernel as a float mask
    m = data["pickup_at"] >= APRIL_1
    dev = torch.device("cuda")
    keys = torch.tensor(data["pickup_location_id"][m], device=dev)
    vals = torch.tensor(data["passenger_count"][m], device=dev)
    filt = torch.tensor(((data["passenger_count"][m] > 35)
                         | (data["dropoff_location_id"][m] < 8)).astype(np.float32), device=dev)
    return launches, (keys, vals, filt)


# --------------------------------------------------------------- phase 4
def time_ms(torch, fn, flush, queued=True):
    """Median time of ``fn`` over TIMING_REPS launches, each between its
    own pair of CUDA events, with the 50 MB L2 flushed before each.

    ``queued``: a sleep kernel holds the stream while the host queues every
    launch, so each pair of events brackets device work only.  Returns
    ``(ms, ahead)``; ``ahead`` says the host had queued everything before
    the card left the sleep.  A function that synchronises inside (the
    plain version's boolean-mask compaction) cannot get ahead, so its time
    includes the host's share.  Without ``queued`` each launch waits for
    the last, so the time includes the wrapper's own host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(TIMING_REPS)]
    gate = torch.cuda.Event()
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    gate.record()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
        if not queued:
            end.synchronize()
    ahead = queued and not gate.query()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs), ahead


def measure(torch, ops, ref, launches, inputs, card):
    keys, vals, filt = inputs
    n, G = keys.shape[0], 64
    kw = dict(op="ge", threshold=0.5, num_groups=G)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    s_k, c_k = ops.fused_filter_agg(keys, vals, filt, **kw)
    s_p, c_p = ref.fused_filter_agg_ref(keys, vals, filt, **kw)
    torch.cuda.synchronize()
    # integer values with group sums below 2^24: the f32 sums are exact
    check(torch.equal(s_k, s_p) and torch.equal(c_k, c_p),
          f"kernel vs plain at Q2's inputs (n={n}, G={G})")
    max_err = max(float((s_k - s_p).abs().max()), float((c_k - c_p).abs().max()))
    keep = filt >= 0.5
    mkeys, mvals = keys[keep], vals[keep].to(torch.float32)
    before = ops.LAUNCHES
    kernel = lambda: ops.fused_filter_agg(keys, vals, filt, **kw)  # noqa: E731
    kernel_ms, ahead = time_ms(torch, kernel, flush)
    check(ahead, "the host fell behind the card while queuing the kernel's launches")
    wrapper_ms, _ = time_ms(torch, kernel, flush, queued=False)
    plain_ms, _ = time_ms(torch, lambda: ref.fused_filter_agg_ref(keys, vals, filt, **kw), flush)
    library_ms, library_ahead = time_ms(
        torch, lambda: torch.bincount(mkeys, weights=mvals, minlength=G), flush)
    print(f"timing: kernel device-only {ahead}, bincount device-only {library_ahead}, "
          f"plain device-only False (it synchronises)")
    ops.LAUNCHES = before  # timing launches are not main-path launches
    nbytes = n * (4 + 4 + 4) + 2 * G * 4
    bytes_ms = nbytes / memory_rate(card) * 1e3
    ops_ms = 3 * n / FP32_RATE * 1e3  # compare, add, count per row
    row = {
        "name": "fused_filter_agg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_filter_agg/csrc/fused_filter_agg.cu",
        "replaces": "src/repro/kernels/fused_filter_agg/kernel.py:81",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "wrapper_ms": wrapper_ms,
        "n": n,
        "num_groups": G,
    }
    print(json.dumps({"kernels": [row]}))


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.fused_filter_agg import ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    build_kernels(ops)
    kernel_vs_plain(torch, ops, ref)
    launches, inputs = query_path(np, torch, ops)
    measure(torch, ops, ref, launches, inputs, card)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
