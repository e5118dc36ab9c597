#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``), then build the
   three CUDA kernels from ``src/`` (one nvcc each, all started together),
   print each build time and ptxas's report, and count the wgmma (HGMMA)
   instructions in the flash library's SASS (there must be some);
2. hold ``fused_filter_agg`` against its plain PyTorch version at n in
   {0, 1, 4095, 2^23, 2^23 + 3, 2^23 + 1000} rows, for 1, 63, 64, 65,
   265 and 1024 groups and all six predicate ops, on views that start 1,
   2 or 3 elements past a 16-byte boundary (also each column on its own
   offset), and on columns whose every row has one key: counts and
   integer-valued sums exactly equal, float sums within 1e-5 * sum|v| of
   a float64 oracle, two launches on the same float input bitwise equal,
   an offset view bitwise equal to its rows copied to aligned memory, and
   8 launches on two streams at once bitwise equal;
3. the interactive query path at full size: write 2^23 rows of
   ``make_taxi_data`` (seed 0) into a temporary lake through the port and
   run Q1-Q3 through ``Runner.query`` on ``cuda``.  Each must equal a
   numpy int64 oracle; Q1 and Q2 must equal the same query with
   ``engine="jnp"`` byte for byte, and the kernel's launch count must have
   grown on the kernel routes.  Then each query runs 5 more times and the
   median of each phase is printed;
3b. the pipeline run on the same lake: ``Runner.run`` of the Appendix
   pipeline (trips -> trips_expectation -> pickups) plus ``zone_riders``
   (Q1's SQL, the node the route sends to ``fused_filter_agg``) on
   ``cuda`` through a ``ServerlessExecutor`` (stages on its worker
   threads), with the launch counts set to 0 just before: the run must
   merge with the audit passing, route zone_riders to the kernel, launch
   it, and write pickups and zone_riders equal to the numpy oracles of Q3
   and Q1.  Then, each on a fresh lake with the cache off, parallelism 1
   in stage-id order without streaming, parallelism 8 critical-path-first
   with streaming, fusion off, and ``sql_engine="jnp"`` must give the
   same manifest keys, outputs and verdicts; a warm re-run must execute
   0 nodes, ``replay`` must give the cold run's artifacts, and a run whose
   audit fails must roll back.  The median wall time of cold and warm
   runs, each stage's exec_s and queue_s, the scans' share, the kernel's
   launches, peak device memory and the device's busy share over one
   cold run (``torch.profiler``) are printed with the card's name and
   power limit;
3c. the SDK and the CLI on a fresh lake of the same 2^23 rows, written
   by ``Client(root, shard_rows=65536).write_table`` on the card (the
   default device), with the launch counts set to 0 just before:
   ``client.query`` of Q1-Q3 equal to the numpy oracles, and
   ``client.explain``'s verdicts equal to the routes the queries ran
   (kernel, kernel, jnp); ``with client.branch("feat") as b:
   b.run(path)`` of a pipeline file (the Appendix pipeline plus
   zone_riders, registered with ``repro_torch.project`` / ``.sql`` /
   ``.expectation``) must succeed and merge, and a warm re-run, before
   and after ``client.compact`` (16 shards into 1), execute 0 nodes;
   ``client.gc`` must reclaim the compacted shards with Q1-Q3 unchanged;
   a run whose audit fails is an ``AUDIT_FAILED`` handle that leaves no
   branch; two ``run_async`` runs on two branches at once both merge,
   launching the kernel; the run's trace holds run, stage and node spans
   and a critical path; a second ``Client`` estimates from the persisted
   latency history (``src=latency``); and ``python -m repro_torch.cli``
   runs ``query``, ``run``, ``trace``, ``explain --json``, ``gc
   --dry-run`` and ``cache stats`` as processes, each exiting 0, the
   query printing what ``client.query`` returned.  The Client's query
   time beside its ``Runner.query`` on the same lake and phase 3's, the
   cold and warm branch runs, compact and gc, the async runs and each
   CLI process are timed and printed with the card's name and power
   limit;
4. at the inputs Q2 hands the kernel, hold the kernel against its plain
   version (exactly equal: the sums are of integers) and time the kernel,
   its plain version and ``torch.bincount``;
5. hold ``flash_attention`` and ``decode_attention`` against their plain
   versions: decode at B in {1, 4}, H/Hkv in {32/4, 48/1}, S in {1024,
   4096}, lengths 1, S-1, S, 0 and the split's chunk - 1, chunk and
   chunk + 1; flash at S in {512, 2048} (and a ragged 200), causal,
   non-causal and window 256, GQA 32/4, at head dim 128, and at S = 512
   causal, with and without window 256, at head dims 32 and 64 (the
   CUDA-core kernel in both dtypes); at head dims 80 (64/8 heads) and 120
   (32/8), decode at B = 4, S = 4096 with lengths 1, S-1, S, 0 and the
   chunk edges, flash at S in {512, 200} causal, non-causal and window
   256 and at S = 200 with window 64, and mask probes at S in {512,
   2048}; at phase 6e's head layouts (MHA 16/16 and GQA 16/8 at head dim
   128, MHA 24/24 at head dim 64), decode at B = 4, S = 4096 with lengths
   1, S-1, S, 0 and the chunk edges, flash at S in {512, 2048} (2048
   alone at 24/24) causal and non-causal, and a mask probe at S = 2048;
   plus mask probes (``mask_probe``: keys past the
   diagonal or outside the window carry large scores and v = +-64, so a
   leak moves outputs by whole units) at S in {512, 2048}; float32 and
   bfloat16.  Decode and float32 flash within 1e-5 + 1e-5 |plain| (sums
   in another order); bfloat16 decode and bfloat16 flash at head dims 32
   and 64 (``flash_fwd``) within one bf16 ulp of the output (both round
   once from float32) plus that 1e-5; bf16 flash at head dims 80, 120 and
   128 (``flash_wgmma``) by ``flash_bf16_close``: its largest and mean
   |kernel - plain| at most twice those of the reference's chunked bf16
   route (``flash_yardstick``) plus 1e-5, since the kernel's tensor-core
   products round p to bf16 as that route does.  Two launches bitwise
   equal;
6. serve Yi-6B at full width and depth on ``cuda`` (random weights from
   a seeded generator, TF32 off): ``ServeEngine.generate`` on 6 requests
   over 4 slots of 4096 positions, 16 new tokens each, through the
   kernels (``use_flash_kernel=True``), then ``LM.forward`` on one
   2048-token prompt.  The launch counts, set to 0 just before, must grow
   by 32 a decode step and 32 a forward.  The same requests and prompt
   then go through the reference route (``use_flash_kernel=False``), and
   the two routes must agree: teacher-forced decode logits and forward
   logits within LOGIT_TOL (largest) and LOGIT_MEAN_TOL (mean), the
   greedy tokens equal up to a request's first near tie (top-2 margin
   within LOGIT_TOL), and the kernel route's decode logits equal its
   forward logits within LOGIT_TOL.  Latencies, step times, tokens/s,
   peak memory and a profile of PROFILE_STEPS decode steps are printed;
6b. the same for h2o-danube-3-4b (head dim 120) and qwen3-32b (head dim
   80) at full width and CUT_LAYERS layers (``serve_cut``): requests
   through ``ServeEngine`` and a forward on both routes, launch counts
   of CUT_LAYERS a step and a forward, logits within the same limits;
6c. the same two configs at full width and full depth (24 and 64 layers,
   ``forward_full``) on the kernel route: init time and peak memory, one
   2048-token ``LM.forward`` with flash_attention launched once a layer
   and finite logits, its time (median of FORWARD_REPS) and peak memory;
6d. train -> commit -> check out -> serve (``train_serve``): Yi-6B at
   full width and TRAIN_LAYERS layers trains through
   ``repro_torch.train.TrainLoop`` on the card (reference attention,
   deterministic algorithms), batches drawn by step from a synthetic Zipf
   token table in a temporary lake, checkpoints committed to catalog
   branches: an uninterrupted run A of TRAIN_STEPS steps, a run B that
   stops at CRASH_AT, and a run C that resumes it must end on the same
   leaf keys (content addresses); the loss must fall and the audit pass;
   the checkpoint is promoted to main, its params checked out, and the
   serving ``LM`` (``params_from_numpy``) served like phase 6 on both
   routes under phase 6's limits, the launch counts set to 0 just
   before (TRAIN_LAYERS a decode step and a forward).  Step time,
   tokens/s, peak memory, the device's busy share over
   TRAIN_PROFILE_STEPS profiled steps, each checkpoint's bytes and save,
   async-save and restore seconds, and the phase's seconds are printed
   with the card's name and power limit;
6e. the MoE, vision-language and audio families (``serve_families``):
   qwen2-moe-a2.7b, internvl2-2b and musicgen-medium at full width and
   full depth, one at a time, on both routes: requests through
   ``ServeEngine`` (musicgen-medium: refused, as the JAX engine refuses
   it; teacher-forced ``decode_step`` over 4 codebooks instead) and a
   2048-position ``LM.forward`` (internvl2-2b: 256 patch embeddings and
   1792 tokens), launch counts n_layers a decode step and a forward,
   logits under phase 6's limits with the MoE rule of the function's
   docstring; init, forward, decode step, tokens/s and busy share printed;
7. time the two attention kernels at the main path's shapes like phase 4,
   and at phase 6b's and phase 6e's shapes, and print one ``{"kernels":
   [...]}`` line for all three kernels, each row with the card and its
   power limit and each flash row with the kernel that ran
   (``flash_wgmma`` or ``flash_fwd``) and, for the configs, phase 6c's or
   6e's forward time; the rows count the launches of phases 6, 6d and
   6e, path by path.

Timing (phases 4 and 7): CUDA events, L2 flushed between launches,
median of 25; ``ms`` has the launches queued behind a sleep kernel so
the events bracket device time only where the function does not
synchronise, ``wrapper_ms`` is the kernel one launch at a time with the
wrapper's host time.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
#: dense bf16 tensor-core rate (H100 SXM data sheet)
BF16_RATE = 989e12

#: phase 6: the serving run
N_REQUESTS = 6
NEW_TOKENS = 16
FORWARD_LEN = 2048
#: largest and mean |logit| difference allowed between the kernel route
#: and the reference route.  Both compute in bf16 through 32 layers; they
#: differ only in where attention rounds (the kernels keep float32 to the
#: end, the reference rounds q*scale and p to bf16 in the chunked forward,
#: and sums in another order), and each difference is carried through the
#: rest of the stack.  The logits of these random weights reach about
#: |5.5|, where a bf16 ulp is 2^-5: the largest difference may be 8 such
#: ulps, the mean one.  A wrong mask, position or head mapping moves
#: logits by whole units.
LOGIT_TOL = 0.25
LOGIT_MEAN_TOL = 0.03125
#: decode steps in the profiled window
PROFILE_STEPS = 4
#: phase 6b: h2o-danube-3-4b and qwen3-32b at full width, depth cut
CUT_ARCHS = ("h2o-danube-3-4b", "qwen3-32b")
CUT_LAYERS = 2
CUT_REQUESTS = 4
CUT_NEW_TOKENS = 8
#: phase 6c: the same two configs at full depth, forwards timed
FORWARD_REPS = 3
#: phase 6d: train -> commit -> check out -> serve, Yi-6B at full width
TRAIN_LAYERS = 4
TRAIN_BATCH = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 12
CRASH_AT = 6
TRAIN_CORPUS = 2_000_000
#: steps profiled in run A (0-based first index), left out of the median
TRAIN_PROFILE_FIRST = 3
TRAIN_PROFILE_STEPS = 3
#: phase 6e: the MoE, vision-language and audio families at full size
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "internvl2-2b", "musicgen-medium")
#: their attention layouts (heads, kv heads, head dim): qwen2-moe, internvl2,
#: musicgen
FAMILY_LAYOUTS = ((16, 16, 128), (16, 8, 128), (24, 24, 64))
#: musicgen-medium's teacher-forced decode: rows of 4 codebook tokens, steps
CODEBOOK_ROWS = 4
CODEBOOK_STEPS = 64
#: phase 5: (causal, window) of the random flash cases
FLASH_MASKS = ((True, None), (False, None), (True, 256))

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
def build_kernels(mods):
    """Build every kernel library at once, one nvcc process each."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        for fut in [pool.submit(m.load) for m in mods]:
            fut.result()
    print(f"build: {len(mods)} kernels in {time.perf_counter() - t0:.2f} s")
    for m in mods:
        stem = m.SOURCE.stem
        print(f"build: {m.SOURCE.name} (nvcc {build.BUILD_SECONDS.get(stem, 0.0):.2f} s)")
        for line in build.BUILD_LOG.get(stem, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    lib = build.built_path(flash_source(mods))
    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"build: {lib.name}: {hgmma} HGMMA (wgmma) instructions in the SASS")
    check(hgmma > 0, "the flash library has no wgmma instruction")


def flash_source(mods):
    return next(m.SOURCE for m in mods if m.SOURCE.stem == "flash_attention")


# --------------------------------------------------------------- phase 2
def bitwise_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def kernel_vs_plain(torch, ops, ref):
    """Every case: integer values with an int32 filter exactly equal to
    the plain version and to an int64 oracle; float values with a float32
    filter within 1e-5 * sum|v| of a float64 oracle, counts equal to the
    plain version's, two launches bitwise equal."""
    worst = 0.0
    dev = torch.device("cuda")
    cases = 0

    def case(keys, vals_i, vals_f, filt_i, filt_f, G, op, name):
        nonlocal worst, cases
        kw = dict(op=op, threshold=42.0, num_groups=G)
        name = f"{name} G={G} {op}"
        # integer values, int32 filter: exact against plain and int64
        s_k, c_k = ops.fused_filter_agg(keys, vals_i, filt_i, **kw)
        torch.cuda.synchronize()
        s_p, c_p = ref.fused_filter_agg_ref(keys, vals_i, filt_i, **kw)
        keep = ref._mask(filt_i, op, 42.0) & (keys >= 0) & (keys < G)
        idx = keys[keep].long()
        s64 = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
            0, idx, vals_i[keep].long())
        c64 = torch.bincount(idx, minlength=G)
        check(torch.equal(c_k, c_p), f"counts vs plain {name}")
        check(torch.equal(c_k.long(), c64), f"counts vs int64 {name}")
        check(torch.equal(s_k, s_p), f"int sums vs plain {name}")
        check(torch.equal(s_k.long(), s64), f"int sums vs int64 {name}")
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
        check(bool((err <= 1e-5 * a64).all()), f"float sums vs f64 {name}")
        check(bitwise_equal(torch, s_k, s_k2), f"repeat launch not bitwise equal {name}")
        check(torch.equal(c_k, c_p), f"float-run counts {name}")
        worst = max(worst, float((s_k - s_p).abs().max()))
        cases += 1
        return s_k

    def columns(n, G, gen, pad=0):
        """keys over [-1, G] (-1 and G must be dropped), int and float
        values, an int filter and its float copy; ``pad`` extra leading
        rows, for views that start off a 16-byte boundary."""
        m = n + pad
        keys = torch.randint(-1, G + 1, (m,), generator=gen, device=dev, dtype=torch.int32)
        vals_i = torch.randint(-50, 51, (m,), generator=gen, device=dev, dtype=torch.int32)
        vals_f = torch.randn(m, generator=gen, device=dev)
        filt_i = torch.randint(0, 100, (m,), generator=gen, device=dev, dtype=torch.int32)
        return keys, vals_i, vals_f, filt_i, filt_i.to(torch.float32)

    sizes = (0, 1, 4095, N_MAIN, N_MAIN + 3, N_MAIN + 1000)
    groups = (1, 63, 64, 65, 265, 1024)
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for G in groups:
            cols = columns(n, G, gen)
            for op in OPS:
                case(*cols, G, op, f"n={n}")
    grid_cases = cases

    # views that start 1, 2 or 3 elements past a 16-byte boundary, each
    # column on its own offset too: equal to the plain version, and
    # bitwise equal to the same rows copied to aligned memory (the rows a
    # thread owns do not depend on alignment)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (4095, N_MAIN + 3):
        for G in (64, 1024):
            keys, vals_i, vals_f, filt_i, filt_f = columns(n, G, gen, pad=3)
            for offs in ((1, 1, 1), (2, 2, 2), (3, 3, 3), (1, 2, 3), (3, 0, 2)):
                ok, ov, of = offs
                view = (keys[ok:ok + n], vals_i[ov:ov + n], vals_f[ov:ov + n],
                        filt_i[of:of + n], filt_f[of:of + n])
                check(all(t.data_ptr() % 16 for t, o in zip(view, (ok, ov, ov, of, of)) if o),
                      f"offset views {offs} start on a 16-byte boundary")
                for op in ("ge", "ne"):
                    got = case(*view, G, op, f"n={n} offsets {offs}")
                    aligned = [t.clone() for t in view]
                    want, _ = ops.fused_filter_agg(aligned[0], aligned[2], aligned[4],
                                                   op=op, threshold=42.0, num_groups=G)
                    torch.cuda.synchronize()
                    check(bitwise_equal(torch, got, want),
                          f"offset view vs aligned copy n={n} G={G} {offs} {op}")

    # every row on one key: the largest __match_any_sync group, every step
    n = N_MAIN + 3
    _, vals_i, vals_f, filt_i, filt_f = columns(n, 64, gen)
    for G, key in ((1, 0), (64, 5), (1024, 1023)):
        keys = torch.full((n,), key, dtype=torch.int32, device=dev)
        for op in ("ge", "lt"):
            case(keys, vals_i, vals_f, filt_i, filt_f, G, op, f"n={n} all rows on key {key}")

    # concurrent launches on two streams: bitwise equal to each other and
    # to the launch on the current stream
    keys, vals_i, vals_f, filt_i, filt_f = columns(N_MAIN + 1000, 265, gen)
    kw = dict(op="ge", threshold=42.0, num_groups=265)
    want, want_c = ops.fused_filter_agg(keys, vals_f, filt_f, **kw)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(ops.fused_filter_agg(keys, vals_f, filt_f, **kw))
    torch.cuda.synchronize()
    for s_k, c_k in outs:
        check(bitwise_equal(torch, s_k, want) and torch.equal(c_k, want_c),
              "launches on two streams differ")
    print(f"kernel vs plain: {cases} cases pass ({grid_cases} of n in {sizes} x G in {groups} "
          f"x 6 ops, each int and float; offset views, one-key columns); {len(outs)} "
          f"launches on two streams bitwise equal; max |kernel - plain| float sum {worst!r}")
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


def write_lake(root, data):
    """A new lake at ``root`` holding ``data`` as ``taxi_table`` on main,
    in 65,536-row shards."""
    from repro_torch.catalog import Catalog
    from repro_torch.examples_data import TAXI_SCHEMA
    from repro_torch.io import ObjectStore
    from repro_torch.table import TableFormat

    t0 = time.perf_counter()
    store = ObjectStore(root)
    fmt = TableFormat(store)
    catalog = Catalog(store)
    snap = fmt.write("taxi_table", TAXI_SCHEMA, data)
    catalog.commit("main", {"taxi_table": fmt.manifest_key(snap)},
                   message="write_table taxi_table")
    print(f"lake: {snap.num_rows} rows in {len(snap.shards)} shards "
          f"written in {time.perf_counter() - t0:.2f} s")
    return catalog, fmt


def query_path(np, torch, ops, catalog, fmt, data):
    from repro_torch.core import Runner
    from repro_torch.examples_data import APRIL_1
    from repro_torch.telemetry import EventBus

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
    walls = {}
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
        walls.setdefault(name, statistics.median(e.wall_s for e in evs))

    # Q2's kernel inputs: the scan keeps rows with pickup_at >= April 1 (in
    # storage order); the OR residual feeds the kernel as a float mask
    m = data["pickup_at"] >= APRIL_1
    dev = torch.device("cuda")
    keys = torch.tensor(data["pickup_location_id"][m], device=dev)
    vals = torch.tensor(data["passenger_count"][m], device=dev)
    filt = torch.tensor(((data["passenger_count"][m] > 35)
                         | (data["dropoff_location_id"][m] < 8)).astype(np.float32), device=dev)
    return launches, (keys, vals, filt), walls


# -------------------------------------------------------------- phase 3b
def taxi_pipeline_with_zone_riders(threshold=10.0):
    """The Appendix pipeline (trips -> trips_expectation -> pickups) plus
    ``zone_riders``, Q1's SQL over taxi_table: the one node of the
    pipeline that the route sends to fused_filter_agg (pickups groups by
    two keys over the node-sourced trips, which has no shard statistics)."""
    from repro_torch.examples_data import build_taxi_pipeline

    p = build_taxi_pipeline(threshold)
    p.sql("zone_riders", Q1)
    return p


def scan_span(events, run_id):
    """Wall seconds of each stage's host shard reads in one run: from the
    first read's start to the last read's end (reads overlap on the pool)."""
    spans = {}
    for e in events:
        if type(e).__name__ == "ScanShardRead" and e.run_id == run_id:
            lo, hi = spans.get(e.stage_id, (e.ts, e.ts + e.dur_s))
            spans[e.stage_id] = (min(lo, e.ts), max(hi, e.ts + e.dur_s))
    return {sid: hi - lo for sid, (lo, hi) in spans.items()}


def profile_run(torch, runner, smi):
    """torch.profiler over one cold run: wall time, device busy time (sum
    of the device's kernel and copy times; every stage issues its work on
    the default stream) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        res = runner.run(taxi_pipeline_with_zone_riders(), branch="profiled", cache=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    check(res.ok, "the profiled run did not merge")
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not kernels:
        print(f"pipeline profile: cold run wall {wall!r} s; the profiler recorded no device "
              f"time (device busy share not measured) [{smi}]")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"pipeline profile, one cold run: wall {wall!r} s, device busy {busy!r} s "
          f"({busy / wall:.4f} of wall, idle {1 - busy / wall:.4f}), "
          f"{sum(e.count for e in kernels)} device operations [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:.3f} ms {e.count}x {e.key[:90]}")


def pipeline_path(np, torch, ops, catalog, fmt, data, tmp, smi):
    """``Runner.run`` on the card over phase 3's lake: the Appendix
    pipeline plus zone_riders, through a ServerlessExecutor, the stages
    on its worker threads.  Returns fused_filter_agg's launches in the
    main run."""
    from repro_torch.core import ExpectationFailed, PlannerConfig, Runner
    from repro_torch.examples_data import APRIL_1
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.runtime import ExecutorConfig, ServerlessExecutor
    from repro_torch.telemetry import EventBus

    want = {"pickups": oracle_q3(data, APRIL_1, np), "zone_riders": oracle_q1(data, APRIL_1, np)}
    auto = PlannerConfig(sql_engine="auto")

    def check_run(label, res, fmt, engine_path):
        check(res.ok, f"{label}: the run did not merge")
        check(res.checks == {"trips_expectation": True}, f"{label}: checks {res.checks}")
        routes = {n: r.engine_path for s in res.plan.stages for n, r in s.sql_routes.items()}
        check(routes.get("zone_riders", engine_path) == engine_path,
              f"{label}: zone_riders routed {routes.get('zone_riders')}, want {engine_path}")
        out = {name: fmt.read(fmt.load_snapshot(key)) for name, key in res.artifacts.items()}
        for name, w in want.items():
            check(same_bytes(out[name], w), f"{label}: {name} differs from the numpy oracle")
        return out

    with ServerlessExecutor(ExecutorConfig(max_workers=8, max_concurrent_stages=8)) as ex:
        bus = EventBus()
        sub = bus.subscribe(maxlen=1 << 20)
        runner = Runner(catalog, fmt, ex, bus=bus)  # the default device: cuda
        check(runner.device.type == "cuda", f"runner on {runner.device}")

        # the main path: every launch count starts at 0 here
        ops.LAUNCHES = flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
        cold = runner.run(taxi_pipeline_with_zone_riders(), branch="pipe", planner_config=auto)
        launches = ops.LAUNCHES
        check(launches > 0, "the pipeline run never launched fused_filter_agg")
        check(flash_ops.LAUNCHES == decode_ops.LAUNCHES == 0,
              "the pipeline run launched an attention kernel")
        main_out = check_run("main run", cold, fmt, "kernel")
        print(f"pipeline main run: {len(cold.plan.stages)} stages "
              f"{[list(s.node_names) for s in cold.plan.stages]}, routes "
              f"{ {n: r.engine_path for s in cold.plan.stages for n, r in s.sql_routes.items()} }, "
              f"checks {cold.checks}, fused_filter_agg launches {launches}; pickups and "
              f"zone_riders equal the numpy oracle")

        # the same artifacts and verdicts at other schedules, fusion and
        # engine, each on a fresh lake with the cache off
        configs = (
            ("parallelism 1, stage_id, no streaming",
             dict(parallelism=1, schedule="stage_id", streaming=False), "kernel"),
            ("parallelism 8, critical_path, streaming",
             dict(parallelism=8, schedule="critical_path", streaming=True), "kernel"),
            ("fusion off", dict(planner_config=PlannerConfig(fusion=False)), "kernel"),
            ("sql_engine jnp", dict(planner_config=PlannerConfig(sql_engine="jnp")), "jnp"),
        )
        for i, (label, kw, path) in enumerate(configs):
            c2, f2 = write_lake(tmp / f"fresh{i}", data)
            before = ops.LAUNCHES
            res = Runner(c2, f2, ex).run(taxi_pipeline_with_zone_riders(), branch="pipe",
                                         cache=False, **kw)
            launched = ops.LAUNCHES - before
            out = check_run(label, res, f2, path)
            check((launched > 0) == (path == "kernel"), f"{label}: {launched} launches")
            common = {k: v for k, v in res.artifacts.items() if k in cold.artifacts}
            check(common == cold.artifacts, f"{label}: manifest keys differ from the main run")
            for name in cold.artifacts:
                check(same_bytes(out[name], main_out[name]), f"{label}: {name} differs")
            extra = sorted(set(res.artifacts) - set(cold.artifacts))
            print(f"pipeline {label}: artifacts and checks byte-identical to the main run "
                  f"(extra materialized: {extra}), launches {launched}")
            shutil.rmtree(tmp / f"fresh{i}")
        ops.LAUNCHES = launches  # comparisons are not the main path

        # the differential cache, replay, and an audit that fails
        warm = runner.run(taxi_pipeline_with_zone_riders(), branch="pipe_warm")
        check(warm.stats["cache"]["nodes_executed"] == 0,
              f"warm re-run executed {warm.stats['cache']['nodes_executed']} nodes")
        check(warm.artifacts == cold.artifacts, "warm re-run artifacts differ")
        again = runner.replay(taxi_pipeline_with_zone_riders(), cold.run_id)
        check(again.artifacts == cold.artifacts, "replay artifacts differ from the cold run")
        main_head = catalog.head("main").commit_id
        try:
            runner.run(taxi_pipeline_with_zone_riders(threshold=1000.0), branch="audit")
            check(False, "the failing audit merged")
        except ExpectationFailed as e:
            check(e.failed == ["trips_expectation"], f"failed checks {e.failed}")
        check(catalog.tables(branch="audit") == catalog.tables(branch="main"),
              "the failed run left tables on its branch")
        check(catalog.head("main").commit_id == main_head, "the failed run moved main")
        check(not [b for b in catalog.branches() if b.startswith("run_")],
              "the failed run left an ephemeral branch")
        ops.LAUNCHES = launches
        print(f"pipeline: warm re-run executed 0 nodes ({warm.stats['cache']['hits']} hits); "
              f"replay equals the cold run; the failing audit rolled back")

        # timing: cold runs (cache off) and warm runs, after the first
        sub.drain()
        torch.cuda.reset_peak_memory_stats()
        colds, warms, stage_times, spans = [], [], {}, []
        for _ in range(LATENCY_REPS + 1):
            t0 = time.perf_counter()
            res = runner.run(taxi_pipeline_with_zone_riders(), branch="timed", cache=False)
            colds.append(time.perf_counter() - t0)
            for sid, t in res.stats["stage_timings"].items():
                stage_times.setdefault(sid, []).append(t)
            span = scan_span(sub.drain(), res.run_id)
            spans.append((sum(span.values()), sum(t["exec_s"] for t in res.stats["stage_timings"].values())))
        peak = torch.cuda.max_memory_allocated()
        for _ in range(LATENCY_REPS + 1):
            t0 = time.perf_counter()
            res = runner.run(taxi_pipeline_with_zone_riders(), branch="timed")
            warms.append(time.perf_counter() - t0)
            check(res.stats["cache"]["nodes_executed"] == 0, "a warm timing run executed nodes")
        ops.LAUNCHES = launches
        print(f"pipeline cold run (cache off) median of {LATENCY_REPS} after the first: "
              f"{statistics.median(colds[1:])!r} s (first {colds[0]!r} s); warm run median "
              f"{statistics.median(warms[1:])!r} s (first {warms[0]!r} s) [{smi}]")
        for sid, ts in sorted(stage_times.items()):
            nodes = list(cold.plan.stages[int(sid)].node_names)
            print(f"pipeline stage {sid} {nodes}: median exec_s "
                  f"{statistics.median(t['exec_s'] for t in ts[1:])!r} queue_s "
                  f"{statistics.median(t['queue_s'] for t in ts[1:])!r} commit_s "
                  f"{statistics.median(t['commit_s'] for t in ts[1:])!r} [{smi}]")
        scan_s = statistics.median(a for a, _ in spans[1:])
        exec_s = statistics.median(b for _, b in spans[1:])
        print(f"pipeline scan share: host shard reads {scan_s!r} s of {exec_s!r} s of stage "
              f"exec_s summed over stages ({scan_s / exec_s:.3f}); fused_filter_agg launches "
              f"in one run: {launches}; peak device memory over the cold runs {peak} B "
              f"({peak / 2**30:.2f} GiB) [{smi}]")
        profile_run(torch, runner, smi)
        ops.LAUNCHES = launches
    return launches


# -------------------------------------------------------------- phase 3c
#: the Appendix pipeline plus zone_riders as a user writes it for the SDK:
#: a file of decorator registrations, discovered by ``Client.run(path)``
PIPELINE_FILE = """\
import repro_torch

PROJECT = repro_torch.project({project!r})

repro_torch.sql(
    "trips",
    "SELECT pickup_location_id, passenger_count as count, dropoff_location_id "
    "FROM taxi_table WHERE pickup_at >= '2019-04-01'",
    project=PROJECT,
)


@repro_torch.expectation(project=PROJECT)
def trips_expectation(ctx, trips):
    return trips.mean("count") > {threshold!r}


repro_torch.sql(
    "pickups",
    "SELECT pickup_location_id, dropoff_location_id, COUNT(*) AS counts "
    "FROM trips GROUP BY pickup_location_id, dropoff_location_id "
    "ORDER BY counts DESC",
    project=PROJECT,
)
repro_torch.sql("zone_riders", {zone_riders!r}, project=PROJECT)
"""


def write_pipeline_file(directory, name, threshold):
    path = directory / f"{name}.py"
    path.write_text(PIPELINE_FILE.format(project=name, threshold=threshold, zone_riders=Q1))
    return path


def cli_process(args, smi):
    """``python -m repro_torch.cli`` as a user runs it, on the card (its
    default device): (stdout, seconds)."""
    import os

    argv = [sys.executable, "-m", "repro_torch.cli"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(argv + [str(a) for a in args], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"cli {args[2:4]} exited {proc.returncode}: {proc.stderr.strip()[-2000:]}")
    print(f"client cli {' '.join(str(a) for a in args[2:3])}: exit 0 in {wall!r} s [{smi}]")
    return proc.stdout, wall


def client_path(np, torch, ops, data, tmp, smi, runner_walls):
    """The SDK and the CLI over a fresh 2^23-row lake: ``Client.query`` and
    ``Client.explain``, a branch run of a discovered pipeline file, compact
    and gc, a failing audit, two async runs at once, the latency history
    in a second Client, the run's trace, and the CLI as six processes,
    all on the card (the default device).  Returns fused_filter_agg's launches in
    the Client's main path (this process only)."""
    import contextlib
    import io

    import repro_torch
    from repro_torch.cli import _print_table
    from repro_torch.examples_data import APRIL_1, TAXI_SCHEMA
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    oracles = {"Q1": oracle_q1(data, APRIL_1, np), "Q2": oracle_q2(data, APRIL_1, np),
               "Q3": oracle_q3(data, APRIL_1, np)}
    queries = (("Q1", Q1, "auto", "kernel"), ("Q2", Q2, "kernel", "kernel"),
               ("Q3", Q3, "auto", "jnp"))
    root = tmp / "client_lake"
    files = tmp / "client_pipelines"
    files.mkdir()
    good = write_pipeline_file(files, "taxi_sdk", 10.0)
    failing = write_pipeline_file(files, "taxi_sdk_failing", 1000.0)

    client = repro_torch.Client(root, shard_rows=65536)
    check(client.device.type == "cuda", f"client on {client.device}")
    t0 = time.perf_counter()
    client.write_table("taxi_table", data, schema=TAXI_SCHEMA)
    print(f"client lake: {len(data['pickup_at'])} rows written by Client.write_table in "
          f"{time.perf_counter() - t0!r} s")
    sub = client.events(follow=True, buffer=1 << 20)

    # the main path: every launch count starts at 0 here
    ops.LAUNCHES = flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0

    # 1. queries, and explain's verdicts against the runtime routes
    answers = {}
    for name, sql, engine, path in queries:
        out = answers[name] = client.query(sql, engine=engine)
        ran = [e for e in sub.drain() if type(e).__name__ == "QueryExecuted"][-1].engine_path
        check(same_bytes(out, oracles[name]), f"client {name} differs from the numpy oracle")
        verdict = client.explain(sql, engine=engine).engine_path
        check(ran == path and verdict == ran,
              f"client {name}: explain says {verdict}, the query ran {ran}, want {path}")
    q2_auto = client.explain(Q2).engine_path
    print("client queries: Q1-Q3 equal the numpy oracle; explain's verdicts equal the runtime "
          f"routes (kernel, kernel, jnp); Q2 at engine=auto explains as {q2_auto}")
    launches = ops.LAUNCHES
    for name, sql, engine, _ in queries:
        facade, direct = [], []
        for _ in range(LATENCY_REPS):
            t0 = time.perf_counter()
            client.query(sql, engine=engine)
            facade.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            client.runner.query(sql, engine=engine)
            direct.append(time.perf_counter() - t0)
        walls = [e.wall_s for e in sub.drain() if type(e).__name__ == "QueryExecuted"]
        print(f"client {name} engine={engine} median of {LATENCY_REPS}: Client.query "
              f"{statistics.median(facade)!r} s, its Runner.query on the same lake "
              f"{statistics.median(direct)!r} s, overhead "
              f"{statistics.median(facade) - statistics.median(direct)!r} s; QueryExecuted "
              f"wall_s {statistics.median(walls)!r} s; phase 3 Runner.query wall_s "
              f"{runner_walls[name]!r} s [{smi}]")
    ops.LAUNCHES = launches  # timing launches are not main-path launches

    # 2. the branch run of the discovered file, then a warm re-run
    t0 = time.perf_counter()
    with client.branch("feat") as b:
        cold = b.run(good)
    cold_s = time.perf_counter() - t0
    check(cold.state is repro_torch.RunState.SUCCESS, f"branch run {cold.state}: {cold.error}")
    check("feat" not in client.branches(), "the branch did not merge and close")
    check(client.tables()["pickups"] == cold.artifacts["pickups"], "pickups not on main")
    check(same_bytes(cold.artifact("pickups"), oracles["Q3"]), "pickups differs from the oracle")
    check(same_bytes(cold.artifact("zone_riders"), oracles["Q1"]),
          "zone_riders differs from the oracle")
    routes = {n: r.engine_path for s in cold.plan.stages for n, r in s.sql_routes.items()}
    check(routes.get("zone_riders") == "kernel", f"zone_riders routed {routes}")
    t0 = time.perf_counter()
    with client.branch("feat_warm") as b:
        warm = b.run(good)
    warm_s = time.perf_counter() - t0
    check(warm.cache["nodes_executed"] == 0, f"warm run executed {warm.cache['nodes_executed']}")
    check(warm.artifacts == cold.artifacts, "warm run artifacts differ")
    print(f"client branch run: {cold.state} merged, {cold.cache['nodes_executed']} nodes "
          f"executed, routes {routes}; cold {cold_s!r} s (run wall_s {cold.stats['wall_s']!r}), "
          f"warm {warm_s!r} s (0 executed, {warm.cache['hits']} hits) [{smi}]")

    # 3. compaction (16 shards to 1) and gc; queries give the same bytes
    t0 = time.perf_counter()
    (compacted,) = client.compact("taxi_table", target_rows=1 << 20)
    compact_s = time.perf_counter() - t0
    check(compacted.shards_merged > 0, f"compact merged {compacted.shards_merged} shards")
    with client.branch("after_compact") as b:
        after = b.run(good)
    check(after.cache["nodes_executed"] == 0,
          f"warm run after compact executed {after.cache['nodes_executed']}")
    t0 = time.perf_counter()
    swept = client.gc(history=1, grace_s=0.0)
    gc_s = time.perf_counter() - t0
    check(swept.swept_objects > 0, "gc reclaimed nothing after the compaction")
    for name, sql, engine, _ in queries:
        check(same_bytes(client.query(sql, engine=engine), oracles[name]),
              f"client {name} differs after compact and gc")
    print(f"client maintenance: {compacted.describe()} in {compact_s!r} s; warm run after it "
          f"executed 0 nodes; {swept.describe()} in {gc_s!r} s; Q1-Q3 unchanged [{smi}]")

    # 4. a failing audit is a handle and leaves nothing behind
    head = client.catalog.head("main").commit_id
    bad = client.run(failing)
    check(bad.state is repro_torch.RunState.AUDIT_FAILED, f"failing audit ended {bad.state}")
    check(client.catalog.head("main").commit_id == head, "the failing audit moved main")
    check(not [b for b in client.branches() if b.startswith("run_")],
          "the failing audit left a run_* branch")
    print(f"client failing audit: {bad.state}, failed checks {bad.failed_checks}, no branch "
          f"left")

    # 5. two async runs on different branches at once, each launching
    before = ops.LAUNCHES
    t0 = time.perf_counter()
    with client.branch("left") as left, client.branch("right") as right:
        handles = [left.run_async(good, cache=False), right.run_async(good, cache=False)]
        results = [h.result(timeout=600) for h in handles]
    async_s = time.perf_counter() - t0
    launched = ops.LAUNCHES - before
    for r in results:
        check(r.state is repro_torch.RunState.SUCCESS, f"async run {r.state}: {r.error}")
        check(r.artifacts == cold.artifacts, "an async run's artifacts differ")
    check({"left", "right"}.isdisjoint(client.branches()), "an async branch did not merge")
    check(launched >= 2, f"two async runs launched fused_filter_agg {launched} times")
    print(f"client async: two runs merged in {async_s!r} s, fused_filter_agg launches "
          f"{launched} [{smi}]")
    launches = ops.LAUNCHES
    check(launches > 0, "the Client never launched fused_filter_agg")
    check(flash_ops.LAUNCHES == decode_ops.LAUNCHES == 0, "the Client launched attention")

    # 6. the run's trace: run -> stage -> node spans and a critical path
    trace = client.trace(cold.run_id)
    kinds = {s.kind for s in trace.root.walk()}
    check(trace.root.kind == "run" and {"queue", "exec", "node"} <= kinds,
          f"trace span kinds {sorted(kinds)}")
    cp = trace.critical_path()
    check(bool(cp), "the trace has no critical path")
    phases = {s.name: s.dur for s in trace.root.walk() if s.kind == "phase"}
    print(f"client trace of run {cold.run_id}: {len(trace.root.walk())} spans, kinds "
          f"{sorted(kinds)}, critical path {cp}, coverage {trace.coverage()!r}, phases "
          f"{phases!r}, stage exec_s "
          f"{ {sid: sp['exec'].dur for sid, sp in trace.stage_spans.items()}!r}")
    sub.close()
    client.close()

    # 7. a second Client on the lake estimates from the persisted history
    with repro_torch.Client(root) as second:
        lat = second.run(good, branch="latency", cache=False)
    sources = {s["source"] for s in lat.stats["scheduler"]["stages"].values()}
    check(lat.state is repro_torch.RunState.SUCCESS and sources == {"latency"},
          f"second client: {lat.state}, cost sources {sources}")
    print(f"client latency history: a second Client's scheduler estimated from {sources}")
    ops.LAUNCHES = launches  # the second Client is not the main path

    # 8. the CLI, one process per verb: the readers and the run at once,
    # then the maintenance verbs, which read what the run wrote
    lake = ["--lake", root]
    explained = tmp / "explain_q2.json"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        query, run, traced, _ = [f.result()[0] for f in [pool.submit(cli_process, lake + args, smi) for args in (
            ["query", "-q", Q1], ["run", good, "-b", "cli"], ["trace", cold.run_id],
            ["explain", "-q", Q2, "--json", explained])]]
    with ThreadPoolExecutor(2) as pool:
        swept, stats = [f.result()[0] for f in [pool.submit(cli_process, lake + args, smi) for args in (
            ["gc", "--dry-run"], ["cache", "stats"])]]
    print(f"client cli: six processes in {time.perf_counter() - t0!r} s [{smi}]")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _print_table(answers["Q1"])
    check(query == buf.getvalue(), "the CLI's Q1 differs from client.query's")
    check("merged to 'cli'" in run and run.split()[:2] == ["run", str(int(run.split()[1]))],
          f"cli run: {run}")
    check(f"run {cold.run_id}" in traced and "critical path" in traced, f"cli trace: {traced}")
    verdict = json.loads(explained.read_text())["engine_path"]
    check(verdict == q2_auto, f"cli explain says {verdict}, Client.explain said {q2_auto}")
    check("would reclaim" in swept, f"cli gc: {swept}")
    check("entries" in stats, f"cli cache stats: {stats}")
    print(f"client phase: fused_filter_agg launches on the Client's main path {launches}")
    return launches


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
    # the kernel's time against the rows: its first 2048 rows (one block),
    # a quarter, all, and the rows four times over
    by_rows = {}
    for rows in (2048, n // 4, n, 4 * n):
        k, v, f = (t[:rows] if rows <= n else t.repeat(rows // n) for t in (keys, vals, filt))
        by_rows[rows] = time_ms(torch, lambda: ops.fused_filter_agg(k, v, f, **kw), flush)[0]
    print(f"fused_filter_agg device ms against rows: {by_rows!r}")
    ops.LAUNCHES = before  # timing launches are not main-path launches
    nbytes = n * (4 + 4 + 4) + 2 * G * 4
    bytes_ms = nbytes / memory_rate(card) * 1e3
    ops_ms = 3 * n / FP32_RATE * 1e3  # compare, add, count per row
    row = {
        "name": "fused_filter_agg",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fused_filter_agg/csrc/fused_filter_agg.cu",
        "replaces": "src/repro/kernels/fused_filter_agg/kernel.py:81",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "wrapper_ms": wrapper_ms,
        "n": n,
        "num_groups": G,
        "ms_by_rows": by_rows,
    }
    return row


# --------------------------------------------------------------- phase 5
def close_enough(torch, got, want) -> bool:
    """float32: within 1e-5 + 1e-5 |want| (sums in another order);
    bfloat16: within one bf16 ulp of the larger magnitude (both versions
    compute in float32 and round once) plus the same 1e-5 floor, since
    near 0 an ulp is smaller than the float32 sums' own difference.  The
    rule of float32 flash and of decode in both types."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool((diff <= 1e-5 + ulp).all())


def flash_yardstick(q, k, v, *, causal, window):
    """The reference's own bf16 route at the same inputs: the port's copy
    of the JAX package's ``_sdpa_chunked`` with one chunk of S keys (q *
    scale and p rounded to bf16, float32 sums), rounded to q's dtype."""
    from repro_torch.models.attention import _sdpa_chunked

    return _sdpa_chunked(q, k, v, causal=causal, window=window,
                         chunk=q.shape[2]).to(q.dtype)


def flash_bf16_close(torch, got, want, yard):
    """The bf16 flash rule.  The kernel runs both products on the tensor
    cores with bf16 operands (p rounded to bf16), so it cannot match the
    float32 plain version to one ulp.  It passes when its largest and its
    mean |kernel - plain| are each at most twice those of ``yard`` (the
    reference's chunked bf16 route, ``flash_yardstick``) against the same
    plain version, plus 1e-5: FlashAttention's own test rule, with the JAX
    package's own bf16 route as the yardstick.  Returns (ok, (kernel max,
    kernel mean, route max, route mean))."""
    e = (got.float() - want.float()).abs()
    ey = (yard.float() - want.float()).abs()
    stats = (float(e.max()), float(e.mean()), float(ey.max()), float(ey.mean()))
    ok = stats[0] <= 2 * stats[2] + 1e-5 and stats[1] <= 2 * stats[3] + 1e-5
    return ok, stats


def mask_probe(torch, s, *, window, h=32, hkv=4, d=128, dtype, generator):
    """q, k, v at which a masked key that leaks moves the output by whole
    units.  Every q row points along one unit vector u (scores q.k * scale
    = k's component along u); probe keys at tile edges (0, 63, 64, 127,
    128, 129, ...) are alpha_j u with v = +-64, alternating, and every
    other key is small noise.  Without a window alpha grows with the
    probe's position, so a row's output is the sign of its latest visible
    probe, and a key past the diagonal that leaks flips it; with a window
    alpha falls with the position, so the output is the sign of the oldest
    probe inside the window, and a key just outside that leaks flips it."""
    dev = generator.device

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=dev)

    u = randn(d)
    u = u / u.norm()
    q = u * d ** 0.5 + 0.05 * randn(1, h, s, d)
    k = 0.5 * randn(1, hkv, s, d)
    v = randn(1, hkv, s, d)
    edges = {0, 1, 63, 64, 127, 128, 129, 255, 256, 257, s // 2, s - 129, s - 128, s - 1}
    probes = sorted(p for p in edges if 0 <= p < s)
    n = len(probes)
    for j, p in enumerate(probes):
        alpha = 12.0 + 6.0 * (j if window is None else n - 1 - j)
        k[:, :, p] = alpha * u
        v[:, :, p] = 64.0 * (-1) ** j
    return q.to(dtype), k.to(dtype), v.to(dtype)


def attention_vs_plain(torch, flash_ops, flash_ref, decode_ops, decode_ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def one(kind, name, kernel, plain, yard=None):
        """One case; its largest |kernel - plain| counts under (kind,
        dtype).  yard: the bf16 flash rule's yardstick, else close_enough."""
        nonlocal n
        out, out2 = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain()
        check(torch.equal(out, out2), f"{name}: two launches differ")
        check(out.dtype == want.dtype and out.shape == want.shape, f"{name}: dtype/shape")
        check(bool(torch.isfinite(out).all()), f"{name}: not finite")
        diff = float((out.float() - want.float()).abs().max())
        if yard is None:
            check(close_enough(torch, out, want), f"{name}: kernel vs plain max |diff| {diff!r}")
        else:
            ok, stats = flash_bf16_close(torch, out, want, yard())
            check(ok, f"{name}: kernel vs plain (max, mean) {stats[:2]!r} exceed twice "
                      f"the chunked route's {stats[2:]!r} + 1e-5")
            key = ("flash chunked route", out.dtype)
            worst[key] = max(worst.get(key, 0.0), stats[2])
        worst[(kind, out.dtype)] = max(worst.get((kind, out.dtype), 0.0), diff)
        n += 1

    worst = {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            for h, hkv in ((32, 4), (48, 1)):
                for s in (1024, 4096):
                    q = randn(b, h, 128, dtype=dtype)
                    k, v = randn(b, hkv, s, 128, dtype=dtype), randn(b, hkv, s, 128, dtype=dtype)
                    _, chunk = decode_ops.split_plan(s, b * hkv, sms)
                    edges = [chunk - 1, chunk, chunk + 1]
                    sets = ([[1, s - 1, s, 0], [*edges, s]] if b == 4
                            else [[1], [s - 1], [s], [0]] + [[x] for x in edges])
                    for lens in sets:
                        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                        one("decode", f"decode {dtype} B={b} H={h}/{hkv} S={s} chunk={chunk} "
                            f"lengths={lens}",
                            lambda: decode_ops.decode_attention(q, k, v, lengths),
                            lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
        bf16 = dtype == torch.bfloat16
        for s in (512, 2048, 200):
            q = randn(1, 32, s, 128, dtype=dtype)
            k, v = randn(1, 4, s, 128, dtype=dtype), randn(1, 4, s, 128, dtype=dtype)
            for causal, window in FLASH_MASKS:
                kw = dict(causal=causal, window=window)
                one("flash", f"flash {dtype} S={s} {kw}",
                    lambda: flash_ops.flash_attention(q, k, v, **kw),
                    lambda: flash_ref.attention_ref(q, k, v, **kw),
                    (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
        # head dims 32 and 64 run flash_fwd in both dtypes (float32 sums)
        for d in (32, 64):
            q = randn(1, 32, 512, d, dtype=dtype)
            k, v = randn(1, 4, 512, d, dtype=dtype), randn(1, 4, 512, d, dtype=dtype)
            for window in (None, 256):
                kw = dict(causal=True, window=window)
                one("flash D<128", f"flash {dtype} D={d} S=512 {kw}",
                    lambda: flash_ops.flash_attention(q, k, v, **kw),
                    lambda: flash_ref.attention_ref(q, k, v, **kw))
        for s in (512, 2048):
            for window in (None, 256):
                q, k, v = mask_probe(torch, s, window=window, dtype=dtype, generator=gen)
                kw = dict(causal=True, window=window)
                one("flash probe", f"flash mask probe {dtype} S={s} {kw}",
                    lambda: flash_ops.flash_attention(q, k, v, **kw),
                    lambda: flash_ref.attention_ref(q, k, v, **kw),
                    (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
        # head dims 80 (qwen3-32b, 64/8 heads) and 120 (h2o-danube-3-4b,
        # 32/8): decode on its padded width under the one-ulp rule; bf16
        # flash on flash_wgmma under the bf16 flash rule, float32 flash on
        # flash_fwd under 1e-5
        for d, h, hkv in ((80, 64, 8), (120, 32, 8)):
            s = 4096
            q = randn(4, h, d, dtype=dtype)
            k, v = randn(4, hkv, s, d, dtype=dtype), randn(4, hkv, s, d, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4 * hkv, sms)
            for lens in ([1, s - 1, s, 0], [chunk - 1, chunk, chunk + 1, s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode D=80/120", f"decode {dtype} D={d} B=4 H={h}/{hkv} S={s} chunk={chunk} "
                    f"lengths={lens}",
                    lambda: decode_ops.decode_attention(q, k, v, lengths),
                    lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
            # and at the ragged S = 200 (one tile of 128 rows and one of
            # 72) with a window that masks inside both tiles
            for s, cases in ((512, FLASH_MASKS), (200, FLASH_MASKS + ((True, 64),))):
                q = randn(1, h, s, d, dtype=dtype)
                k, v = randn(1, hkv, s, d, dtype=dtype), randn(1, hkv, s, d, dtype=dtype)
                for causal, window in cases:
                    kw = dict(causal=causal, window=window)
                    one("flash D=80/120", f"flash {dtype} D={d} H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
            for s in (512, 2048):
                for window in (None, 256):
                    q, k, v = mask_probe(torch, s, window=window, h=h, hkv=hkv, d=d,
                                         dtype=dtype, generator=gen)
                    kw = dict(causal=True, window=window)
                    one("flash probe D=80/120", f"flash mask probe {dtype} D={d} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
        # phase 6e's head layouts: MHA (group 1) at 24/24 (D = 64, flash_fwd
        # in bf16 too) and 16/16 (D = 128), GQA group 2 at 16/8 (D = 128)
        for h, hkv, d in FAMILY_LAYOUTS:
            s = 4096
            q = randn(4, h, d, dtype=dtype)
            k, v = randn(4, hkv, s, d, dtype=dtype), randn(4, hkv, s, d, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4 * hkv, sms)
            for lens in ([1, s - 1, s, 0], [chunk - 1, chunk, chunk + 1, s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode families", f"decode {dtype} D={d} B=4 H={h}/{hkv} S={s} "
                    f"chunk={chunk} lengths={lens}",
                    lambda: decode_ops.decode_attention(q, k, v, lengths),
                    lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
            wgmma = flash_ops.kernel_name(dtype, d) == "flash_wgmma"
            for s in ((2048,) if d == 64 else (512, 2048)):
                q = randn(1, h, s, d, dtype=dtype)
                k, v = randn(1, hkv, s, d, dtype=dtype), randn(1, hkv, s, d, dtype=dtype)
                for causal in (True, False):
                    kw = dict(causal=causal, window=None)
                    one("flash families", f"flash {dtype} D={d} H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if wgmma else None)
            q, k, v = mask_probe(torch, 2048, window=None, h=h, hkv=hkv, d=d, dtype=dtype,
                                 generator=gen)
            kw = dict(causal=True, window=None)
            one("flash probe families", f"flash mask probe {dtype} D={d} H={h}/{hkv} S=2048",
                lambda: flash_ops.flash_attention(q, k, v, **kw),
                lambda: flash_ref.attention_ref(q, k, v, **kw),
                (lambda: flash_yardstick(q, k, v, **kw)) if wgmma else None)
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = before  # comparisons are not the main path
    print(f"attention kernels vs plain: {n} cases pass (decode in both dtypes and float32 "
          f"flash at every head dim within 1e-5 + 1e-5|plain| (bf16 decode: + one bf16 ulp); "
          f"bf16 flash at head dims 32/64 (flash_fwd) within 1e-5 + one bf16 ulp; bf16 flash at "
          f"head dims {'/'.join(map(str, flash_ops.WGMMA_HEAD_DIMS))} (flash_wgmma) within "
          f"twice the chunked route's max and mean + 1e-5; repeat launches bitwise equal); "
          f"max |kernel - plain|: "
          + ", ".join(f"{k} {str(dt).split('.')[-1]} {v!r}" for (k, dt), v in worst.items()))


# --------------------------------------------------------------- phase 6
def profile_decode(torch, model, lengths, max_len, what=""):
    """torch.profiler over PROFILE_STEPS decode steps of len(lengths)
    slots at the given lengths: wall time, device busy time (sum of kernel
    times) and the kernels that take most of it, per step.  Returns the
    device's busy share of the wall time (None when the profiler recorded
    no device time)."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    state = model.init_decode_state(len(lengths), max_len=max_len)
    k = model.cfg.n_codebooks
    toks = torch.zeros((len(lengths), 1, k) if k > 1 else (len(lengths), 1),
                       dtype=torch.int32, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for _ in range(2):
        model.decode_step(state, toks, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            model.decode_step(state, toks, lens)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / PROFILE_STEPS
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 / PROFILE_STEPS
    launches = sum(e.count for e in kernels) / PROFILE_STEPS
    if not kernels:
        print(f"{what}profile: decode step wall {wall!r} s; the profiler recorded no device "
              f"time (device busy share not measured)")
        return None
    print(f"{what}profile, kernel route decode step ({len(lengths)} slots, lengths "
          f"{[int(x) for x in lengths]}): wall {wall!r} s, device busy {busy!r} s "
          f"({busy / wall:.3f} of wall, idle {1 - busy / wall:.3f}), {launches} kernel "
          f"launches a step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / PROFILE_STEPS:.3f} ms/step "
              f"{e.count // PROFILE_STEPS}x {e.key[:90]}")
    return busy / wall


def profile_forward(torch, model, tokens, patches, what):
    """torch.profiler over one forward: wall time, device busy time (sum
    of kernel times) and the kernels that take most of it.  Returns the
    busy share of the wall time (None when no device time was recorded)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model(tokens, patch_embeds=patches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not kernels:
        print(f"{what}profile: forward wall {wall!r} s; the profiler recorded no device time "
              f"(device busy share not measured)")
        return None
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{what}profile, kernel route forward: wall {wall!r} s, device busy {busy!r} s "
          f"({busy / wall:.3f} of wall, idle {1 - busy / wall:.3f}), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:.3f} ms {e.count}x {e.key[:90]}")
    return busy / wall


def serve_requests(torch, m, p, scfg, prompts, new_tokens):
    """generate() on one request a prompt; per-step host times and each
    request's latency from the start, by wrapping two engine methods."""
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(m, p, scfg)  # the default device: cuda
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    steps, done_at = [], {}
    decode, step = engine._decode, engine.step

    def timed_decode(*args):
        t = time.perf_counter()
        out = decode(*args)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        return out

    def tracked_step(live, rng):
        step(live, rng)
        for r in live:
            if r.done:
                done_at.setdefault(id(r), time.perf_counter())

    engine._decode, engine.step = timed_decode, tracked_step
    reqs = [Request(prompt=pr, max_new_tokens=new_tokens) for pr in prompts]
    t = time.perf_counter()
    engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return engine, reqs, steps, [done_at[id(r)] - t for r in reqs], wall


def padded_sequences(np, torch, reqs):
    """Each request's prompt and generated tokens as rows of one (n, T)
    int32 tensor on the card, and the (n, T) mask of real positions."""
    seqs = [np.concatenate([r.prompt, np.array(r.generated, np.int32)]) for r in reqs]
    n, T = len(seqs), max(len(x) for x in seqs)
    toks = np.zeros((n, T), np.int32)
    for i, x in enumerate(seqs):
        toks[i, :len(x)] = x
    valid = np.arange(T)[None, :] < np.array([len(x) for x in seqs])[:, None]
    return (torch.tensor(toks, device="cuda"), torch.tensor(valid, device="cuda"), seqs)


def teacher_forced(torch, m, toks, max_len, rows=None):
    """Decode logits (float32) of every position of ``toks`` ((n, T), or
    (n, T, K) with codebooks), fed one column a step to ``rows`` rows at
    once (all n when None); (n, T, V) or (n, T, K, V)."""
    n, T = toks.shape[:2]
    rows = rows or n
    parts = []
    for r0 in range(0, n, rows):
        chunk = toks[r0:r0 + rows]
        state = m.init_decode_state(chunk.shape[0], max_len=max_len)
        out = None
        for t in range(T):
            lengths = torch.full((chunk.shape[0],), t, dtype=torch.int32, device=toks.device)
            logits, state = m.decode_step(state, chunk[:, t:t + 1], lengths)
            if out is None:
                out = torch.empty((chunk.shape[0], T, *logits.shape[2:]), dtype=torch.float32,
                                  device=toks.device)
            out[:, t] = logits[:, 0].float()
        parts.append(out)
        del state
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def check_logits(torch, what, got, want, tol=LOGIT_TOL, mean_tol=LOGIT_MEAN_TOL):
    """The kernel route against the reference route: the largest |diff|
    within ``tol``, the mean within ``mean_tol``."""
    diff = (got - want).abs()
    print(f"{what} kernel vs reference: max |diff| {float(diff.max())!r}, "
          f"mean {float(diff.mean())!r} (limits {tol}, {mean_tol}); "
          f"max |logit| {float(want.abs().max())!r}")
    check(float(diff.max()) <= tol and float(diff.mean()) <= mean_tol,
          f"{what} logits: kernel vs reference route")


def yi_requests(np, torch, vocab):
    """Phase 6's requests, from SEED: N_REQUESTS prompts of 8 to 32
    tokens, and one FORWARD_LEN-token prompt on the card."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, int(rng.integers(8, 33))).astype(np.int32)
               for _ in range(N_REQUESTS)]
    long_prompt = torch.tensor(rng.integers(0, vocab, (1, FORWARD_LEN)).astype(np.int32),
                               device="cuda")
    return prompts, long_prompt


def serve_yi(np, torch, flash_ops, decode_ops):
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    base = get_config("yi-6b")
    kcfg = dataclasses.replace(base, use_flash_kernel=True)
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(kcfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"yi-6b: {n_params} parameters, {base.n_layers} layers, d_model {base.d_model}, "
          f"{base.n_heads}/{base.n_kv_heads} heads, init on the card in "
          f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated()} B held, "
          f"init peak {torch.cuda.max_memory_allocated()} B")
    torch.cuda.reset_peak_memory_stats()
    prompts, long_prompt = yi_requests(np, torch, base.vocab)
    return serve_both_routes(np, torch, flash_ops, decode_ops, model, prompts, long_prompt,
                             what="", profile=True)


def serve_both_routes(np, torch, flash_ops, decode_ops, model, prompts, long_prompt, *, what,
                      profile):
    """Serve ``model`` (``use_flash_kernel=True``) on its kernel route,
    then the same weights on the reference route, and hold the two to
    each other (phase 6's checks and limits).  The launch counts start at
    0 just before the kernel route's requests: decode_attention must
    launch n_layers times a decode step, flash_attention n_layers times
    in one forward.  ``what`` prefixes the printed lines; ``profile``
    adds a profile of PROFILE_STEPS decode steps."""
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig

    cfg = model.cfg
    dev = torch.device("cuda")
    params = model.state_dict()
    scfg = ServeConfig(max_batch=4, max_len=4096)

    def serve(m, p):
        return serve_requests(torch, m, p, scfg, prompts, NEW_TOKENS)

    def forward(m):
        t = time.perf_counter()
        logits = m(long_prompt)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t

    def report(route, reqs, steps, latency, wall, fwd_s):
        toks = sum(len(r.generated) for r in reqs)
        print(f"{what}serve {route}: {len(reqs)} requests, {len(steps)} decode steps, {toks} "
              f"tokens in {wall!r} s ({toks / wall!r} tokens/s); decode step median "
              f"{statistics.median(steps)!r} s (min {min(steps)!r}, max {max(steps)!r}); "
              f"forward of {FORWARD_LEN} tokens {fwd_s!r} s")
        print(f"{what}serve {route}: per-request latency from submission (s): {latency!r}")

    # the main path: the counts start at 0 here
    flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
    engine, reqs_k, steps_k, lat_k, wall_k = serve(model, None)
    decode_launches = decode_ops.LAUNCHES
    check(decode_launches == cfg.n_layers * len(steps_k),
          f"{what}decode_attention launched {decode_launches} times in {len(steps_k)} steps")
    check(flash_ops.LAUNCHES == 0, f"{what}generate launched flash_attention")
    final_lengths = engine.lengths.copy()
    del engine
    logits_k, fwd_k = forward(model)
    flash_launches = flash_ops.LAUNCHES
    check(flash_launches == cfg.n_layers,
          f"{what}flash_attention launched {flash_launches} times")
    check(decode_ops.LAUNCHES == decode_launches, f"{what}forward launched decode_attention")
    print(f"{what}main path: decode_attention launches {decode_launches} "
          f"({cfg.n_layers} x {len(steps_k)} steps), flash_attention launches {flash_launches}")
    _, fwd_k2 = forward(model)
    if profile:
        profile_decode(torch, model, final_lengths, scfg.max_len)
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = flash_launches, decode_launches
    report("kernel route", reqs_k, steps_k, lat_k, wall_k, fwd_k)
    print(f"{what}serve kernel route: second forward {fwd_k2!r} s; final slot lengths "
          f"{final_lengths.tolist()}")

    # the reference route, on the same weights (assigned, not copied)
    ref_model = LM(dataclasses.replace(cfg, use_flash_kernel=False))
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    engine, reqs_r, steps_r, lat_r, wall_r = serve(ref_model, params)
    del engine
    logits_r, fwd_r = forward(ref_model)
    check((flash_ops.LAUNCHES, decode_ops.LAUNCHES) == counts,
          f"{what}the reference route launched a kernel")
    report("reference route", reqs_r, steps_r, lat_r, wall_r, fwd_r)
    peak = torch.cuda.max_memory_allocated()
    print(f"{what}serve: peak device memory after init {peak} B ({peak / 2**30:.2f} GiB)")

    # forward: flash vs the chunked reference (2048 > chunk 1024)
    shape = (1, FORWARD_LEN, cfg.vocab)
    for name, lg in (("kernel", logits_k), ("reference", logits_r)):
        check(tuple(lg.shape) == shape and bool(torch.isfinite(lg.float()).all()),
              f"{what}{name} forward logits {tuple(lg.shape)} not finite of shape {shape}")
    check_logits(torch, f"{what}forward", logits_k.float(), logits_r.float())
    del logits_k, logits_r

    # decode: both routes teacher-forced on the kernel route's sequences
    toks, valid, seqs = padded_sequences(np, torch, reqs_k)
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    tf_k = teacher_forced(torch, model, toks, scfg.max_len)
    tf_r = teacher_forced(torch, ref_model, toks, scfg.max_len)
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts  # a comparison, not the main path
    check(bool(torch.isfinite(tf_k[valid]).all() and torch.isfinite(tf_r[valid]).all()),
          f"{what}teacher-forced logits not finite")
    check_logits(torch, f"{what}decode, teacher-forced on {int(valid.sum())} positions,",
                 tf_k[valid], tf_r[valid])

    # greedy tokens: equal up to each request's first near tie
    same = 0
    for i, (rk, rr) in enumerate(zip(reqs_k, reqs_r)):
        p_len = len(rk.prompt)
        for j, (a, b) in enumerate(zip(rk.generated, rr.generated)):
            if a != b:
                top2 = torch.topk(tf_r[i, p_len + j - 1], 2).values
                margin = float(top2[0] - top2[1])
                print(f"{what}request {i}: routes part at new token {j} ({a} vs {b}), "
                      f"reference top-2 margin {margin!r}")
                check(margin <= LOGIT_TOL, f"{what}request {i}: tokens differ at margin {margin}")
                break
            same += 1
    print(f"{what}greedy tokens: {same} of {sum(len(r.generated) for r in reqs_k)} equal "
          f"between the routes before any near tie")

    # the repo's own check: decode logits equal forward logits (kernel route)
    x = seqs[0]
    full = model(torch.tensor(x[None], device=dev))[0].float()
    cdiff = float((full - tf_k[0, :len(x)]).abs().max())
    flash_ops.LAUNCHES = flash_launches
    print(f"{what}kernel route decode vs forward on request 0 ({len(x)} tokens): max |diff| "
          f"{cdiff!r}")
    check(cdiff <= LOGIT_TOL, f"{what}decode logits differ from forward logits")
    return {"decode_launches": decode_launches, "flash_launches": flash_launches,
            "final_lengths": final_lengths, "decode_step_s": statistics.median(steps_k),
            "latency_s": lat_k}


# -------------------------------------------------------------- phase 6b
def serve_cut(np, torch, flash_ops, decode_ops, arch):
    """``arch`` (h2o-danube-3-4b: head dim 120, window 4096; qwen3-32b:
    head dim 80, qk-norm) at full width — d_model, every head, d_ff and
    the full vocabulary as published — but CUT_LAYERS layers, with random
    weights from a seeded generator.  Depth is cut so that the two routes
    (and two models) fit the card at once and the decode comparison stays
    short: every layer calls the kernels at the same shapes.  Phase 6c
    runs the kernel route at full depth.

    CUT_REQUESTS requests of CUT_NEW_TOKENS new tokens through
    ``ServeEngine`` on 4 slots of 4096 positions, then ``LM.forward`` on
    one FORWARD_LEN-token prompt, on the kernel route with the launch
    counts set to 0 just before: decode_attention must launch CUT_LAYERS
    times a decode step and flash_attention CUT_LAYERS times a forward.
    The reference route then serves the same weights, and the two agree
    on the forward logits and on the decode logits teacher-forced on the
    kernel route's sequences within LOGIT_TOL and LOGIT_MEAN_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig

    base = get_config(arch)
    cut = dataclasses.replace(base, n_layers=CUT_LAYERS,
                              segments=((base.segments[0][0], CUT_LAYERS),))
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = LM(dataclasses.replace(cut, use_flash_kernel=True)).init(
        torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    print(f"{arch}: d_model {cut.d_model}, {cut.n_heads}/{cut.n_kv_heads} heads of "
          f"{cut.head_dim}, d_ff {cut.d_ff}, vocab {cut.vocab}, window {cut.window}, "
          f"{cut.n_layers} of {base.n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters())} parameters, init in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cut.vocab, int(rng.integers(8, 33))).astype(np.int32)
               for _ in range(CUT_REQUESTS)]
    prompt = torch.tensor(rng.integers(0, cut.vocab, (1, FORWARD_LEN)).astype(np.int32),
                          device=dev)
    scfg = ServeConfig(max_batch=4, max_len=4096)

    # the main path of this config: the counts start at 0 here
    flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
    engine, reqs_k, steps, _, wall = serve_requests(torch, model, None, scfg, prompts,
                                                    CUT_NEW_TOKENS)
    del engine
    check(decode_ops.LAUNCHES == CUT_LAYERS * len(steps),
          f"{arch}: decode_attention launched {decode_ops.LAUNCHES} times in "
          f"{len(steps)} steps")
    check(flash_ops.LAUNCHES == 0, f"{arch}: generate launched flash_attention")
    logits_k = model(prompt).float()
    torch.cuda.synchronize()
    check(flash_ops.LAUNCHES == CUT_LAYERS,
          f"{arch}: flash_attention launched {flash_ops.LAUNCHES} times in one forward")
    launches = {"decode_launches": decode_ops.LAUNCHES, "flash_launches": flash_ops.LAUNCHES,
                "decode_steps": len(steps)}
    print(f"{arch} main path: decode_attention launches {launches['decode_launches']} "
          f"({CUT_LAYERS} x {len(steps)} steps), flash_attention launches "
          f"{launches['flash_launches']}; {sum(len(r.generated) for r in reqs_k)} tokens in "
          f"{wall!r} s, decode step median {statistics.median(steps)!r} s")

    ref_model = LM(dataclasses.replace(cut, use_flash_kernel=False))
    ref_model.load_state_dict(model.state_dict(), assign=True)
    logits_r = ref_model(prompt).float()
    toks, valid, _ = padded_sequences(np, torch, reqs_k)
    tf_k = teacher_forced(torch, model, toks, scfg.max_len)
    tf_r = teacher_forced(torch, ref_model, toks, scfg.max_len)
    torch.cuda.synchronize()
    for name, lg in (("kernel", logits_k), ("reference", logits_r)):
        check(tuple(lg.shape) == (1, FORWARD_LEN, cut.vocab) and bool(torch.isfinite(lg).all()),
              f"{arch}: {name} forward logits {tuple(lg.shape)} not finite or misshapen")
    check(bool(torch.isfinite(tf_k[valid]).all() and torch.isfinite(tf_r[valid]).all()),
          f"{arch}: teacher-forced logits not finite")
    check_logits(torch, f"{arch} forward", logits_k, logits_r)
    check_logits(torch, f"{arch} decode, teacher-forced on {int(valid.sum())} positions,",
                 tf_k[valid], tf_r[valid])
    return launches


# -------------------------------------------------------------- phase 6c
def forward_full(np, torch, flash_ops, arch, smi):
    """``arch`` at full width and full depth (h2o-danube-3-4b: 24 layers;
    qwen3-32b: 64, 30.5 B parameters, 61 GB of bf16 weights) on the kernel
    route, with random weights from a seeded generator: the init's time
    and peak device memory (``LM.init`` draws and casts one piece at a
    time, so the peak is the bf16 weights plus one piece in float32), then
    one FORWARD_LEN-token ``LM.forward`` with the flash launch count set to
    0 just before (it must grow by exactly n_layers, and the logits must be
    finite of shape (1, FORWARD_LEN, vocab)), then the forward's time
    (host clock, synchronised, median of FORWARD_REPS after one warm-up)
    and peak device memory.  No decode steps: the forward is what runs
    flash_attention.  The model is freed before the function returns."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch} full depth: {cfg.n_layers} layers, {n_params} parameters, {weights} B of "
          f"weights; init on the card in {init_s!r} s, init peak {init_peak} B "
          f"({init_peak / 2**30:.2f} GiB; weights + {(init_peak - weights) / 2**30:.2f} GiB) "
          f"[{smi}]")
    rng = np.random.default_rng(SEED)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, FORWARD_LEN)).astype(np.int32),
                          device=dev)
    torch.cuda.reset_peak_memory_stats()
    # the main path of this config: the count starts at 0 here
    flash_ops.LAUNCHES = 0
    logits = model(prompt)
    torch.cuda.synchronize()
    launches = flash_ops.LAUNCHES
    check(launches == cfg.n_layers,
          f"{arch}: flash_attention launched {launches} times in a {cfg.n_layers}-layer forward")
    check(tuple(logits.shape) == (1, FORWARD_LEN, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: forward logits {tuple(logits.shape)} not finite of shape "
          f"(1, {FORWARD_LEN}, {cfg.vocab})")
    del logits
    times = []
    for _ in range(FORWARD_REPS):
        t = time.perf_counter()
        model(prompt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    fwd_peak = torch.cuda.max_memory_allocated() - held
    flash_ops.LAUNCHES = launches  # the timed forwards are not the main path
    fwd_s = statistics.median(times)
    print(f"{arch} full depth: forward of {FORWARD_LEN} tokens, flash_attention launches "
          f"{launches} (= {cfg.n_layers} layers), logits finite of shape "
          f"(1, {FORWARD_LEN}, {cfg.vocab}); median of {FORWARD_REPS} after a warm-up "
          f"{fwd_s!r} s (each {times!r}); peak device memory {fwd_peak} B "
          f"({fwd_peak / 2**30:.2f} GiB) [{smi}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "flash_launches": launches, "init_s": init_s,
            "init_peak_bytes": init_peak, "forward_s": fwd_s, "forward_peak_bytes": fwd_peak}


# -------------------------------------------------------------- phase 6d
def synth_corpus(np, rng, n, vocab):
    """examples/train_lm.py's synthetic corpus: Zipf(1.3) token ids with a
    64-token phrase repeated at random places (something to learn)."""
    base = rng.zipf(1.3, n).clip(1, vocab - 1)
    phrase = rng.integers(1, vocab, 64)
    for start in range(0, n - 64, 997):
        if rng.random() < 0.3:
            base[start:start + 64] = phrase
    return base.astype(np.int32)


def instrument_loop(torch, loop, record, prof=None, prof_first=None):
    """Wrap a TrainLoop's step and checkpoint calls to record, in
    ``record``: each step's synchronised host time, each sync save's,
    async save's (the caller's wait: the copy to the host) and restore's
    seconds, and each checkpoint write's seconds (the async save's
    background part).  ``prof`` is started before step ``prof_first`` and
    stopped after TRAIN_PROFILE_STEPS steps."""
    step, ckpt = loop._train_step, loop.ckpt
    save, save_async, restore, write = ckpt.save, ckpt.save_async, ckpt.restore, ckpt._write

    def timed(name, fn, sync=True):
        def run(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            record.setdefault(name, []).append(time.perf_counter() - t)
            return out
        return run

    timed_step = timed("step_s", step)

    def profiled_step(*args):
        i = len(record.get("step_s", []))
        if prof is not None and i == prof_first:
            prof.start()
        out = timed_step(*args)
        if prof is not None and i == prof_first + TRAIN_PROFILE_STEPS - 1:
            prof.stop()
        return out

    loop._train_step = profiled_step
    ckpt.save, ckpt.save_async = timed("save_s", save), timed("async_save_s", save_async)
    # the write runs on the save's thread (the async save's in the background)
    ckpt.restore, ckpt._write = timed("restore_s", restore), timed("write_s", write, sync=False)


def train_serve(np, torch, flash_ops, decode_ops, smi):
    """Train -> commit -> check out -> serve: ``examples/train_lm.py`` and
    ``examples/serve_lm.py`` through the port, on the card, at full width.

    Config: Yi-6B (``configs/yi_6b.py``, arXiv:2403.04652) at full width —
    d_model 4096, 32/4 heads of 128, d_ff 11008, vocab 64000, untied head,
    remat "full", AdamW — with the depth cut to TRAIN_LAYERS layers
    (``n_layers`` and ``segments`` replaced): 1.216 B parameters, whose
    float32 masters, gradients and two moments take 19.5 GB.  At full
    depth AdamW's state alone is 16 B a parameter, 97 GB, more than the
    card; and each checkpoint (params, m, v in float32) is 14.6 GB to
    copy, hash and write, so 4 layers, not more.

    Data: a synthetic Zipf corpus of TRAIN_CORPUS tokens from SEED,
    written with ``write_token_table`` into a temporary lake; batches of
    TRAIN_BATCH x TRAIN_SEQ tokens drawn by step.  Training runs the
    reference attention (the flash kernel has no backward), under
    ``torch.use_deterministic_algorithms(True)``: the embedding's
    backward accumulates, and the restart check below is bitwise.

    Restart-exactness: run A trains TRAIN_STEPS steps uninterrupted and
    saves only its final checkpoint; run B "crashes" after CRASH_AT steps
    (an async save, then its final save); run C, a new ``TrainLoop``,
    resumes from B's checkpoint to TRAIN_STEPS.  Every leaf key of C's
    final manifest must equal A's (content addresses: equal keys, equal
    bytes; the store then holds the two once).  Audit: the loss finite
    and the mean of its last 5 steps below the first step's (and below
    ln(vocab), the loop's ``max_final_loss``); ``promote("main")``.

    Check-out: params alone restored from main on the host, the serving
    ``LM`` built with ``params_from_numpy`` on the card, then phase 6's
    requests and 2048-token forward on both routes under phase 6's
    checks and limits (``serve_both_routes``), the launch counts set to 0
    just before: decode_attention TRAIN_LAYERS a decode step,
    flash_attention TRAIN_LAYERS a forward."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.catalog import Catalog
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset, write_token_table
    from repro_torch.io import ObjectStore
    from repro_torch.models import LM, params_from_numpy
    from repro_torch.table import TableFormat
    from repro_torch.train import CheckpointManager, TrainLoop, TrainLoopConfig, TrainStepConfig
    from repro_torch.utils.tree import tree_param_count, tree_size_bytes

    t_phase = time.perf_counter()
    base = get_config("yi-6b")
    cfg = dataclasses.replace(base, n_layers=TRAIN_LAYERS,
                              segments=((base.segments[0][0], TRAIN_LAYERS),))
    check(cfg.remat == "full" and not cfg.tie_embeddings and not cfg.use_flash_kernel,
          "yi-6b's config: remat full, untied head, reference attention")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store = ObjectStore(Path(tmp) / "lake")
        catalog, fmt = Catalog(store), TableFormat(store)
        corpus = synth_corpus(np, np.random.default_rng(SEED), TRAIN_CORPUS, cfg.vocab)
        key = write_token_table(fmt, catalog, "corpus", corpus)
        ds = TokenDataset(fmt, key, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=SEED)
        step_cfg = TrainStepConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)

        def loop(branch, total, every):
            return TrainLoop(LM(cfg), ds, catalog, branch=branch, config=TrainLoopConfig(
                total_steps=total, checkpoint_every=every, log_every=TRAIN_STEPS,
                async_checkpoint=True, max_final_loss=float(np.log(cfg.vocab)), step=step_cfg))

        def leaf_keys(branch):
            art = f"models/{cfg.name}/checkpoint"
            return json.loads(store.get(catalog.table_key(art, branch=branch)))["leaves"]

        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            # run A: uninterrupted, only the final checkpoint
            rec_a = {}
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            run_a = loop("train_a", TRAIN_STEPS, every=10 ** 9)
            instrument_loop(torch, run_a, rec_a, prof, prof_first=TRAIN_PROFILE_FIRST)
            torch.cuda.reset_peak_memory_stats()
            out_a = run_a.run(init_key=SEED)
            peak = torch.cuda.max_memory_allocated()
            ckpt_bytes = tree_size_bytes((out_a["params"], out_a["state"]))
            n_params = tree_param_count(out_a["params"])
            losses_a = out_a["losses"]
            del out_a
            # run B crashes after CRASH_AT steps; run C resumes it
            rec_b, rec_c = {}, {}
            run_b = loop("train", CRASH_AT, every=CRASH_AT)
            instrument_loop(torch, run_b, rec_b)
            out_b = run_b.run(init_key=SEED)
            del out_b["params"], out_b["state"]
            run_c = loop("train", TRAIN_STEPS, every=10 ** 9)
            instrument_loop(torch, run_c, rec_c)
            out_c = run_c.run(init_key=SEED)
            del out_c["params"], out_c["state"]
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
        gc.collect()
        torch.cuda.empty_cache()

        # restart-exact: every leaf's content key of C's final manifest is A's
        keys_a, keys_c = leaf_keys("train_a"), leaf_keys("train")
        same = sum(keys_c.get(k) == v for k, v in keys_a.items())
        print(f"train: restart check: {same} of {len(keys_a)} leaf keys of the resumed run's "
              f"final manifest equal the uninterrupted run's (C ran {out_c['steps_run']} steps "
              f"from B's step {CRASH_AT})")
        check(out_c["steps_run"] == TRAIN_STEPS - CRASH_AT, "run C did not resume at CRASH_AT")
        check(keys_c == keys_a, "resumed run's checkpoint differs from the uninterrupted run's")
        check(out_b["losses"] + out_c["losses"] == losses_a,
              "the resumed run's losses differ from the uninterrupted run's")

        # audit and promote
        first, last5 = losses_a[0], float(np.mean(losses_a[-5:]))
        print(f"train: losses {losses_a!r}; first {first!r}, mean of the last 5 {last5!r} "
              f"(ln vocab {float(np.log(cfg.vocab))!r}); audit_ok {out_c['audit_ok']}")
        check(all(np.isfinite(losses_a)) and last5 < first, "the loss did not fall")
        check(out_c["audit_ok"], "the audit failed")
        run_c.promote("main")
        check(catalog.table_key(f"models/{cfg.name}/checkpoint", branch="main")
              == catalog.table_key(f"models/{cfg.name}/checkpoint", branch="train"),
              "promote did not bring the checkpoint to main")

        steps = rec_a["step_s"]
        timed_steps = [t for i, t in enumerate(steps) if i > 0 and not (
            TRAIN_PROFILE_FIRST <= i < TRAIN_PROFILE_FIRST + TRAIN_PROFILE_STEPS)]
        step_s = statistics.median(timed_steps)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"train: yi-6b at full width, {TRAIN_LAYERS} of {base.n_layers} layers, {n_params} "
              f"parameters, AdamW, remat full, batch {TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} "
              f"tokens a step [{smi}]")
        print(f"train: step time median {step_s!r} s over steps 2-{TRAIN_STEPS} less the "
              f"profiled ones (first step {steps[0]!r} s; all {steps!r}); {tokens / step_s!r} "
              f"tokens/s; peak device memory {peak} B ({peak / 2**30:.2f} GiB)")
        wall = sum(steps[TRAIN_PROFILE_FIRST:TRAIN_PROFILE_FIRST + TRAIN_PROFILE_STEPS])
        kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        if kernels:
            busy = sum(e.self_device_time_total for e in kernels) / 1e6
            print(f"train: profile of steps {TRAIN_PROFILE_FIRST + 1}-"
                  f"{TRAIN_PROFILE_FIRST + TRAIN_PROFILE_STEPS}: wall {wall!r} s, device busy "
                  f"{busy!r} s ({busy / wall:.3f} of wall, idle {1 - busy / wall:.3f}), "
                  f"{sum(e.count for e in kernels) / TRAIN_PROFILE_STEPS} kernel launches a step")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
                print(f"  {e.self_device_time_total / 1e3 / TRAIN_PROFILE_STEPS:.3f} ms/step "
                      f"{e.count // TRAIN_PROFILE_STEPS}x {e.key[:90]}")
        else:
            print(f"train: profile wall {wall!r} s; the profiler recorded no device time "
                  f"(device busy share not measured)")
        print(f"train: checkpoint of (params, state) {ckpt_bytes} B "
              f"({len(keys_a)} leaves): A's final save {rec_a['save_s']!r} s; B's async save "
              f"{rec_b['async_save_s']!r} s to return (host copy), its write "
              f"{rec_b['write_s'][0]!r} s in the background, then its final save "
              f"{rec_b['save_s']!r} s (the same blobs); C's restore {rec_c['restore_s']!r} s, "
              f"its final save {rec_c['save_s']!r} s (deduplicated onto A's blobs)")

        # check the model out of main and serve it on the kernels
        t = time.perf_counter()
        mgr = CheckpointManager(catalog, prefix=f"models/{cfg.name}")
        (params,), at_step = mgr.restore((LM(cfg).init_params(None),), branch="main",
                                         device="cpu")
        restore_s = time.perf_counter() - t
        check(at_step == TRAIN_STEPS, f"checked out step {at_step}")
        t = time.perf_counter()
        model = params_from_numpy(params, dataclasses.replace(cfg, use_flash_kernel=True))
        torch.cuda.synchronize()
        print(f"check-out: params of step {at_step} restored from main to the host in "
              f"{restore_s!r} s ({tree_size_bytes(params)} B), the serving LM built on the card "
              f"in {time.perf_counter() - t!r} s")
        del params
    prompts, long_prompt = yi_requests(np, torch, cfg.vocab)
    served = serve_both_routes(np, torch, flash_ops, decode_ops, model, prompts, long_prompt,
                               what="trained yi-6b: ", profile=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"train -> serve phase: {seconds!r} s [{smi}]")
    return {**served, "step_s": step_s, "tokens_per_s": tokens / step_s, "peak_bytes": peak,
            "checkpoint_bytes": ckpt_bytes, "phase_s": seconds}


# -------------------------------------------------------------- phase 6e
def family_limits(max_logit):
    """Phase 6's limits in its own terms for logits whose largest
    magnitude is ``max_logit``: 8 bf16 ulps of it (the max) and one ulp
    (the mean).  Logits in [4, 8), as Yi-6B's 5.5 and these random-weight
    configs' (about 5-6, from N(0, 1) logits over 1e7-3e8 draws), give
    LOGIT_TOL and LOGIT_MEAN_TOL themselves."""
    ulp = 2.0 ** (math.floor(math.log2(max_logit)) - 7)
    return 8 * ulp, ulp


class RouterRecord:
    """While active, wraps the port's ``moe.route`` and
    ``moe.dispatch_plan`` (``moe_apply`` looks both up at each call) and
    keeps, for every MoE call in order, its float32 router logits (B, S,
    E), its top-k expert ids and the mask of the experts each token was
    dispatched to (its top-k less what capacity dropped).  With ``force``
    (another run's records, call for call), each call's top-k expert ids
    are that run's and the probs this call's own, renormalised, so both
    runs dispatch every token alike.  Comparison only: nothing here is on
    a path the script counts launches of."""

    def __init__(self, torch, moe, force=None):
        self.torch, self.moe, self.force = torch, moe, force
        self.calls = []

    def __enter__(self):
        torch, moe = self.torch, self.moe
        route, plan = moe.route, moe.dispatch_plan
        forced = None if self.force is None else iter(self.force)

        def recorded_route(p, cfg, x):
            logits, probs, top_p, top_e = route(p, cfg, x)
            if forced is not None:
                top_e = next(forced)["top_e"]
                top_p = torch.gather(probs, -1, top_e)
                if cfg.norm_topk:
                    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
            self.calls.append({"logits": logits.detach().clone(), "top_e": top_e})
            return logits, probs, top_p, top_e

        def recorded_plan(top_e, num_experts, cap):
            keep, buf_pos = plan(top_e, num_experts, cap)
            b, s, k = top_e.shape
            mask = torch.zeros((b, s, num_experts), dtype=torch.bool, device=top_e.device)
            self.calls[-1]["dispatched"] = mask.scatter_(-1, top_e, keep.reshape(b, s, k))
            return keep, buf_pos

        self._saved = route, plan
        moe.route, moe.dispatch_plan = recorded_route, recorded_plan
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch_plan = self._saved

    def by_position(self, layers, steps=None, rows=None):
        """(router logits, dispatched) as (positions, layers, E).  A
        forward's calls are one a layer over (1, S, E); a teacher-forced
        decode's are one a layer a step over each chunk of ``rows`` rows
        (the batch folded into one group), chunk after chunk: positions
        are then (row, step) in row order."""
        torch = self.torch
        out = []
        for key in ("logits", "dispatched"):
            xs = [c[key] for c in self.calls]
            if steps is None:  # (L, 1, S, E) -> (S, L, E)
                out.append(torch.stack(xs)[:, 0].transpose(0, 1))
                continue
            parts, per_chunk = [], steps * layers
            for c0 in range(0, len(xs), per_chunk):
                t = torch.stack(xs[c0:c0 + per_chunk])  # (T*L, 1, r, E)
                t = t[:, 0].reshape(steps, layers, t.shape[2], t.shape[3])
                parts.append(t.permute(2, 0, 1, 3))  # (r, T, L, E)
            out.append(torch.cat(parts).reshape(-1, layers, xs[0].shape[-1]))
        return out


def route_vs_route(torch, what, got, want, rec_k, rec_r, layers, steps=None, rows=None,
                   valid=None):
    """qwen2-moe's kernel route against its reference route, each routing
    by its own router (the rule written before the first run, phase 6e's
    docstring).  ``got``/``want``: logits (P..., V) over the same
    positions as the records; ``valid`` selects real positions.  Returns
    the (P,) mask of positions exempted from the max limit."""
    lk, dk = rec_k.by_position(layers, steps, rows)
    lr, dr = rec_r.by_position(layers, steps, rows)
    vocab = got.shape[-1]
    got, want = got.reshape(-1, vocab), want.reshape(-1, vocab)
    if valid is not None:
        keep = valid.reshape(-1)
        got, want, lk, dk, lr, dr = (x[keep] for x in (got, want, lk, dk, lr, dr))
    agree_layer = (dk == dr).all(-1)  # (P, L)
    agree = agree_layer.all(-1)
    first = torch.where(agree, layers, (~agree_layer).int().argmax(-1))
    upto = torch.arange(layers, device=got.device)[None, :] <= first[:, None]
    rdiff = (lk - lr).abs()[upto]
    rtol, rmean_tol = family_limits(float(lr.abs().max()))
    print(f"{what} router logits up to each position's first tipped layer: max |diff| "
          f"{float(rdiff.max())!r}, mean {float(rdiff.mean())!r} (limits {rtol}, {rmean_tol}); "
          f"max |router logit| {float(lr.abs().max())!r}")
    check(float(rdiff.max()) <= rtol and float(rdiff.mean()) <= rmean_tol,
          f"{what} router logits: kernel vs reference route")
    diff = (got - want).abs()
    tol, mean_tol = family_limits(float(want.abs().max()))
    n, exempt = int(agree.numel()), int((~agree).sum())
    print(f"{what} kernel vs reference, each route on its own router: {exempt} of {n} "
          f"positions ({exempt / n!r}) dispatched otherwise in at least one of {layers} layers "
          f"(exempted from the max limit); at the other {n - exempt}: max |diff| "
          f"{float(diff[agree].max())!r}, mean {float(diff[agree].mean())!r} (limits {tol}, "
          f"{mean_tol}); over all positions: max {float(diff.max())!r}, mean "
          f"{float(diff.mean())!r}; max |logit| {float(want.abs().max())!r}")
    check(exempt < n, f"{what}: every position tipped")
    check(float(diff[agree].max()) <= tol and float(diff[agree].mean()) <= mean_tol,
          f"{what} logits at positions dispatched alike: kernel vs reference route")
    return ~agree


def family_inputs(np, torch, cfg):
    """Phase 6e's inputs, from SEED: the forward's batch (``make_batch``:
    FORWARD_LEN positions, a VLM's patches among them), the requests'
    prompts (single-codebook configs), and the codebook config's
    teacher-forced tokens."""
    from repro_torch.configs.shapes import make_batch

    rng = np.random.default_rng(SEED)
    batch = make_batch(cfg, batch=1, seq=FORWARD_LEN - cfg.num_patches, rng=rng)
    if cfg.n_codebooks > 1:
        forced = torch.tensor(rng.integers(0, cfg.vocab, (CODEBOOK_ROWS, CODEBOOK_STEPS,
                                                          cfg.n_codebooks)).astype(np.int32),
                              device="cuda")
        return batch, None, forced
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(8, 33))).astype(np.int32)
               for _ in range(N_REQUESTS)]
    return batch, prompts, None


def serve_family(np, torch, flash_ops, decode_ops, moe_mod, arch, smi):
    """One config of phase 6e at full width and depth; see
    ``serve_families``."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig, ServeEngine

    t_arch = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    moe = cfg.num_experts > 0
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kernel = flash_ops.kernel_name(cfg.compute_dtype, cfg.head_dim)
    print(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim} ({kernel}), vocab {cfg.vocab}, experts {cfg.num_experts} "
          f"top {cfg.top_k} + {cfg.num_shared_experts} shared, patches {cfg.num_patches}, "
          f"codebooks {cfg.n_codebooks}; {n_params} parameters, {weights} B of weights; init "
          f"on the card in {init_s!r} s, init peak {init_peak} B ({init_peak / 2**30:.2f} GiB; "
          f"weights + {(init_peak - weights) / 2**30:.2f} GiB) [{smi}]")
    batch, prompts, forced_toks = family_inputs(np, torch, cfg)
    tokens, patches = batch["tokens"], batch.get("patch_embeds")
    scfg = ServeConfig(max_batch=4, max_len=4096)
    text = cfg.vocab

    # the main path of this config: the counts start at 0 here
    flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
    if cfg.n_codebooks == 1:
        engine, reqs_k, steps, lat_k, wall = serve_requests(torch, model, None, scfg, prompts,
                                                            NEW_TOKENS)
        final_lengths = engine.lengths.copy()
        del engine
        n_tokens = sum(len(r.generated) for r in reqs_k)
    else:
        try:
            ServeEngine(model, None, scfg)
        except NotImplementedError as e:
            print(f"{arch}: ServeEngine refuses it, as the JAX engine does: {e}")
        else:
            check(False, f"{arch}: ServeEngine served a codebook LM")
        steps = []
        state = model.init_decode_state(CODEBOOK_ROWS, max_len=scfg.max_len)
        tf_k = torch.empty((CODEBOOK_ROWS, CODEBOOK_STEPS, cfg.n_codebooks, cfg.vocab),
                           dtype=torch.float32, device=dev)
        for t in range(CODEBOOK_STEPS):
            lengths = torch.full((CODEBOOK_ROWS,), t, dtype=torch.int32, device=dev)
            t1 = time.perf_counter()
            logits, state = model.decode_step(state, forced_toks[:, t:t + 1], lengths)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t1)
            tf_k[:, t] = logits[:, 0].float()
        del state, logits
        final_lengths = np.full((CODEBOOK_ROWS,), CODEBOOK_STEPS, np.int32)
        wall, n_tokens = sum(steps), CODEBOOK_ROWS * CODEBOOK_STEPS
    decode_launches = decode_ops.LAUNCHES
    check(decode_launches == cfg.n_layers * len(steps),
          f"{arch}: decode_attention launched {decode_launches} times in {len(steps)} steps")
    check(flash_ops.LAUNCHES == 0, f"{arch}: the decode steps launched flash_attention")
    rec_k = RouterRecord(torch, moe_mod) if moe else contextlib.nullcontext()
    with rec_k:
        logits_k = model(tokens, patch_embeds=patches)
        torch.cuda.synchronize()
    flash_launches = flash_ops.LAUNCHES
    check(flash_launches == cfg.n_layers,
          f"{arch}: flash_attention launched {flash_launches} times in one forward")
    check(decode_ops.LAUNCHES == decode_launches, f"{arch}: the forward launched decode_attention")
    shape = (1, tokens.shape[1], *((cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()), cfg.vocab)
    check(tuple(logits_k.shape) == shape and bool(torch.isfinite(logits_k.float()).all()),
          f"{arch}: forward logits {tuple(logits_k.shape)} not finite of shape {shape}")
    print(f"{arch} main path: decode_attention launches {decode_launches} ({cfg.n_layers} x "
          f"{len(steps)} steps), flash_attention launches {flash_launches} (one forward of "
          f"{FORWARD_LEN} positions{', ' + str(cfg.num_patches) + ' of them patches' if patches is not None else ''})")
    if moe:
        sent = sum(int(c["dispatched"].sum()) for c in rec_k.calls)
        routed = len(rec_k.calls) * tokens.shape[1] * cfg.top_k
        from repro_torch.models.moe import capacity

        print(f"{arch}: the forward drops {routed - sent} of {routed} routed assignments at "
              f"capacity ({(routed - sent) / routed!r}; {capacity(cfg.moe_config(), FORWARD_LEN)} "
              f"slots an expert for a mean of {FORWARD_LEN * cfg.top_k / cfg.num_experts!r})")

    # timing: forwards (median of FORWARD_REPS after a warm-up), a profile
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(FORWARD_REPS + 1):
        t1 = time.perf_counter()
        model(tokens, patch_embeds=patches)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t1)
    fwd_peak = torch.cuda.max_memory_allocated() - held
    fwd_s = statistics.median(times)
    fwd_busy = profile_forward(torch, model, tokens, patches, what=f"{arch} ")
    busy = profile_decode(torch, model, final_lengths, scfg.max_len, what=f"{arch} ")
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = flash_launches, decode_launches
    step_s = statistics.median(steps)
    print(f"{arch}: forward of {FORWARD_LEN} positions median of {FORWARD_REPS} after a warm-up "
          f"{fwd_s!r} s (each {times!r}), peak device memory {fwd_peak} B "
          f"({fwd_peak / 2**30:.2f} GiB); decode step median {step_s!r} s over {len(steps)} "
          f"steps, {n_tokens / wall!r} {'tokens' if cfg.n_codebooks == 1 else 'frames (4 codebook tokens each)'}/s; "
          f"busy share over {PROFILE_STEPS} profiled steps {busy!r} [{smi}]")

    # the reference route, on the same weights (assigned, not copied)
    ref_model = LM(dataclasses.replace(cfg, use_flash_kernel=False))
    ref_model.load_state_dict(model.state_dict(), assign=True)
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    rec_r = RouterRecord(torch, moe_mod) if moe else contextlib.nullcontext()
    with rec_r:
        logits_r = ref_model(tokens, patch_embeds=patches)
    if cfg.n_codebooks == 1:
        engine, reqs_r, steps_r, _, wall_r = serve_requests(torch, ref_model, None, scfg,
                                                            prompts, NEW_TOKENS)
        del engine
        print(f"{arch} reference route: decode step median {statistics.median(steps_r)!r} s, "
              f"{sum(len(r.generated) for r in reqs_r) / wall_r!r} tokens/s")
    check((flash_ops.LAUNCHES, decode_ops.LAUNCHES) == counts,
          f"{arch}: the reference route launched a kernel")

    if moe:
        # each route on its own router, then the reference on the kernel
        # route's dispatch
        route_vs_route(torch, f"{arch} forward", logits_k[0].float(), logits_r[0].float(),
                       rec_k, rec_r, cfg.n_layers)
        with RouterRecord(torch, moe_mod, force=rec_k.calls):
            logits_f = ref_model(tokens, patch_embeds=patches)
        check_logits(torch, f"{arch} forward, the reference on the kernel route's dispatch,",
                     logits_k.float(), logits_f.float(),
                     *family_limits(float(logits_f.float().abs().max())))
        del logits_f
    else:
        check_logits(torch, f"{arch} forward" + (" (with the patch prefix)" if patches is not None else ""),
                     logits_k.float(), logits_r.float(),
                     *family_limits(float(logits_r.float().abs().max())))
    del logits_k, logits_r

    exempt_rows = None
    if cfg.n_codebooks == 1:
        toks, valid, seqs = padded_sequences(np, torch, reqs_k)
        counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
        what = f"{arch} decode, teacher-forced on {int(valid.sum())} positions,"
        if moe:  # chunks of the engine's 4 slots: the same capacity as the serve's steps
            with RouterRecord(torch, moe_mod) as tk:
                tf_k = teacher_forced(torch, model, toks, scfg.max_len, rows=scfg.max_batch)
            with RouterRecord(torch, moe_mod) as tr:
                tf_r = teacher_forced(torch, ref_model, toks, scfg.max_len, rows=scfg.max_batch)
            exempt = route_vs_route(torch, what, tf_k, tf_r, tk, tr, cfg.n_layers,
                                    steps=toks.shape[1], rows=scfg.max_batch, valid=valid)
            exempt_rows = torch.zeros(valid.shape, dtype=torch.bool, device=dev)
            exempt_rows[valid] = exempt
            with RouterRecord(torch, moe_mod, force=tk.calls):
                tf_f = teacher_forced(torch, ref_model, toks, scfg.max_len, rows=scfg.max_batch)
            check_logits(torch, f"{what} the reference on the kernel route's dispatch,",
                         tf_k[valid], tf_f[valid], *family_limits(float(tf_f[valid].abs().max())))
            del tf_f
        else:
            tf_k = teacher_forced(torch, model, toks, scfg.max_len)
            tf_r = teacher_forced(torch, ref_model, toks, scfg.max_len)
            check_logits(torch, what, tf_k[valid], tf_r[valid],
                         *family_limits(float(tf_r[valid].abs().max())))
        flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts  # a comparison, not the main path
        tol = family_limits(float(tf_r[valid].abs().max()))[0]
        same = 0
        for i, (rk, rr) in enumerate(zip(reqs_k, reqs_r)):
            p_len = len(rk.prompt)
            for j, (a, b) in enumerate(zip(rk.generated, rr.generated)):
                if a != b:
                    pos = p_len + j - 1
                    top2 = torch.topk(tf_r[i, pos], 2).values
                    margin = float(top2[0] - top2[1])
                    tipped = exempt_rows is not None and bool(exempt_rows[i, :pos + 1].any())
                    print(f"{arch} request {i}: routes part at new token {j} ({a} vs {b}), "
                          f"reference top-2 margin {margin!r}"
                          + (", a router tipped at or before it" if tipped else ""))
                    check(margin <= tol or tipped,
                          f"{arch} request {i}: tokens differ at margin {margin}")
                    break
                same += 1
        print(f"{arch} greedy tokens: {same} of {sum(len(r.generated) for r in reqs_k)} equal "
              f"between the routes before any near tie" + (" or tipped router" if moe else ""))
        if not moe:  # the repo's own check: decode equals forward (kernel route)
            x = seqs[0]
            full = model(torch.tensor(x[None], device=dev))[0].float()
            cdiff = float((full - tf_k[0, :len(x)]).abs().max())
            print(f"{arch} kernel route decode vs forward on request 0 ({len(x)} tokens): max "
                  f"|diff| {cdiff!r}")
            check(cdiff <= tol, f"{arch}: decode logits differ from forward logits")
        del tf_k, tf_r
    else:
        counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
        tf_r = teacher_forced(torch, ref_model, forced_toks, scfg.max_len)
        check(bool(torch.isfinite(tf_k).all() and torch.isfinite(tf_r).all()),
              f"{arch}: teacher-forced logits not finite")
        limits = family_limits(float(tf_r.abs().max()))
        check_logits(torch, f"{arch} decode, teacher-forced on {CODEBOOK_ROWS} x "
                     f"{CODEBOOK_STEPS} positions of {cfg.n_codebooks} codebooks,",
                     tf_k, tf_r, *limits)
        full = model(forced_toks).float()
        cdiff = float((full - tf_k).abs().max())
        print(f"{arch} kernel route decode vs forward on the {CODEBOOK_ROWS} x {CODEBOOK_STEPS} "
              f"teacher-forced positions: max |diff| {cdiff!r} (limit {limits[0]})")
        check(cdiff <= limits[0], f"{arch}: decode logits differ from forward logits")
        flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts  # a comparison, not the main path
        del tf_k, tf_r, full
    del model, ref_model
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_arch
    print(f"{arch}: {seconds!r} s [{smi}]")
    return {"decode_launches": decode_launches, "flash_launches": flash_launches,
            "decode_steps": len(steps), "n_layers": cfg.n_layers, "init_s": init_s,
            "init_peak_bytes": init_peak, "forward_s": fwd_s, "forward_peak_bytes": fwd_peak,
            "decode_step_s": step_s, "busy_share": busy, "forward_busy_share": fwd_busy,
            "seconds": seconds,
            "heads": (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)}


def serve_families(np, torch, flash_ops, decode_ops, smi):
    """Phase 6e: the MoE, vision-language and audio families
    (qwen2-moe-a2.7b, internvl2-2b, musicgen-medium) at full width and
    full depth on ``cuda``, one at a time, random weights from a seeded
    generator, TF32 off (phase 6 set it).  For each: the init's time and
    peak, then the main path with the launch counts set to 0 just before
    it —

    * qwen2-moe-a2.7b (24 ``moe_attn`` layers, 16/16 heads of 128 on
      ``flash_wgmma<128>``): ``ServeEngine.generate`` on N_REQUESTS
      requests of NEW_TOKENS over 4 slots of 4096, decode_attention 24
      launches a step; then one FORWARD_LEN-token ``LM.forward``,
      flash_attention 24 launches, and the share of routed assignments
      dropped at capacity (int(2048 * 4 / 60 * 1.25) = 170 slots an
      expert for a mean of 136.5);
    * internvl2-2b (24 layers, 16/8 heads of 128): the same requests,
      text only, as the JAX engine serves it; the forward on 256 seeded
      patch embeddings (bf16, ``make_batch``) and 1792 text tokens;
    * musicgen-medium (48 layers, 24/24 heads of 64 on ``flash_fwd`` in
      bf16): ``ServeEngine`` must raise NotImplementedError, as the JAX
      engine does; ``LM.decode_step`` teacher-forced over
      (CODEBOOK_ROWS, 1, 4) tokens for CODEBOOK_STEPS steps,
      decode_attention 48 launches a step; the forward on (1, 2048, 4)
      tokens, flash_attention 48 launches.

    Then the forward's time (median of FORWARD_REPS after a warm-up),
    peak and a profile of one forward, the median decode step, tokens/s
    and the busy share over PROFILE_STEPS profiled steps, all printed
    with the card's name and power limit, and the reference route on the
    same weights.

    Limits (written before the first run): phase 6's, in its terms
    (``family_limits``: 8 bf16 ulps of the largest |logit|, mean one
    ulp; the configs' random-weight logits reach about 5-6, where these
    are LOGIT_TOL and LOGIT_MEAN_TOL); greedy tokens equal up to the
    first near tie.  internvl2-2b and musicgen-medium: forward and
    teacher-forced decode logits of the two routes within them, and the
    kernel route's decode logits equal its forward logits within the max.

    qwen2-moe-a2.7b, two properties of the reference that are not the
    port's to assert: its decode and forward differ wherever the forward
    drops at capacity (the JAX package's own test leaves MoE out of
    decode-vs-forward), so the routes are compared forward with forward
    and decode with decode only; and a route's attention rounding tips
    near ties among the router's top 4.  By the reference's own numbers
    (Yi-6B's routes differ by a mean 0.016 in logits after 32 layers in
    phase 6 on an H100) the routes' router logits differ by about 0.005
    to 0.02, while a random 60-expert router's 4th and 5th logits are about
    0.18 apart, so an estimated 20-50 % of 2048 positions tip in at least
    one of 24 layers: a share limit of 1 % would fail on the reference's
    own arithmetic.  The rule, each comparison (forward; teacher-forced
    decode, in chunks of the engine's 4 slots so capacity is the serve's):
    (1) each route on its own router: the router logits within the limits
    (in the same terms) at every position up to and including the layer
    where its dispatch first differs (a fault in the kernels moves them by
    whole units from the first layer), the output logits within the max
    and the mean at every position whose dispatched experts agree in every
    layer, and the number of exempted positions printed; (2) the reference
    run again on the kernel route's dispatch (``RouterRecord(force=...)``):
    the output logits within the max and the mean at every position.
    Greedy tokens may part at a near tie or after a tipped router."""
    t_phase = time.perf_counter()
    from repro_torch.models import moe as moe_mod

    out = {arch: serve_family(np, torch, flash_ops, decode_ops, moe_mod, arch, smi)
           for arch in FAMILY_ARCHS}
    seconds = time.perf_counter() - t_phase
    print(f"families phase: {seconds!r} s [{smi}]")
    return out


# --------------------------------------------------------------- phase 7
def path_launches(served, trained, families, key):
    """A kernel row's launches: phase 6's serve and phase 6d's trained
    model (Yi-6B) and phase 6e's three configs, each path's count read
    just after it ran."""
    by_path = {"phase 6 serve (yi-6b, 32 layers)": served[key],
               "phase 6d train -> serve (yi-6b, 4 layers)": trained[key]}
    for arch, fam in families.items():
        by_path[f"phase 6e {arch} ({fam['n_layers']} layers)"] = fam[key]
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def measure_attention(torch, flash_ops, flash_ref, decode_ops, decode_ref, served, cut_served,
                      full_served, trained, families, card):
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rate = memory_rate(card)
    before = flash_ops.LAUNCHES, decode_ops.LAUNCHES

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def timed(kernel, plain, library, nbytes, flops, yard=None):
        out = kernel()
        want = plain()
        torch.cuda.synchronize()
        if yard is None:
            check(close_enough(torch, out, want), "kernel vs plain at the timed inputs")
        else:
            check(flash_bf16_close(torch, out, want, yard())[0],
                  "kernel vs plain at the timed inputs (bf16 flash rule)")
        ms, ahead = time_ms(torch, kernel, flush)
        check(ahead, "the host fell behind the card while queuing the kernel's launches")
        bytes_ms = nbytes / rate * 1e3
        ops_ms = flops / BF16_RATE * 1e3
        return {
            "max_abs_err": float((out.float() - want.float()).abs().max()),
            "ms": ms,
            "wrapper_ms": time_ms(torch, kernel, flush, queued=False)[0],
            "plain_ms": time_ms(torch, plain, flush)[0],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(torch, library, flush)[0],
        }

    def decode_case(h, hkv, d, lens, s=4096):
        b = len(lens)
        q, k, v = randn(b, h, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        rows = sum(min(int(x), s) if x > 0 else s for x in lens)  # rows the function reads
        return timed(
            lambda: decode_ops.decode_attention(q, k, v, lengths),
            lambda: decode_ref.decode_attention_ref(q, k, v, lengths),
            lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                                   enable_gqa=True),
            nbytes=rows * hkv * d * 2 * 2 + 2 * q.numel() * 2 + b * 4,
            flops=4 * rows * h * d,  # q.k and p.v per valid row, every q head
        )

    def flash_case(h, hkv, d, window=None, fs=FORWARD_LEN):
        """One fs-token prompt, causal; a window of fs or more masks
        nothing more, so SDPA's causal call computes the same function."""
        check(window is None or window >= fs, "flash timing takes no narrower window")
        fq, fk, fv = randn(1, h, fs, d), randn(1, hkv, fs, d), randn(1, hkv, fs, d)
        return timed(
            lambda: flash_ops.flash_attention(fq, fk, fv, causal=True, window=window),
            lambda: flash_ref.attention_ref(fq, fk, fv, causal=True, window=window),
            lambda: F.scaled_dot_product_attention(fq, fk, fv, is_causal=True, enable_gqa=True),
            nbytes=(2 * fq.numel() + fk.numel() + fv.numel()) * 2,
            flops=2 * h * fs * fs * d,  # q.k and p.v over the causal half
            yard=(lambda: flash_yardstick(fq, fk, fv, causal=True, window=window))
            if flash_ops.kernel_name(torch.bfloat16, d) == "flash_wgmma" else None,
        )

    # the main path's shapes: decode over 4 slots of 4096 positions, 32/4
    # heads; flash on one 2048-token prompt
    b, h, hkv, s, d = 4, 32, 4, 4096, 128
    final = [int(x) for x in served["final_lengths"]]
    dec = decode_case(h, hkv, d, final)
    dec_full = decode_case(h, hkv, d, [s] * b)
    fl = flash_case(h, hkv, d)
    # phase 6b's shapes, at full length
    flash_cut, decode_cut = {}, {}
    for arch, (ch, chkv, cd, window) in (("h2o-danube-3-4b", (32, 8, 120, 4096)),
                                         ("qwen3-32b", (64, 8, 80, None))):
        full = full_served[arch]
        flash_cut[arch] = {**flash_case(ch, chkv, cd, window),
                           "kernel": flash_ops.kernel_name(torch.bfloat16, cd),
                           "launches": cut_served[arch]["flash_launches"],
                           "full_depth_launches": full["flash_launches"],
                           "full_depth_forward_s": full["forward_s"],
                           "full_depth_layers": full["n_layers"],
                           "shape": f"B=1 H={ch} Hkv={chkv} S={FORWARD_LEN} D={cd} bf16 "
                                    f"causal window={window}"}
        decode_cut[arch] = {**decode_case(ch, chkv, cd, [s] * b),
                            "launches": cut_served[arch]["decode_launches"],
                            "shape": f"B={b} H={ch} Hkv={chkv} S={s} D={cd} bf16 full length"}
    # phase 6e's shapes: MHA 16/16 and GQA 16/8 at D = 128 (flash_wgmma),
    # MHA 24/24 at D = 64 (flash_fwd in bf16)
    for arch, (fh, fhkv, fd) in zip(FAMILY_ARCHS, FAMILY_LAYOUTS):
        fam = families[arch]
        path = f"phase 6e {arch} ({fam['n_layers']} layers)"
        flash_cut[arch] = {**flash_case(fh, fhkv, fd),
                           "kernel": flash_ops.kernel_name(torch.bfloat16, fd),
                           "launches": fam["flash_launches"],
                           "launches_by_path": {path: fam["flash_launches"]},
                           "full_depth_forward_s": fam["forward_s"],
                           "full_depth_layers": fam["n_layers"],
                           "shape": f"B=1 H={fh} Hkv={fhkv} S={FORWARD_LEN} D={fd} bf16 causal"}
        decode_cut[arch] = {**decode_case(fh, fhkv, fd, [s] * b),
                            "launches": fam["decode_launches"],
                            "launches_by_path": {path: fam["decode_launches"]},
                            "shape": f"B={b} H={fh} Hkv={fhkv} S={s} D={fd} bf16 full length"}
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = before  # timing is not the main path
    print("timing: kernels device-only (queued behind a sleep kernel); plain versions and "
          "SDPA queued the same way")
    rows = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
         **fl, **path_launches(served, trained, families, "flash_launches"),
         "kernel": flash_ops.kernel_name(torch.bfloat16, d),
         "shape": f"B=1 H={h} Hkv={hkv} S={FORWARD_LEN} D={d} bf16 causal",
         "by_config": flash_cut},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:85",
         **dec, **path_launches(served, trained, families, "decode_launches"),
         "shape": f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 lengths={final}",
         "at_full_length": dec_full, "by_config": decode_cut},
    ]
    return rows


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside the script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # cuBLAS's deterministic workspace, for phase 6d's deterministic training
    # (read when the first cuBLAS handle is made)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention import ref as decode_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.fused_filter_agg import ops, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    build_kernels((ops, flash_ops, decode_ops))
    kernel_vs_plain(torch, ops, ref)
    from repro_torch.examples_data import make_taxi_data

    data = make_taxi_data(N_MAIN, np.random.default_rng(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        catalog, fmt = write_lake(Path(tmp) / "lake", data)
        query_launches, inputs, walls = query_path(np, torch, ops, catalog, fmt, data)
        run_launches = pipeline_path(np, torch, ops, catalog, fmt, data, Path(tmp), smi)
        client_launches = client_path(np, torch, ops, data, Path(tmp), smi, walls)
    launches = {"Runner.query": query_launches, "Runner.run": run_launches,
                "Client": client_launches}
    ffa_row = measure(torch, ops, ref, launches, inputs, card)
    attention_vs_plain(torch, flash_ops, flash_ref, decode_ops, decode_ref)
    served = serve_yi(np, torch, flash_ops, decode_ops)
    cut_served = {arch: serve_cut(np, torch, flash_ops, decode_ops, arch) for arch in CUT_ARCHS}
    full_served = {arch: forward_full(np, torch, flash_ops, arch, smi) for arch in CUT_ARCHS}
    trained = train_serve(np, torch, flash_ops, decode_ops, smi)
    families = serve_families(np, torch, flash_ops, decode_ops, smi)
    rows = measure_attention(torch, flash_ops, flash_ref, decode_ops, decode_ref, served,
                             cut_served, full_served, trained, families, card)
    print(json.dumps({"kernels": [{**row, "card": smi} for row in (ffa_row, *rows)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
