#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) on any error:

1. print the card's name and power limit (``nvidia-smi``), then build the
   three CUDA kernels from ``src/`` (one nvcc each, all started together),
   print each build time and ptxas's report, one ``ptxas:`` line with
   every kernel's registers and spill bytes (each ``flash_tf32<f32, D>``
   and ``flash_wgmma<T, 32>`` / ``flash_wgmma_any<T, 32>`` instance among
   them), and count the wgmma (HGMMA) instructions and the TF32
   tensor-core instructions (HMMA or HGMMA with TF32: ``flash_tf32``'s
   mma.sync) in the flash library's SASS (there must be some of each),
   and each head-dim-32 kernel's HGMMA, waits and spills
   (``sass_counts``: it must have HGMMA and no LDL/STL);
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
   causal, with and without window 256, at head dim 32 (``flash_tf32`` in
   float32, ``flash_wgmma<bf16, 32>`` in bf16); at head dim 64, GQA 32/4
   and MHA 24/24
   (musicgen-medium), flash at S in {512, 2048, 200} causal, non-causal
   and window 256, at S = 200 with window 64, and mask probes at S in
   {512, 2048}; at head dims 80 (64/8 heads) and 120
   (32/8), decode at B = 4, S = 4096 with lengths 1, S-1, S, 0 and the
   chunk edges, flash at S in {512, 200} causal, non-causal and window
   256 and at S = 200 with window 64, and mask probes at S in {512,
   2048}; at phase 6e's head layouts (MHA 16/16 and GQA 16/8 at head dim
   128, MHA 24/24 at head dim 64), decode at B = 4, S = 4096 with lengths
   1, S-1, S, 0 and the chunk edges, flash at S in {512, 2048} causal
   and non-causal, and a mask probe at S = 2048; at head dim 64 in bf16,
   the scales -0.125 and 0 (``D64_SCALES``, which flash_wgmma<64> computes
   through the wrapper's ``positive_scale``) at 32/4 and 24/24, S = 512,
   causal, non-causal and window 256; at head dim 256 (recurrentgemma-9b,
   MQA 16/1, and GQA 16/4), flash at S in {512, 2048, 4096, 200} causal,
   non-causal and windows 2048 and 64, mask probes at S in {512, 2048},
   the scales -0.0625 and 0 at 16/1, S = 512, and decode at MQA groups 16
   and 64, B = 4, S = 4096 with lengths 1, S-1, S, 0 and the chunk edges,
   and B = 1 at lengths 0, 1, S and its own plan's chunk edges (groups
   above 8 in bf16 run ``decode_group``, whose chunk edges these are);
   decode at the other shapes ``decode_group`` takes (``WIDE_GROUP_CASES``:
   MQA 24/1 at head dim 128, 16/1 at 80, 120, 64 and 32), B = 4, S = 4096
   with lengths 1, S-1, S, 0 and the chunk edges;
   plus mask probes (``mask_probe``: keys past the
   diagonal or outside the window carry large scores and v = +-64, so a
   leak moves outputs by whole units) at S in {512, 2048}; float32 and
   bfloat16; then, drawn from a generator of their own (seed SEED + 1, so
   the cases above keep their inputs), head dim 32 (32/4) in both dtypes
   and ``flash_tf32`` at 256 (16/1) in float32 on what head dim 64 has: S
   in {512, 2048, 200}, causal, non-causal, window 256, window 64 at S =
   200, and mask probes at S in {512, 2048}; then (SEED + 6) bf16 and
   float16 at head dims D32_DIMS (``flash_wgmma<T, 32>`` and
   ``flash_wgmma_any<T, 32>``) at 32/4, 24/24 and 48/1 on the same S and
   masks, the scales D32_SCALES at S = 512 and mask probes, each (dtype,
   head dim)'s kernel read back from torch.profiler.  Decode and float32
   flash (``flash_tf32``: three TF32 products a pair) within 1e-5 + 1e-5
   |plain| (sums in another order); bfloat16 decode and 16-bit flash at
   head dims up to 32 (p.v with p as a hi + lo pair) within one ulp of the
   type (both round once from float32) plus that 1e-5; bf16 flash at head
   dims 64, 80, 120 and
   128 (``flash_wgmma``) by ``flash_bf16_close``: its largest and mean
   |kernel - plain| at most twice those of the reference's chunked bf16
   route (``flash_yardstick``) plus 1e-5, since the kernel's tensor-core
   products round p to bf16 as that route does.  The rule each (dtype,
   head dim) was held to is printed.  Two launches bitwise equal.  Where the
   chunked route's own error is exactly 0 (scale 0), the bf16 flash rule is
   one bf16 ulp plus 1e-5, the rule of the exact kernels.  Then
   (``domain_vs_plain``, a generator of its own, SEED + 2) the rest of the
   domain: float16 flash at every compiled width (``flash_wgmma``) at S in
   {512, 200}, causal, non-causal,
   window 256 and window 64 at S = 200, and mask probes at S = 512, under
   the float16 form of the bf16 flash rule (the chunked route in float16
   as the yardstick) or, at 32, one float16 ulp + 1e-5; float16 decode at
   32/4 and 48/1 (D = 128) and 16/1 (D = 256); head dims ODD_DIMS (1, 33,
   96, 100, 250, and from a generator of their own, SEED + 4, 150, 160,
   192, 200, 224, 90, 170, 210) in all three dtypes in both kernels (flash at S in {512,
   200}, and for bf16 and float16 rows that are not whole 16-byte pieces
   at S = 199 with q, k and v 1, 3 and 5 elements into their buffers;
   decode at 32/4 and 16/1, S = 1024), each (dtype, head dim)'s flash
   kernel read back from torch.profiler against the one the wrapper names;
   decode groups 71 and 128 (one
   block a slice of at most 64 heads) at D = 64 and 128 in all three
   dtypes, B = 4, S = 4096 at lengths 1, S-1, S, 0 and the chunk edges;
   ``fused_filter_agg`` at 1025, 4096, 65536 and 262144 groups over Q2's
   rows (its own keys and keys over [-1, G], its values and float ones):
   counts exact, sums within 1e-5 sum|v| of float64 (integer ones exact),
   repeat launches bitwise equal; and (a generator of their own, SEED + 3)
   head dims WIDE_DIMS (257 to 1024: ``flash_wgmma_wide`` in bf16 and
   float16, ``flash_tf32_wide`` in float32, and ``decode_wide``) in all
   three dtypes, flash at 32/4 and 16/1, S in {512, 200}, causal, non-causal, window 256 and window 64 at S = 200,
   decode at 32/4, 16/1 and 71/1, B = 4, S = 1024 (and 32/4 at S = 64,
   one chunk), lengths 1, S-1, S, 0 and the chunk edges, under float32's
   1e-5 + 1e-5 |plain| or one 16-bit ulp + 1e-5; then (SEED + 5)
   ``decode_wide`` at every geometry of its plan: head dims WIDE_DIMS and
   WIDE_ODD_DIM (16-bit rows that are not whole 16-byte pieces) at groups
   9, 16 and 71 (``WIDE_DECODE_GROUPS``), B = 4, S = 4096 (chunks of 512
   rows), lengths 0, 1, a k tile's edge +- 1, a v tile's edge + 1, the
   chunk's edge + 1, S - 1 and S, under the same rules, and each (dtype,
   head dim)'s decode kernel read back from torch.profiler against
   ``decode_wide`` (a profile with none fails);
6. serve Yi-6B at full width and depth on ``cuda`` (random weights from
   a seeded generator, TF32 off): ``ServeEngine.generate`` on 6 requests
   over 4 slots of 4096 positions, 16 new tokens each, through the
   kernels (``use_flash_kernel=True``), then ``LM.forward`` on one
   2048-token prompt.  The launch counts, set to 0 just before, must grow
   by 32 a decode step and 32 a forward, and the forward must rotate q and
   k once a layer on ``attention._rope``'s no-grad path (its
   ``ROPE_CALLS``, printed beside the launches).  The same requests and prompt
   then go through the reference route (``use_flash_kernel=False``), and
   the two routes must agree: teacher-forced decode logits and forward
   logits within LOGIT_TOL (largest) and LOGIT_MEAN_TOL (mean), the
   greedy tokens equal up to a request's first near tie (top-2 margin
   within LOGIT_TOL), and the kernel route's decode logits equal its
   forward logits within LOGIT_TOL.  Latencies, step times, tokens/s,
   peak memory and a profile of PROFILE_STEPS decode steps are printed;
6b. the same for h2o-danube-3-4b (head dim 120), qwen3-32b (head dim
   80) and granite-34b (MQA 48/1 at head dim 128: 88 layers, 93.9 GB of
   bf16 weights, do not fit the card) at full width and CUT_LAYERS layers
   (``serve_cut``): requests through ``ServeEngine`` and a forward on
   both routes, launch counts of CUT_LAYERS a step and a forward, logits
   within the same limits;
6c. danube and qwen3 at full width and full depth (24 and 64 layers,
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
6f. recurrentgemma-9b (``serve_recurrentgemma``) at full width and full
   depth (38 layers: 26 RG-LRU, 12 local attention at 16/1 x 256, window
   2048; 9.40 B parameters, nothing cut) on both routes: 4 requests of 16
   prompt and 32 new tokens through ``ServeEngine`` on one slot,
   decode_attention 12 launches a step, then a 4096-position
   ``LM.forward`` (where the window masks), flash_attention 12 launches;
   logits under phase 6's limits; init, forward, decode step, tokens/s,
   busy shares, launches a step and the phase's seconds printed;
6g. xlstm-350m at full width and depth (24 blocks, 429,245,440
   parameters, nothing cut) and deepseek-v3-671b at full width and 4 of
   61 layers (the 3 dense MLA layers and the first MoE one, 15.8 B
   parameters; ``serve_xlstm_deepseek``), one after the other: requests
   through ``ServeEngine`` (one slot for xlstm's recurrent state, 4 for
   deepseek's MLA cache) and a 2048-position ``LM.forward``, no attention
   kernel launched; xlstm's forward against the same model on the CPU and
   its decode against its forward; deepseek's absorbed MLA decode against
   its train path, the chunked MLA against the dense one, and its decode
   against its forward on a forward that dropped no assignment; init,
   forward, decode, launches and busy shares printed;
6h. Yi-6B in float32 through the kernels (``serve_yi_float32``): full
   width (32/4 x 128), CUT_LAYERS layers, ``compute_dtype=float32`` (TF32
   off for the GEMMs), phase 6's requests over 4 slots of 4096 positions
   and a FORWARD_LEN-token forward on both routes: launch counts of
   CUT_LAYERS a decode step (``decode_split<f32, 128>``) and a forward
   (``flash_tf32<f32, 128>``), logits within LOGIT_TOL / 100 and
   LOGIT_MEAN_TOL / 100 of the reference route's (both compute in
   float32), greedy tokens equal up to the first near tie, decode logits
   equal to forward logits within LOGIT_TOL / 100; the forward's busy
   share and flash_tf32's device ms from a profile printed;
6i. Yi-6B in float16 through the kernels (``serve_yi_float16``): full
   width (32/4 x 128) and F16_LAYERS (32) layers, ``compute_dtype=float16``,
   phase 6's requests and forward on both routes: launch counts of
   F16_LAYERS a decode step (``decode_split<f16, 128>``) and a forward
   (``flash_wgmma<f16, 128>``), logits within LOGIT_TOL and LOGIT_MEAN_TOL,
   greedy tokens equal up to the first near tie, decode vs forward within
   LOGIT_TOL;
7. time the two attention kernels at the main path's shapes like phase 4,
   and at phase 6b's, 6e's and 6f's shapes (recurrentgemma-9b's flash at
   S = 4096 with its window, where SDPA takes the window as a boolean
   mask, and at S = 2048; its decode at the serve's lengths and at full
   length; the backend SDPA ran is named), and in float32
   (``FLOAT32_ARCHS``: flash on one 2048-token causal prompt and decode at
   full length at the heads of Yi-6B, danube, qwen3, musicgen and
   recurrentgemma, B = 1 for the last; Yi's decode also at phase 6h's
   lengths) and flash at head dim 32 (``D32_HEADS``) in float32 and bf16,
   and (drawn last) float16 at 32 and bf16 at 16 (``D32_TIMED``)
   (float32 flash bounds count three TF32 products a pair at TF32_FLOPS,
   and a line before the ``kernels`` line gives the CUDA cores' ceiling,
   one float32 product a pair at FP32_FLOPS, computed, and another the
   floor the exponentials put under each 16-bit row up to 32, one a
   visible pair and q head at EX2_RATE, computed; float32 decode
   bounds count 4-byte elements at the memory rate; the float32 and
   head-dim-32 rows add SDPA on k and v expanded to the q heads,
   ``library_expanded_ms``, since ``enable_gqa`` sends float32 to SDPA's
   ``MATH`` backend); then print one
   ``{"kernels": [...]}`` line for all three kernels, each row with the
   card and its power limit and each flash row with the kernel that ran
   (``flash_wgmma`` or ``flash_tf32``) and, for the configs, phase 6c's,
   6e's or 6f's forward time; each config's decode row with its kernel
   (``decode_split`` or ``decode_group``), plan, partial and cache bytes,
   and each config row with its kernel's ptxas registers and spills (phase
   1's report); the rows count the launches of phases 6, 6d, 6e, 6f and
   6h, path by path (float32 shapes that no path runs: 0); float16 flash and
   decode at Yi-6B's shapes (phase 6i's launches), Phi-3-mini's flash (MHA
   32/32 x 96, ``flash_wgmma_any<bf16, 96>``) and Falcon-7B's decode (MQA 71/1
   x 64, two slices) with no path (0), flash at head dim 33 in bf16 (rows
   read as they are, no padded copy) and at 32/4 x 160 in bf16
   (``flash_wgmma_any<bf16, 160>``), and
   flash at 16/1 and 32/4 x 512 (S = 2048, causal) in bf16 and float32
   and at 16/1 x 512 in float16, and decode at B = 4, 32/4 x 512 (S =
   4096, full length) in bf16, float32 and float16 and at 16/1 x 576 and
   32/4 x 515 (``decode_wide_narrow``) in bf16 (the wide kernels; no path;
   each with SDPA on k and v expanded to the q heads beside), and
   ``fused_filter_agg`` at 1025, 4096, 65536 and 262144 groups over Q2's
   rows (``many_groups``: the partition, bin and
   merge launches; no path).  Lines before it give phase 6e's
   musicgen-medium and phase 6f's recurrentgemma-9b forward time and the
   forward profile's flash time, and the script's seconds;
8. the planner and the example editions (``planner_and_examples``,
   under PLANNER_PHASE_S seconds): (a) ``repro_torch.launch.dryrun``'s
   ``lower_cell`` for every arch x shape on the abstract 16 x 16 mesh (on
   meta tensors, in PLAN_WORKERS processes), none failing beyond
   ``shape_applicable``'s skips, and the roofline table printed; (b) phase
   6's Yi-6B parameters placed by ``DEFAULT_RULES`` as DTensors on a 1 x 1
   ``make_host_mesh()`` (NCCL), each ``to_local()`` bitwise equal to its
   parameter, the group torn down; (c) the roofline on a 1 x 1 mesh of
   phase 6's decode step and phase 6c's forwards (kernel route), each
   bound at most the time the card measured, the planner's serving
   weights equal to phase 6c's and its init peak within
   INIT_PEAK_SHARE of the measured one; (d) the five
   ``examples/torch_*.py`` run as processes at their default device
   (started first, beside (a)-(c)), each exiting 0.

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

#: device memory rate by card, bytes/s (NVIDIA data sheets); the H100
#: SXM's, and its float32, TF32 and bf16 rates, are the roofline's
#: (``repro_torch.launch.roofline``: HBM_BW, FP32_FLOPS, TF32_FLOPS,
#: PEAK_FLOPS)
MEMORY_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}

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
#: phase 6b: h2o-danube-3-4b, qwen3-32b and granite-34b (MQA 48/1; its
#: 93.9 GB of bf16 weights do not fit the card) at full width, depth cut
CUT_ARCHS = ("h2o-danube-3-4b", "qwen3-32b", "granite-34b")
#: phase 6c: the configs that fit the card at full depth
FULL_ARCHS = ("h2o-danube-3-4b", "qwen3-32b")
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
#: phase 6e: the MoE, vision-language and audio families at full size;
#: their serves' new tokens (half of phase 6's NEW_TOKENS: the phase is
#: bound by the host's dispatch, and the script's time limit asks for a cut
#: in depth)
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "internvl2-2b", "musicgen-medium")
FAMILY_NEW_TOKENS = 8
#: musicgen-medium's teacher-forced decode: rows of 4 codebook tokens, steps
CODEBOOK_ROWS = 4
CODEBOOK_STEPS = 32
#: phase 5: (H, D) of MQA decode cases at the other shapes decode_group
#: takes (groups above 8 in bf16): two m-tiles at 128, the padded widths
WIDE_GROUP_CASES = ((24, 128), (16, 80), (16, 120), (16, 64), (16, 32))
#: phase 5: (causal, window) of the random flash cases
FLASH_MASKS = ((True, None), (False, None), (True, 256))
#: phase 5 at head dim 256: recurrentgemma-9b's window of 2048, and 64
D256_MASKS = ((True, None), (False, None), (True, 2048), (True, 64))
#: bf16 scales that flash_wgmma<64> and flash_wgmma<256> compute through
#: the wrapper's rewrite (ops.positive_scale): minus the default scale,
#: which the rewrite turns into the default (the yardstick's), and 0
D64_SCALES = (-0.125, 0.0)
D256_SCALES = (-0.0625, 0.0)
#: phase 5: (D, H, Hkv) of the bf16 cases at those scales, S = 512
SCALE_SHAPES = ((64, 32, 4), (64, 24, 24), (256, 16, 1))
SCALE_LEN = 512
#: phase 6f: recurrentgemma-9b at full width and depth (38 layers, 9.40 B
#: parameters), both routes: requests of PROMPT_LEN prompt tokens and
#: HYBRID_NEW_TOKENS new ones on one slot (the engine gives recurrent
#: kinds one), and a forward of HYBRID_FORWARD_LEN positions, where the
#: window of 2048 masks keys
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_REQUESTS = 4
HYBRID_PROMPT_LEN = 16
HYBRID_NEW_TOKENS = 32
HYBRID_FORWARD_LEN = 4096
#: the attention of every config whose path runs the two kernels: heads,
#: kv heads, head dim, flash window (None: causal only) and decode's batch
#: (one slot for the recurrent hybrid).  Phase 5 tests phase 6e's layouts
#: from it, phase 7 times a row for each config, and so does
#: tools/time_attention.py
ATTENTION_ROWS = {
    "yi-6b": (32, 4, 128, None, 4),
    "h2o-danube-3-4b": (32, 8, 120, 4096, 4),
    "qwen3-32b": (64, 8, 80, None, 4),
    "qwen2-moe-a2.7b": (16, 16, 128, None, 4),
    "internvl2-2b": (16, 8, 128, None, 4),
    "musicgen-medium": (24, 24, 64, None, 4),
    "granite-34b": (48, 1, 128, None, 4),
    HYBRID_ARCH: (16, 1, 256, 2048, 1),
}
#: decode's cache length in phases 5 and 7
DECODE_LEN = 4096
#: phase 7's float32 rows (and tools/time_attention.py's): flash on one
#: FORWARD_LEN-token causal prompt and decode at full length at these
#: configs' heads, in float32 (phase 6h serves Yi-6B so); and flash at head
#: dim 32 with these heads, in float32 and bf16
FLOAT32_ARCHS = ("yi-6b", "h2o-danube-3-4b", "qwen3-32b", "musicgen-medium", HYBRID_ARCH)
D32_HEADS = (32, 4)
#: phase 5: bf16 and float16 flash at head dims up to 32
#: (``flash_wgmma<T, 32>``, ``flash_wgmma_any<T, 32>``) from a generator
#: of their own (SEED + 6): D32_DIMS at heads D32_CASE_HEADS, S in {512,
#: 2048, 200}, FLASH_MASKS (and window 64 at S = 200), the scales
#: D32_SCALES (which the wrapper rewrites) and mask probes, all under
#: ``close_enough`` (p.v takes p as a hi + lo pair)
D32_DIMS = (32, 16, 8, 31)
D32_CASE_HEADS = ((32, 4), (24, 24), (48, 1))
D32_SCALES = (-0.177, 0.0)
#: phase 7's rows beside bf16 at D32_HEADS x 32 (head dim, dtype): float16
#: at 32 and bf16 at 16 (``flash_wgmma_any<bf16, 32>``), drawn last
D32_TIMED = ((32, "float16"), (16, "bfloat16"))
#: exponentials a second on an H100 SXM's MUFU lanes (ex2), about 3.9 T
#: (Shah et al. 2024, FlashAttention-3): phase 7's rows at head dims up to
#: 32 give the floor it puts under the softmax (printed on a line of its
#: own before the ``kernels`` line, computed, not measured)
EX2_RATE = 3.9e12
#: phase 6g: xlstm-350m at full width and depth, deepseek-v3-671b at full
#: width and MLA_LAYERS (mla_dense, mla_moe) of 61 layers
XLSTM_ARCH = "xlstm-350m"
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = (3, 1)
#: xlstm: the card's forward against the CPU's over this many positions
CPU_CHECK_LEN = 128
#: xlstm: new tokens a request (half of HYBRID_NEW_TOKENS) and timed
#: forwards after the first (one, not FORWARD_REPS): its forward is bound by
#: the host's dispatch (about 11-14 s on an H100's host), and the script's
#: time limit asks for a cut in depth
XLSTM_NEW_TOKENS = 16
XLSTM_FORWARD_REPS = 1
#: deepseek: positions of the first layer's absorbed-decode check, and of
#: the whole model's teacher-forced decode against its forward
MLA_CHECK_LEN = 64
DS_FORCED_LEN = 16

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
    from repro_torch.launch.roofline import HBM_BW

    for key, rate in MEMORY_RATE.items():
        if key in name:
            return rate
    return HBM_BW


# --------------------------------------------------------------- phase 1
def build_kernels(mods):
    """Build every kernel library at once, one nvcc process each; print
    each build's time, ptxas's report and the flash library's SASS counts,
    and return those counts (wgmma and TF32 tensor-core instructions)."""
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
            if "registers" in line or "spill" in line or "smem" in line or "warning" in line:
                print(f"  ptxas: {line.strip()}")
    report = ptxas_report(build.BUILD_LOG)
    PTXAS.update(report)
    print("ptxas: " + "; ".join(
        f"{name}: {r['registers']} registers, {r['spill_stores']} B spill stores, "
        f"{r['spill_loads']} B spill loads" for name, r in report.items()))
    lib = build.built_path(flash_source(mods))
    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    tf32 = sum(("HMMA" in line or "HGMMA" in line) and "TF32" in line
               for line in sass.splitlines())
    print(f"build: {lib.name}: {hgmma} HGMMA (wgmma) instructions and {tf32} TF32 "
          f"tensor-core instructions (HMMA or HGMMA with TF32: flash_tf32) in the SASS")
    d32 = {kernel_label(name): counts for name, counts in
           sass_counts(sass, r"flash_wgmma(_any)?I\w+Li32E").items()}
    print(f"build: {lib.name}: SASS of the head-dim-32 kernels: {json.dumps(d32)}")
    return {"HGMMA": hgmma, "TF32": tf32, "d32": d32}


def sass_counts(sass: str, pattern: str) -> dict:
    """For each kernel in ``cuobjdump -sass`` output whose mangled name
    matches ``pattern``: its wgmma instructions (HGMMA), the waits on them
    (WARPGROUP.DEPBAR; one after every HGMMA means ptxas serialised them),
    its mma.sync instructions (HMMA, and HMMA.TF32 those in TF32), its
    local-memory loads and stores (LDL/STL: spills) and the highest
    register it names."""
    import re

    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if re.search(pattern, name):
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
            out[name] = {"HGMMA": len(re.findall(r"\bHGMMA\b", body)),
                         "HMMA": len(re.findall(r"\bHMMA\b", body)),
                         "HMMA.TF32": len(re.findall(r"\bHMMA\S*TF32", body)),
                         "WARPGROUP.DEPBAR": len(re.findall(r"WARPGROUP\.DEPBAR", body)),
                         "LDL/STL": len(re.findall(r"\b(?:LDL|STL)\b", body)),
                         "highest register": max(regs, default=-1)}
    return out


#: registers and spill bytes by kernel, from phase 1's build
PTXAS: dict = {}


def kernel_label(mangled: str) -> str:
    """``flash_wgmma<bf16, 256>``, ``flash_tf32<f32, 32>``,
    ``decode_group<bf16, 128, 3>``, ``decode_split<f32, 128>`` from a
    mangled kernel name, read as
    the Itanium grammar reads it: after ``_ZN``, the nested name's
    ``<length><identifier>`` pieces from the front (namespace, then the
    kernel, which may end in digits), then its template arguments."""
    import re

    if not mangled.startswith("_ZN"):
        return mangled
    pos, name = 3, None
    while (m := re.compile(r"\d+").match(mangled, pos)) is not None:
        end = m.end() + int(m.group())
        name, pos = mangled[m.end():end], end
    args = re.compile(r"I(.*?)EEv").match(mangled, pos)
    if name is not None and args is None and mangled[pos:pos + 1] == "E":
        return name  # not a template: ``merge_partials``
    if name is None or args is None:
        return mangled
    types = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32", "i": "i32",
             "j": "u32"}
    words = [num or types[typ] for num, typ in
             re.findall(r"L[ij](\d+)E|(13__nv_bfloat16|6__half|[fij])", args.group(1))]
    return f"{name}<{', '.join(words)}>"


def ptxas_report(logs) -> dict:
    """Registers and spill bytes of every kernel in ptxas's reports (the
    ``-Xptxas -v`` output kept by the build), by kernel."""
    import re

    out, name = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = kernel_label(m.group(1))
                out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                out[name]["spill_stores"], out[name]["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"] = int(m.group(1))
    return out


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


def device_rows(prof):
    """The device's operations in a finished profile, by name
    (``key_averages``): kernels, copies and fills.  The program's spans
    (``lm.*``) appear on the device's timeline too, as user annotations
    that hold no work; they are left out."""
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]


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
    kernels = device_rows(prof)
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
    from repro_torch.launch.roofline import FP32_FLOPS

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
    # above 1024 groups (rows partitioned by group window, each window
    # binned, the partials merged): Q2's rows with keys drawn over [0, G);
    # on no path (a caller raises max_groups)
    gen = torch.Generator(device=keys.device).manual_seed(SEED + 3)
    many = {}
    for g in TIMED_GROUPS:
        gkeys = torch.randint(0, g, (n,), generator=gen, device=keys.device, dtype=torch.int32)
        gkw = dict(op="ge", threshold=0.5, num_groups=g)
        s_k, c_k = ops.fused_filter_agg(gkeys, vals, filt, **gkw)
        s_p, c_p = ref.fused_filter_agg_ref(gkeys, vals, filt, **gkw)
        torch.cuda.synchronize()
        check(torch.equal(s_k, s_p) and torch.equal(c_k, c_p),
              f"kernel vs plain at Q2's rows, G={g}")
        gm, gv = gkeys[keep], vals[keep].to(torch.float32)
        fn = lambda: ops.fused_filter_agg(gkeys, vals, filt, **gkw)  # noqa: E731
        g_ms, g_ahead = time_ms(torch, fn, flush)
        check(g_ahead, "the host fell behind the card while queuing the kernel's launches")
        g_bytes_ms = (n * 12 + 2 * g * 4) / memory_rate(card) * 1e3
        g_ops_ms = 3 * n / FP32_FLOPS * 1e3
        many[f"G={g}"] = {
            "launches": 0, "launches_by_path": {},
            "max_abs_err": max(float((s_k - s_p).abs().max()), float((c_k - c_p).abs().max())),
            "ms": g_ms, "wrapper_ms": time_ms(torch, fn, flush, queued=False)[0],
            "plain_ms": time_ms(torch, lambda: ref.fused_filter_agg_ref(
                gkeys, vals, filt, **gkw), flush)[0],
            "bound_ms": max(g_bytes_ms, g_ops_ms),
            "bound_by": "bytes" if g_bytes_ms >= g_ops_ms else "operations",
            "library_ms": time_ms(torch, lambda: torch.bincount(gm, weights=gv, minlength=g),
                                  flush)[0],
            "plan": ops.many_plan(n, g)._asdict(), "launch_sequence": ops.launch_sequence(n, g),
            "scratch_bytes": ops.scratch_bytes(n, g),
            "passing_rows": int(((filt >= 0.5) & (gkeys >= 0) & (gkeys < g)).sum()),
            "ptxas": {k: PTXAS.get(k) for k in (
                f"partition_rows<{'i32' if vals.dtype == torch.int32 else 'f32'}, "
                f"{'i32' if filt.dtype == torch.int32 else 'f32'}>", "bin_buckets",
                "merge_partials")},
            "n": n, "num_groups": g}
    print(f"fused_filter_agg above 1024 groups (Q2's rows, keys over [0, G)): "
          f"{json.dumps(many)}")
    ops.LAUNCHES = before  # timing launches are not main-path launches
    nbytes = n * (4 + 4 + 4) + 2 * G * 4
    bytes_ms = nbytes / memory_rate(card) * 1e3
    ops_ms = 3 * n / FP32_FLOPS * 1e3  # compare, add, count per row
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
        "many_groups": many,
    }
    return row


# --------------------------------------------------------------- phase 5
#: mantissa bits of the 16-bit types, for their ulp
MANTISSA_BITS = {"bfloat16": 7, "float16": 10}


def close_enough(torch, got, want) -> bool:
    """float32: within 1e-5 + 1e-5 |want| (sums in another order);
    bfloat16 and float16: within one ulp of the type at the larger
    magnitude (both versions compute in float32 and round once) plus the
    same 1e-5 floor, since near 0 an ulp is smaller than the float32 sums'
    own difference.  The rule of float32 flash and of decode in every type."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        return bool((diff <= 1e-5 + 1e-5 * want.abs()).all())
    bits = MANTISSA_BITS[str(want.dtype).split(".")[-1]]
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - bits)
    return bool((diff <= 1e-5 + ulp).all())


def flash_yardstick(q, k, v, *, causal, window):
    """The reference's own 16-bit route at the same inputs: the port's
    copy of the JAX package's ``_sdpa_chunked`` with one chunk of S keys (q
    * scale and p rounded to q's dtype, bf16 or float16, float32 sums),
    rounded to q's dtype."""
    from repro_torch.models.attention import _sdpa_chunked

    return _sdpa_chunked(q, k, v, causal=causal, window=window,
                         chunk=q.shape[2]).to(q.dtype)


def flash_bf16_close(torch, got, want, yard):
    """The bf16 flash rule, and float16's.  The kernel runs both products
    on the tensor cores with 16-bit operands (p rounded to q's dtype), so
    it cannot match the float32 plain version to one ulp.  It passes when
    its largest and its mean |kernel - plain| are each at most twice those
    of ``yard`` (the reference's chunked route in q's dtype,
    ``flash_yardstick``) against the same plain version, plus 1e-5:
    FlashAttention's own test rule, with the JAX package's own route as the
    yardstick.  Where the route's own error is exactly 0 everywhere (scale
    0: every p is 1, nothing rounds but the mean's float32 sums, taken in
    another order by each), twice 0 would ask for bit-exact sums, so the
    kernel gets the one-ulp-plus-1e-5 rule of every other 16-bit kernel
    (``close_enough``).  Returns (ok, (kernel max, kernel mean, route max,
    route mean))."""
    e = (got.float() - want.float()).abs()
    ey = (yard.float() - want.float()).abs()
    stats = (float(e.max()), float(e.mean()), float(ey.max()), float(ey.mean()))
    if stats[2] == 0.0:
        return close_enough(torch, got, want), stats
    ok = stats[0] <= 2 * stats[2] + 1e-5 and stats[1] <= 2 * stats[3] + 1e-5
    return ok, stats


#: the bf16 and float16 head dims whose flash kernel (flash_wgmma) feeds p.v
#: p rounded once to q's dtype, so that it is held to the 16-bit flash rule
#: (``flash_bf16_close``): 33 to 256.  At 32 and below (flash_wgmma<T, 32>)
#: and above 256 (flash_wgmma_wide) p goes in as a hi + lo pair, and float32
#: is split into TF32 hi + lo: those keep ``close_enough``.  The rule is
#: chosen here, by dtype and head dim, not by the code under test.
P_ROUNDED_DIMS = range(33, 257)


def p_rounded(dtype, head_dim: int) -> bool:
    """Whether flash at ``dtype`` and ``head_dim`` is held to the 16-bit
    flash rule (``P_ROUNDED_DIMS``) rather than to ``close_enough``."""
    return dtype.itemsize == 2 and head_dim in P_ROUNDED_DIMS


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

    def randn(*shape, dtype, generator=None):
        return torch.randn(*shape, generator=generator or gen, device=dev).to(dtype)

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
        if kind.startswith("flash"):
            rules[(out.dtype, out.shape[-1])] = (
                "the bf16 flash rule" if yard is not None
                else "1e-5 + 1e-5|plain|" if out.dtype == torch.float32
                else f"1e-5 + one {str(out.dtype).split('.')[-1]} ulp")
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

    worst, rules = {}, {}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            for h, hkv in ((32, 4), (48, 1)):
                for s in (1024, 4096):
                    q = randn(b, h, 128, dtype=dtype)
                    k, v = randn(b, hkv, s, 128, dtype=dtype), randn(b, hkv, s, 128, dtype=dtype)
                    _, chunk = decode_ops.split_plan(s, b * hkv, sms, h // hkv, 128, dtype)
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
        # head dim 32: flash_tf32 in float32 (split-TF32 products, float32
        # sums), flash_wgmma<bf16, 32> in bf16 (p.v with p as a hi + lo
        # pair), both under close_enough; more D = 32 cases follow the loop
        q = randn(1, 32, 512, 32, dtype=dtype)
        k, v = randn(1, 4, 512, 32, dtype=dtype), randn(1, 4, 512, 32, dtype=dtype)
        for window in (None, 256):
            kw = dict(causal=True, window=window)
            one("flash D=32", f"flash {dtype} D=32 S=512 {kw}",
                lambda: flash_ops.flash_attention(q, k, v, **kw),
                lambda: flash_ref.attention_ref(q, k, v, **kw))
        # head dim 64 at musicgen-medium's 24/24 and at 32/4: bf16 on
        # flash_wgmma's overlapped schedule under the bf16 flash rule,
        # float32 on flash_tf32 under 1e-5; S = 512, 2048 and the ragged 200
        # (a window of 64 masks inside both of its tiles), and mask probes
        for h, hkv in ((32, 4), (24, 24)):
            for s, cases in ((512, FLASH_MASKS), (2048, FLASH_MASKS),
                             (200, FLASH_MASKS + ((True, 64),))):
                q = randn(1, h, s, 64, dtype=dtype)
                k, v = randn(1, hkv, s, 64, dtype=dtype), randn(1, hkv, s, 64, dtype=dtype)
                for causal, window in cases:
                    kw = dict(causal=causal, window=window)
                    one("flash D=64", f"flash {dtype} D=64 H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
            for s in (512, 2048):
                for window in (None, 256):
                    q, k, v = mask_probe(torch, s, window=window, h=h, hkv=hkv, d=64,
                                         dtype=dtype, generator=gen)
                    kw = dict(causal=True, window=window)
                    one("flash probe D=64", f"flash mask probe {dtype} D=64 H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
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
        # flash_tf32 under 1e-5
        for d, h, hkv in ((80, 64, 8), (120, 32, 8)):
            s = 4096
            q = randn(4, h, d, dtype=dtype)
            k, v = randn(4, hkv, s, d, dtype=dtype), randn(4, hkv, s, d, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4 * hkv, sms, h // hkv, d, dtype)
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
        # phase 6e's head layouts: MHA (group 1) at 24/24 (D = 64) and 16/16
        # (D = 128), GQA group 2 at 16/8 (D = 128)
        for h, hkv, d, _, _ in (ATTENTION_ROWS[a] for a in FAMILY_ARCHS):
            s = 4096
            q = randn(4, h, d, dtype=dtype)
            k, v = randn(4, hkv, s, d, dtype=dtype), randn(4, hkv, s, d, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4 * hkv, sms, h // hkv, d, dtype)
            for lens in ([1, s - 1, s, 0], [chunk - 1, chunk, chunk + 1, s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode families", f"decode {dtype} D={d} B=4 H={h}/{hkv} S={s} "
                    f"chunk={chunk} lengths={lens}",
                    lambda: decode_ops.decode_attention(q, k, v, lengths),
                    lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
            wgmma = p_rounded(dtype, d)
            for s in (512, 2048):
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
        # bf16 at D = 64 and 256 at every finite scale: flash_wgmma computes
        # a negative scale and 0 there through the wrapper's rewrite; the
        # yardstick is the chunked route at the rewritten (q, default
        # scale), which gives the same scores
        if bf16:
            for d, h, hkv in SCALE_SHAPES:
                q = randn(1, h, SCALE_LEN, d, dtype=dtype)
                k = randn(1, hkv, SCALE_LEN, d, dtype=dtype)
                v = randn(1, hkv, SCALE_LEN, d, dtype=dtype)
                for scale in (D64_SCALES if d == 64 else D256_SCALES):
                    qy, sy = flash_ops.positive_scale(q, scale)
                    check(sy == d ** -0.5 or not bool(qy.any()),
                          "the yardstick runs at the default scale")
                    for causal, window in FLASH_MASKS:
                        kw = dict(causal=causal, window=window)
                        one(f"flash D={d} scale", f"flash {dtype} D={d} H={h}/{hkv} S=512 "
                            f"scale={scale} {kw}",
                            lambda: flash_ops.flash_attention(q, k, v, scale=scale, **kw),
                            lambda: flash_ref.attention_ref(q, k, v, scale=scale, **kw),
                            lambda: flash_yardstick(qy, k, v, **kw))
        # head dim 256 (recurrentgemma-9b: MQA 16/1, window 2048; and GQA
        # 16/4): bf16 on flash_wgmma<256> (64-key tiles) under the bf16 flash
        # rule, float32 on flash_tf32<float, 256> (32-key tiles) under 1e-5
        # (window 256 follows the loop); S = 4096 is where the window of 2048
        # masks, 200 the ragged end
        for h, hkv in ((16, 1), (16, 4)):
            for s in (512, 2048, 4096, 200):
                q = randn(1, h, s, 256, dtype=dtype)
                k, v = randn(1, hkv, s, 256, dtype=dtype), randn(1, hkv, s, 256, dtype=dtype)
                for causal, window in D256_MASKS:
                    kw = dict(causal=causal, window=window)
                    one("flash D=256", f"flash {dtype} D=256 H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
                del q, k, v
            for s in (512, 2048):
                for window in (None, 256):
                    q, k, v = mask_probe(torch, s, window=window, h=h, hkv=hkv, d=256,
                                         dtype=dtype, generator=gen)
                    kw = dict(causal=True, window=window)
                    one("flash probe D=256", f"flash mask probe {dtype} D=256 H={h}/{hkv} "
                        f"S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw),
                        (lambda: flash_yardstick(q, k, v, **kw)) if bf16 else None)
        # decode at D = 256: MQA groups 16 (recurrentgemma-9b) and 64 (the
        # kernel's largest), B = 4 at ragged lengths and at the plan's chunk
        # edges, and one sequence (recurrentgemma's serve) at 0, 1, S and its
        # own plan's chunk edges
        for h in (16, 64):
            s = 4096
            q = randn(4, h, 256, dtype=dtype)
            k, v = randn(4, 1, s, 256, dtype=dtype), randn(4, 1, s, 256, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4, sms, h, 256, dtype)
            for lens in ([1, s - 1, s, 0], [chunk - 1, chunk, chunk + 1, s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode D=256", f"decode {dtype} D=256 B=4 H={h}/1 S={s} chunk={chunk} "
                    f"lengths={lens}",
                    lambda: decode_ops.decode_attention(q, k, v, lengths),
                    lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
            q1, k1, v1 = q[:1], k[:1], v[:1]
            _, chunk = decode_ops.split_plan(s, 1, sms, h, 256, dtype)
            for lens in ([0], [1], [chunk - 1], [chunk], [chunk + 1], [s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode D=256", f"decode {dtype} D=256 B=1 H={h}/1 S={s} chunk={chunk} "
                    f"lengths={lens}",
                    lambda: decode_ops.decode_attention(q1, k1, v1, lengths),
                    lambda: decode_ref.decode_attention_ref(q1, k1, v1, lengths))
        # the other shapes decode_group takes in bf16 (float32 runs
        # decode_split at them): group 24, two m-tiles, at D = 128; group 16
        # at D = 80 and 120 (the padded widths, columns past D zero) and at
        # 64 and 32; B = 4 at ragged lengths and the plan's chunk edges
        for h, d in WIDE_GROUP_CASES:
            s = 4096
            q = randn(4, h, d, dtype=dtype)
            k, v = randn(4, 1, s, d, dtype=dtype), randn(4, 1, s, d, dtype=dtype)
            _, chunk = decode_ops.split_plan(s, 4, sms, h, d, dtype)
            for lens in ([1, s - 1, s, 0], [chunk - 1, chunk, chunk + 1, s]):
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                one("decode wide groups", f"decode {dtype} D={d} B=4 H={h}/1 S={s} "
                    f"chunk={chunk} lengths={lens} "
                    f"({decode_ops.decode_kernel(dtype, h, d)})",
                    lambda: decode_ops.decode_attention(q, k, v, lengths),
                    lambda: decode_ref.decode_attention_ref(q, k, v, lengths))
    # head dim 32 in both dtypes (flash_tf32 in float32, flash_wgmma<bf16, 32> in bf16) and
    # flash_tf32 at 256 in float32, the cases D = 64 has: S = 512, 2048 and the ragged 200 (a
    # window of 64 masks inside both of its tiles), causal, non-causal and window 256, and
    # mask probes.  They draw from a generator of their own, so the cases above keep their
    # inputs whatever is added here (ROADMAP section 3 records a bf16 case at scale 0 that
    # fails the bf16 flash rule at other inputs; tools/flash_scale0_probe.py finds such
    # inputs).
    tf32_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for dtype in (torch.float32, torch.bfloat16):
        for d, h, hkv in ((32, 32, 4),) + (((256, 16, 1),) if dtype == torch.float32 else ()):
            for s, cases in ((512, FLASH_MASKS), (2048, FLASH_MASKS),
                             (200, FLASH_MASKS + ((True, 64),))):
                q = randn(1, h, s, d, dtype=dtype, generator=tf32_gen)
                k = randn(1, hkv, s, d, dtype=dtype, generator=tf32_gen)
                v = randn(1, hkv, s, d, dtype=dtype, generator=tf32_gen)
                for causal, window in cases:
                    kw = dict(causal=causal, window=window)
                    one(f"flash D={d} tf32", f"flash {dtype} D={d} H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw))
                del q, k, v
            for s in (512, 2048):
                for window in (None, 256):
                    q, k, v = mask_probe(torch, s, window=window, h=h, hkv=hkv, d=d,
                                         dtype=dtype, generator=tf32_gen)
                    kw = dict(causal=True, window=window)
                    one(f"flash probe D={d} tf32", f"flash mask probe {dtype} D={d} "
                        f"H={h}/{hkv} S={s} {kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw))
    # bf16 and float16 at head dims up to 32 (flash_wgmma<T, 32>,
    # flash_wgmma_any<T, 32>), a generator of their own (SEED + 6): D32_DIMS
    # at D32_CASE_HEADS, S = 512, 2048 and the ragged 200, the scales the
    # wrapper rewrites, mask probes, and each (dtype, head dim)'s kernel read
    # back from the profiler; all under close_enough
    d32_gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    d32_kernels, d32_failures = [], []
    for dtype in (torch.bfloat16, torch.float16):
        for d in D32_DIMS:
            label = flash_ops.kernel_label(dtype, d)
            for h, hkv in D32_CASE_HEADS:
                for s, cases in ((512, FLASH_MASKS), (2048, FLASH_MASKS),
                                 (200, FLASH_MASKS + ((True, 64),))):
                    q = randn(1, h, s, d, dtype=dtype, generator=d32_gen)
                    k = randn(1, hkv, s, d, dtype=dtype, generator=d32_gen)
                    v = randn(1, hkv, s, d, dtype=dtype, generator=d32_gen)
                    kws = [dict(causal=c, window=w) for c, w in cases]
                    if s == 512:
                        kws += [dict(causal=True, window=None, scale=x) for x in D32_SCALES]
                    for kw in kws:
                        one("flash D<=32", f"flash {dtype} D={d} ({label}) H={h}/{hkv} S={s} "
                            f"{kw}",
                            lambda: flash_ops.flash_attention(q, k, v, **kw),
                            lambda: flash_ref.attention_ref(q, k, v, **kw))
                    del q, k, v
            for s in (512, 2048):
                for window in (None, 256):
                    q, k, v = mask_probe(torch, s, window=window, d=d, dtype=dtype,
                                         generator=d32_gen)
                    kw = dict(causal=True, window=window)
                    one("flash probe D<=32", f"flash mask probe {dtype} D={d} ({label}) S={s} "
                        f"{kw}",
                        lambda: flash_ops.flash_attention(q, k, v, **kw),
                        lambda: flash_ref.attention_ref(q, k, v, **kw))
            q, k, v = (randn(1, n_, 200, d, dtype=dtype, generator=d32_gen) for n_ in (32, 4, 4))
            d32_kernels.append((label, lambda q=q, k=k, v=v: flash_ops.flash_attention(q, k, v)))
    check_launched(torch, d32_kernels, d32_failures)
    check(not d32_failures, "; ".join(d32_failures))
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = before  # comparisons are not the main path
    by_rule = "; ".join(
        f"{str(dt).split('.')[-1]} D={d} ({flash_ops.kernel_name(dt, d)}) {rule}"
        for (dt, d), rule in sorted(rules.items(), key=lambda x: (str(x[0][0]), x[0][1])))
    print(f"attention kernels vs plain: {n} cases pass; flash by (dtype, head dim): {by_rule} "
          f"(the bf16 flash rule: max and mean |kernel - plain| within twice the chunked "
          f"route's + 1e-5); decode in both dtypes within 1e-5 + 1e-5|plain| (bf16: + one bf16 "
          f"ulp); repeat launches bitwise equal; max |kernel - plain|: "
          + ", ".join(f"{k} {str(dt).split('.')[-1]} {v!r}" for (k, dt), v in worst.items()))


#: phase 5: the rest of the kernels' domain: head dims off the compiled widths
#: (1 pads inside the wrapper in bf16 and float16; 33, 100, 150, 90 and 170
#: are rows of bf16 and float16 that are not whole 16-byte pieces, which
#: flash_wgmma_any's narrow loader reads as they are, at each of its
#: geometries: 64 and 128 with a producer, 96 with 128-key tiles and none,
#: 160 and 192 with 64-key tiles and none; 210 and 250 are such rows above
#: 192, which the wrapper pads; 96 is Phi-3-mini's; 160, 192, 200 and 224
#: run flash_wgmma_any at 160, 192 and 224), decode
#: groups above the kernel's 64 (Falcon-7B's 71/1 and a 128/1), and
#: fused_filter_agg above 1024 groups
ODD_DIMS = (1, 33, 96, 100, 250, 150, 160, 192, 200, 224, 90, 170, 210)
#: and, for those bf16 and float16 rows (the narrow loader's and the padded
#: ones above 192), a prompt of ODD_HEAD_LEN tokens whose q, k and v start
#: 1, 3 and 5 elements into their buffers, so that heads and rows start at
#: any even address
ODD_HEAD_LEN = 199
WIDE_GROUPS = (71, 128)
WIDE_GROUP_DIMS = (64, 128)
MANY_GROUPS = (1025, 4096, 65536, 262144)
#: phase 5: head dims above 256 (``flash_wgmma_wide``, ``flash_tf32_wide``,
#: ``decode_wide``), in all three dtypes, drawn from a generator of their
#: own (SEED + 3): flash at WIDE_FLASH_HEADS, decode at WIDE_DECODE_HEADS,
#: S = ODD_DECODE_LEN
WIDE_DIMS = (257, 320, 512, 576, 1024)
WIDE_FLASH_HEADS = ((32, 4), (16, 1))
WIDE_DECODE_HEADS = ((32, 4), (16, 1), (71, 1))
#: and decode_wide at every geometry of its plan (a generator of its own,
#: SEED + 5): WIDE_DIMS and a 16-bit row that is not whole 16-byte pieces,
#: at groups 9, 16 and 71, B = 4, S = DECODE_LEN (the plan's chunks: 512
#: rows, each several k and v tiles)
WIDE_ODD_DIM = 515
WIDE_DECODE_GROUPS = ((36, 4), (64, 4), (71, 1))
#: phase 7's rows for them: flash (H, Hkv) at head dim WIDE_TIMED_DIM, and
#: decode 32/4 at it, in bf16 and float32; flash at the first heads in
#: float16 too
WIDE_TIMED_DIM = 512
WIDE_TIMED_FLASH = ((16, 1), (32, 4))
#: decode_wide's timed rows (H, Hkv, D, dtype), B = 4, S = DECODE_LEN, full
#: length: 32/4 x WIDE_TIMED_DIM in each dtype, a slice tail (16/1 x 576:
#: 64 columns of its last slice of 256) and rows that are not whole 16-byte
#: pieces (32/4 x 515); phase 7 times the float16, 576 and 515 rows beside
#: the bf16 and float32 ones above (tools/time_attention.py all five)
WIDE_TIMED_DECODE = ((32, 4, 512, "bfloat16"), (32, 4, 512, "float16"),
                     (32, 4, 512, "float32"), (16, 1, 576, "bfloat16"),
                     (32, 4, 515, "bfloat16"))
#: their cache and prompt lengths (S = 200: one full and one ragged tile)
ODD_DECODE_LEN = 1024
ODD_FLASH_LENS = (512, 200)
#: phase 7's rows for them: Phi-3-mini's flash heads (32/32 x 96) and
#: Falcon-7B's decode heads (MQA 71/1 x 64), and fused_filter_agg's groups
PHI3_HEADS = (32, 32, 96)
FALCON_HEADS = (71, 1, 64)
#: and a flash row whose rows are not whole 16-byte pieces (33 bf16
#: elements, which the kernel reads as they are: no padded copy), and one
#: at head dim 160 (32/4, bf16: ``flash_wgmma_any<bf16, 160>``)
NARROW_DIM = 33
ANY_TIMED_HEADS = (32, 4, 160)
#: (4096 and 65536 first: their keys are drawn as before)
TIMED_GROUPS = (4096, 65536, 262144, 1025)


def profiled_label(name: str) -> str:
    """A kernel's label (``flash_wgmma_any<bf16, 96>``) from the name
    torch.profiler gives it: mangled (``kernel_label``) or demangled
    (``void (anonymous namespace)::flash_wgmma_any<__nv_bfloat16, 96>(...)``)."""
    import re

    if name.startswith("_Z"):
        return kernel_label(name)
    m = re.search(r"(\w+)<([^<>]*)>\(", name)
    if m is None:
        return name
    types = {"__nv_bfloat16": "bf16", "__half": "f16", "float": "f32"}
    args = [types.get(a.strip(), a.strip().replace("(int)", "")) for a in m.group(2).split(",")]
    return f"{m.group(1)}<{', '.join(args)}>"


def check_launched(torch, launched, failures, kind="flash_"):
    """Phase 5: the calls of ``launched`` (kernel label, call) under
    torch.profiler, twice in order; in the second round each call's kernel
    whose name holds ``kind`` (``flash_``, or ``decode_wide``, which
    ``decode_combine_wide`` does not hold) must be the one the wrapper
    names, and a profile with no such kernel in it is a failure too.  The
    first round is not read: the profiler has been seen to record none of
    the first one or two kernels of a window (of decode_wide's, in the
    whole script, though a host pause and a sleep kernel opened it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            for _, fn in launched:
                fn()
        torch.cuda.synchronize()
    ran = [profiled_label(e.name) for e in sorted(
        (e for e in prof.events() if e.device_type.name == "CUDA" and kind in e.name),
        key=lambda e: e.time_range.start)]
    want = [label for label, _ in launched]
    if not ran or ran[-len(want):] != want:
        failures.append(f"the kernels launched {ran} (second round last) are not the "
                        f"wrapper's {want}")
    else:
        print(f"domain vs plain: each of {len(want)} (dtype, head dim) launched the kernel the "
              f"wrapper names: " + ", ".join(sorted(set(want))))


def domain_vs_plain(torch, flash_ops, flash_ref, decode_ops, decode_ref, ffa_ops, ffa_ref,
                    inputs):
    """Phase 5's cases for float16, any head dim, any group and any group
    count, drawn from a generator of their own (SEED + 2; the head dims
    above 256 from another, SEED + 3), so the cases before keep their
    inputs: float16 flash at every compiled width (causal,
    non-causal, window 256, window 64 at the ragged S = 200, mask probes)
    under the 16-bit flash rule (``flash_wgmma<f16, 32>`` under one float16
    ulp + 1e-5); float16 decode at narrow (32/4) and wide groups (48/1 at
    128, 16/1 at 256); head dims ODD_DIMS in all three dtypes in both
    kernels; decode groups WIDE_GROUPS at WIDE_GROUP_DIMS in all three
    dtypes, B = 4 at lengths 1, S - 1, S, 0 and the plan's chunk edges; and
    fused_filter_agg at MANY_GROUPS over Q2's rows (``inputs``: its own keys,
    and keys drawn over [-1, G]): counts exact, float sums within 1e-5
    sum|v| of a float64 oracle, integer sums exact, repeat launches bitwise
    equal; and head dims WIDE_DIMS in all three dtypes in both kernels
    (flash at WIDE_FLASH_HEADS, decode at WIDE_DECODE_HEADS) under the
    rules of the non-wgmma kernels; then (SEED + 5) decode_wide at
    WIDE_DIMS and WIDE_ODD_DIM, groups WIDE_DECODE_GROUPS, S = DECODE_LEN,
    lengths about its tiles' and chunks' edges, each (dtype, head dim)'s
    decode kernel read back from torch.profiler.  Every case runs; the
    failures are listed together."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    before = flash_ops.LAUNCHES, decode_ops.LAUNCHES, ffa_ops.LAUNCHES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failures, worst, rules = [], {}, {}
    n = 0

    def randn(*shape, dtype, generator=gen):
        return torch.randn(*shape, generator=generator, device=dev).to(dtype)

    def name_of(dtype):
        return str(dtype).split(".")[-1]

    def one(kind, name, kernel, plain, yard=None):
        nonlocal n
        n += 1
        out, out2 = kernel(), kernel()
        torch.cuda.synchronize()
        want = plain()
        diff = float((out.float() - want.float()).abs().max())
        worst[(kind, out.dtype)] = max(worst.get((kind, out.dtype), 0.0), diff)
        if not torch.equal(out, out2):
            failures.append(f"{name}: two launches differ")
        elif out.dtype != want.dtype or out.shape != want.shape:
            failures.append(f"{name}: dtype/shape {out.dtype} {tuple(out.shape)}")
        elif not bool(torch.isfinite(out).all()):
            failures.append(f"{name}: not finite")
        elif yard is None:
            if not close_enough(torch, out, want):
                failures.append(f"{name}: kernel vs plain max |diff| {diff!r}")
        else:
            ok, stats = flash_bf16_close(torch, out, want, yard())
            if not ok:
                failures.append(f"{name}: kernel vs plain (max, mean) {stats[:2]!r} exceed "
                                f"twice the chunked route's {stats[2:]!r} + 1e-5")

    def flash(dtype, d, h, hkv, s, cases, probes=(), tag="", generator=gen, offsets=None):
        label = flash_ops.kernel_label(dtype, d)
        wgmma = p_rounded(dtype, d)  # p.v on p rounded once to q's dtype
        rules[label] = ("the 16-bit flash rule" if wgmma else "1e-5 + 1e-5|plain|"
                        if dtype == torch.float32 else f"1e-5 + one {name_of(dtype)} ulp")
        q = randn(1, h, s, d, dtype=dtype, generator=generator)
        k = randn(1, hkv, s, d, dtype=dtype, generator=generator)
        v = randn(1, hkv, s, d, dtype=dtype, generator=generator)
        if offsets is not None:  # the same values, `off` elements into a buffer
            q, k, v = (torch.empty(t.numel() + off, dtype=dtype, device=dev)[off:]
                       .view(t.shape).copy_(t) for t, off in zip((q, k, v), offsets))
        for causal, window in cases:
            kw = dict(causal=causal, window=window)
            one(f"flash{tag}", f"flash {dtype} D={d} ({label}) H={h}/{hkv} S={s} {kw}",
                lambda: flash_ops.flash_attention(q, k, v, **kw),
                lambda: flash_ref.attention_ref(q, k, v, **kw),
                (lambda: flash_yardstick(q, k, v, **kw)) if wgmma else None)
        del q, k, v
        for window in probes:
            q, k, v = mask_probe(torch, s, window=window, h=h, hkv=hkv, d=d, dtype=dtype,
                                 generator=gen)
            kw = dict(causal=True, window=window)
            one(f"flash probe{tag}", f"flash mask probe {dtype} D={d} ({label}) H={h}/{hkv} "
                f"S={s} {kw}",
                lambda: flash_ops.flash_attention(q, k, v, **kw),
                lambda: flash_ref.attention_ref(q, k, v, **kw),
                (lambda: flash_yardstick(q, k, v, **kw)) if wgmma else None)

    def decode(dtype, d, h, hkv, s, b=4, tag="", generator=gen, lens_of=None):
        """``lens_of(chunk)``: the cases' lengths (default: 1, S - 1, S, 0
        and the chunk's edges)."""
        q = randn(b, h, d, dtype=dtype, generator=generator)
        k = randn(b, hkv, s, d, dtype=dtype, generator=generator)
        v = randn(b, hkv, s, d, dtype=dtype, generator=generator)
        _, chunk = decode_ops.split_plan(s, b * hkv, sms, h // hkv, d, dtype)
        label = decode_ops.decode_kernel(dtype, h // hkv, d)
        rules[label] = ("1e-5 + 1e-5|plain|" if dtype == torch.float32
                        else f"1e-5 + one {name_of(dtype)} ulp")
        sets = (([1, s - 1, s, 0][:b], [chunk - 1, chunk, chunk + 1, s][:b])
                if lens_of is None else lens_of(chunk))
        for lens in sets:
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            one(f"decode{tag}", f"decode {dtype} D={d} ({label}) B={b} H={h}/{hkv} S={s} "
                f"chunk={chunk} lengths={lens}",
                lambda: decode_ops.decode_attention(q, k, v, lengths),
                lambda: decode_ref.decode_attention_ref(q, k, v, lengths))

    f16 = torch.float16
    # float16 flash at every compiled width, float16 decode at narrow and
    # wide groups
    for d in flash_ops.HEAD_DIMS:
        h, hkv = (16, 1) if d == 256 else (32, 4)
        for s, cases in ((512, FLASH_MASKS), (200, FLASH_MASKS + ((True, 64),))):
            flash(f16, d, h, hkv, s, cases, probes=(None, 256) if s == 512 else (),
                  tag=" float16")
    for d, h, hkv in ((128, 32, 4), (128, 48, 1), (256, 16, 1)):
        decode(f16, d, h, hkv, DECODE_LEN, tag=" float16")
    # head dims off the compiled widths, in every dtype; the dims after 250
    # draw from a generator of their own, so the cases before keep their
    # inputs
    odd = torch.Generator(device=dev).manual_seed(SEED + 4)
    odd_kernels = []  # (the kernel the wrapper names, a launch of it) a (dtype, D)
    for dtype in (torch.float32, torch.bfloat16, f16):
        for d in ODD_DIMS:
            gd = gen if ODD_DIMS.index(d) <= ODD_DIMS.index(250) else odd
            for s in ODD_FLASH_LENS:
                cases = FLASH_MASKS + (((True, 64),) if s == 200 else ())
                flash(dtype, d, 32, 4, s, cases, tag=" odd D", generator=gd)
            decode(dtype, d, 32, 4, ODD_DECODE_LEN, tag=" odd D", generator=gd)
            decode(dtype, d, 16, 1, ODD_DECODE_LEN, tag=" odd D", generator=gd)
            q, k, v = (randn(1, n_, 200, d, dtype=dtype, generator=odd) for n_ in (32, 4, 4))
            odd_kernels.append((flash_ops.kernel_label(dtype, d),
                             lambda q=q, k=k, v=v: flash_ops.flash_attention(q, k, v)))
            if (d * dtype.itemsize) % 16 and dtype != torch.float32 and d > 32:
                flash(dtype, d, 32, 4, ODD_HEAD_LEN, FLASH_MASKS, tag=" odd D, any address",
                      generator=odd, offsets=(1, 3, 5))
        # groups above 64: one block a slice of the group
        for g in WIDE_GROUPS:
            for d in WIDE_GROUP_DIMS:
                decode(dtype, d, g, 1, DECODE_LEN, tag=" wide group")
    check_launched(torch, odd_kernels, failures)
    # head dims above 256 (flash_wgmma_wide, flash_tf32_wide, decode_wide),
    # from a generator of their own, so the cases above and below keep their
    # inputs; every case launches the kernels (twice), none takes the plain
    # version
    wide = torch.Generator(device=dev).manual_seed(SEED + 3)
    n_before, launched = n, (flash_ops.LAUNCHES, decode_ops.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16, f16):
        for d in WIDE_DIMS:
            for h, hkv in WIDE_FLASH_HEADS:
                for s in ODD_FLASH_LENS:
                    cases = FLASH_MASKS + (((True, 64),) if s == 200 else ())
                    flash(dtype, d, h, hkv, s, cases, tag=" wide D", generator=wide)
            for h, hkv in WIDE_DECODE_HEADS:
                decode(dtype, d, h, hkv, ODD_DECODE_LEN, tag=" wide D", generator=wide)
            decode(dtype, d, 32, 4, 64, tag=" wide D", generator=wide)  # one chunk
    # decode_wide at every geometry of its plan (a generator of its own,
    # SEED + 5): chunks of 512 rows, lengths about its k and v tiles' and
    # the chunk's edges
    wide_geo = torch.Generator(device=dev).manual_seed(SEED + 5)
    wide_kernels = []  # (the kernel the wrapper names, a launch of it) a (dtype, D)
    for dtype in (torch.float32, torch.bfloat16, f16):
        kr, vr = decode_ops.wide_tile_rows(dtype)
        for d in WIDE_DIMS + (WIDE_ODD_DIM,):
            for h, hkv in WIDE_DECODE_GROUPS:
                decode(dtype, d, h, hkv, DECODE_LEN, tag=" wide D geometry", generator=wide_geo,
                       lens_of=lambda chunk: ([0, 1, kr - 1, kr + 1],
                                              [vr + 1, chunk + 1, DECODE_LEN - 1, DECODE_LEN]))
            q = randn(4, 32, d, dtype=dtype, generator=wide_geo)
            k, v = (randn(4, 4, 256, d, dtype=dtype, generator=wide_geo) for _ in range(2))
            lens = torch.full((4,), 256, dtype=torch.int32, device=dev)
            wide_kernels.append((decode_ops.decode_kernel(dtype, 8, d),
                                 lambda q=q, k=k, v=v, lens=lens:
                                 decode_ops.decode_attention(q, k, v, lens)))
    check(flash_ops.LAUNCHES + decode_ops.LAUNCHES - sum(launched) == 2 * (n - n_before),
          "a case above head dim 256 did not launch its kernel twice")
    check_launched(torch, wide_kernels, failures, kind="decode_wide")
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = before[:2]

    # fused_filter_agg above 1024 groups over Q2's rows
    keys_q2, vals_q2, filt_q2 = inputs
    rows = keys_q2.shape[0]
    vals_f = torch.randn(rows, generator=gen, device=dev)
    for G in MANY_GROUPS:
        drawn = torch.randint(-1, G + 1, (rows,), generator=gen, device=dev, dtype=torch.int32)
        for kname, keys in (("Q2's keys", keys_q2), ("keys over [-1, G]", drawn)):
            for vname, vals in (("Q2's values", vals_q2), ("float values", vals_f)):
                n += 1
                name = f"fused_filter_agg G={G} {kname}, {vname}, n={rows}"
                kw = dict(op="ge", threshold=0.5, num_groups=G)
                s_k, c_k = ffa_ops.fused_filter_agg(keys, vals, filt_q2, **kw)
                s_k2, c_k2 = ffa_ops.fused_filter_agg(keys, vals, filt_q2, **kw)
                torch.cuda.synchronize()
                s_p, c_p = ffa_ref.fused_filter_agg_ref(keys, vals, filt_q2, **kw)
                keep = (filt_q2 >= 0.5) & (keys >= 0) & (keys < G)
                idx = keys[keep].long()
                f64 = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(
                    0, idx, vals[keep].double())
                a64 = torch.zeros(G, dtype=torch.float64, device=dev).index_add_(
                    0, idx, vals[keep].double().abs())
                c64 = torch.bincount(idx, minlength=G)
                worst[("fused_filter_agg", torch.float32)] = max(
                    worst.get(("fused_filter_agg", torch.float32), 0.0),
                    float((s_k - s_p).abs().max()))
                if not (torch.equal(c_k, c_p) and torch.equal(c_k.long(), c64)):
                    failures.append(f"{name}: counts")
                elif not bool(((s_k.double() - f64).abs() <= 1e-5 * a64).all()):
                    failures.append(f"{name}: float sums vs float64")
                elif vals.dtype == torch.int32 and not torch.equal(s_k.long(), f64.long()):
                    failures.append(f"{name}: integer sums not exact")
                elif not (bitwise_equal(torch, s_k, s_k2) and torch.equal(c_k, c_k2)):
                    failures.append(f"{name}: repeat launch not bitwise equal")
    ffa_ops.LAUNCHES = before[2]  # comparisons are not the main path
    print(f"domain vs plain: {n} cases, {len(failures)} failed; rules by kernel: "
          + "; ".join(f"{k} {v}" for k, v in sorted(rules.items()))
          + "; max |kernel - plain|: "
          + ", ".join(f"{k} {name_of(dt)} {v!r}" for (k, dt), v in worst.items()))
    for f in failures:
        print(f"domain vs plain FAILED: {f}")
    check(not failures, f"{len(failures)} of {n} domain cases failed (listed above)")


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
    kernels = device_rows(prof)
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
    busy share of the wall time and the flash kernels' device ms and
    launches in that forward (None, None, 0 when no device time was
    recorded)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model(tokens, patch_embeds=patches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = device_rows(prof)
    if not kernels:
        print(f"{what}profile: forward wall {wall!r} s; the profiler recorded no device time "
              f"(device busy share not measured)")
        return None, None, 0
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{what}profile, kernel route forward: wall {wall!r} s, device busy {busy!r} s "
          f"({busy / wall:.3f} of wall, idle {1 - busy / wall:.3f}), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:.3f} ms {e.count}x {e.key[:90]}")
    flash = [e for e in kernels if "flash_wgmma" in e.key or "flash_tf32" in e.key]
    return (busy / wall, sum(e.self_device_time_total for e in flash) / 1e3,
            sum(e.count for e in flash))


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
                      profile, tol=LOGIT_TOL, mean_tol=LOGIT_MEAN_TOL):
    """Serve ``model`` (``use_flash_kernel=True``) on its kernel route,
    then the same weights on the reference route, and hold the two to
    each other (phase 6's checks; logits within ``tol`` largest and
    ``mean_tol`` mean, a near tie a top-2 margin within ``tol``).  The
    launch counts start at 0 just before the kernel route's requests:
    decode_attention must launch n_layers times a decode step,
    flash_attention n_layers times in one forward.  ``what`` prefixes the
    printed lines; ``profile`` adds a profile of PROFILE_STEPS decode
    steps."""
    from repro_torch.models import LM, attention
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
    rope_before = dict(attention.ROPE_CALLS)
    logits_k, fwd_k = forward(model)
    flash_launches = flash_ops.LAUNCHES
    rope_calls = {path: n - rope_before[path] for path, n in attention.ROPE_CALLS.items()}
    check(flash_launches == cfg.n_layers,
          f"{what}flash_attention launched {flash_launches} times")
    check(decode_ops.LAUNCHES == decode_launches, f"{what}forward launched decode_attention")
    check(rope_calls == {"three_pass": cfg.n_layers, "autograd": 0},
          f"{what}the forward's RoPE calls by path: {rope_calls}")
    print(f"{what}main path: decode_attention launches {decode_launches} "
          f"({cfg.n_layers} x {len(steps_k)} steps), flash_attention launches {flash_launches}, "
          f"RoPE calls by path {rope_calls}")
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
    check_logits(torch, f"{what}forward", logits_k.float(), logits_r.float(), tol, mean_tol)
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
                 tf_k[valid], tf_r[valid], tol, mean_tol)

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
                check(margin <= tol, f"{what}request {i}: tokens differ at margin {margin}")
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
          f"{cdiff!r} (limit {tol})")
    check(cdiff <= tol, f"{what}decode logits differ from forward logits")
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


# -------------------------------------------------------------- phase 6h
def serve_yi_float32(np, torch, flash_ops, decode_ops, smi):
    """Yi-6B at full width (32/4 heads of 128, d_model 4096, d_ff 11008,
    the full vocabulary) and CUT_LAYERS layers, with ``compute_dtype``
    float32 (float32 weights; TF32 off for the GEMMs) and random weights
    from a seeded generator: phase 6's requests over 4 slots of 4096
    positions and one FORWARD_LEN-token forward on both routes
    (``serve_both_routes``), the launch counts set to 0 just before the
    kernel route's requests: decode_attention (``decode_split<f32, 128>``)
    CUT_LAYERS times a decode step, flash_attention (``flash_tf32<f32,
    128>``) CUT_LAYERS times a forward.  Both routes compute in float32, so
    they differ only in the order of sums and the kernel's split-TF32
    residue: logits within LOGIT_TOL / 100 (largest) and LOGIT_MEAN_TOL /
    100 (mean), greedy tokens equal up to the first near tie (a top-2 margin
    within LOGIT_TOL / 100), the kernel route's decode logits equal to its
    forward's within LOGIT_TOL / 100.  Then one kernel-route forward under
    the profiler: the device's busy share and flash_tf32's device ms."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("yi-6b")
    cfg = dataclasses.replace(base, n_layers=CUT_LAYERS,
                              segments=((base.segments[0][0], CUT_LAYERS),),
                              compute_dtype=torch.float32, use_flash_kernel=True)
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    group = cfg.n_heads // cfg.n_kv_heads
    print(f"yi-6b float32 (phase 6h): d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, {cfg.n_layers} of {base.n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {weights} B of weights "
          f"(compute dtype {cfg.compute_dtype}), init in {time.perf_counter() - t0:.2f} s; "
          f"flash kernel {flash_ops.kernel_name(cfg.compute_dtype, cfg.head_dim)}, decode "
          f"kernel {decode_ops.decode_kernel(cfg.compute_dtype, group, cfg.head_dim)} [{smi}]")
    prompts, long_prompt = yi_requests(np, torch, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    out = serve_both_routes(np, torch, flash_ops, decode_ops, model, prompts, long_prompt,
                            what="yi-6b float32: ", profile=True, tol=LOGIT_TOL / 100,
                            mean_tol=LOGIT_MEAN_TOL / 100)
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    busy, flash_ms, flash_n = profile_forward(torch, model, long_prompt, None,
                                              "yi-6b float32: ")
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts  # the profile is not the main path
    print(f"yi-6b float32 (phase 6h): forward busy share {busy!r}; flash_tf32 in the forward "
          f"profile {flash_ms!r} ms in {flash_n} launches; decode step median "
          f"{out['decode_step_s']!r} s [{smi}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "n_layers": CUT_LAYERS, "forward_busy_share": busy,
            "forward_profile_flash_ms": flash_ms, "forward_profile_flash_launches": flash_n}


# -------------------------------------------------------------- phase 6i
#: phase 6i: Yi-6B in float16 at full width; its depth (the full 32 layers
#: unless the run's time or the logits' range forces a cut)
F16_LAYERS = 32


def serve_yi_float16(np, torch, flash_ops, decode_ops, smi):
    """Yi-6B at full width (32/4 heads of 128, d_model 4096, d_ff 11008,
    the full vocabulary) and F16_LAYERS layers with ``compute_dtype``
    float16 (the weights held in float16, as they are held in bf16 in
    phase 6; Llama-2's published checkpoints are float16) and
    random weights from a seeded generator: phase 6's requests over 4 slots
    of 4096 positions and one FORWARD_LEN-token forward on both routes
    (``serve_both_routes``), the launch counts set to 0 just before the
    kernel route's requests: decode_attention (``decode_split<f16, 128>``)
    F16_LAYERS times a decode step, flash_attention (``flash_wgmma<f16,
    128>``) F16_LAYERS times a forward.  Both routes round where phase 6's
    do, in float16 where phase 6 rounds to bf16 (3 more mantissa bits), so
    phase 6's limits hold them: logits within LOGIT_TOL (largest) and
    LOGIT_MEAN_TOL (mean), greedy tokens equal up to the first near tie,
    the kernel route's decode logits equal to its forward's within
    LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("yi-6b")
    cfg = dataclasses.replace(base, n_layers=F16_LAYERS,
                              segments=((base.segments[0][0], F16_LAYERS),),
                              compute_dtype=torch.float16, use_flash_kernel=True)
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    group = cfg.n_heads // cfg.n_kv_heads
    flash_label = flash_ops.kernel_label(cfg.compute_dtype, cfg.head_dim)
    decode_label = decode_ops.decode_kernel(cfg.compute_dtype, group, cfg.head_dim)
    print(f"yi-6b float16 (phase 6i): d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads of {cfg.head_dim}, {cfg.n_layers} of {base.n_layers} layers, "
          f"{sum(p.numel() for p in model.parameters())} parameters, {weights} B of weights "
          f"(compute dtype {cfg.compute_dtype}), init in "
          f"{time.perf_counter() - t0:.2f} s; flash kernel {flash_label}, decode kernel "
          f"{decode_label} [{smi}]")
    check(flash_label == "flash_wgmma<f16, 128>" and decode_label == "decode_split<f16, 128>",
          f"phase 6i runs {flash_label} and {decode_label}")
    prompts, long_prompt = yi_requests(np, torch, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve_both_routes(np, torch, flash_ops, decode_ops, model, prompts, long_prompt,
                            what="yi-6b float16: ", profile=False)
    print(f"yi-6b float16 (phase 6i): decode step median {out['decode_step_s']!r} s, both "
          f"routes and their checks in {time.perf_counter() - t0!r} s [{smi}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "n_layers": F16_LAYERS}


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
            "init_peak_bytes": init_peak, "weights_bytes": weights, "forward_s": fwd_s,
            "forward_peak_bytes": fwd_peak}


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
        kernels = device_rows(prof)
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
    runs dispatch every token alike; a forced call whose record has
    ``keep`` (B, S, k) also weighs the assignments the other run dropped
    at capacity 0, so it combines what that run combined.  Comparison only: nothing here is on
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
                f = next(forced)
                top_e = f["top_e"]
                top_p = torch.gather(probs, -1, top_e)
                if cfg.norm_topk:
                    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
                if "keep" in f:  # the other run's dropped assignments weigh 0
                    top_p = top_p * f["keep"]
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
                                                            FAMILY_NEW_TOKENS)
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
    fwd_busy, fwd_flash_ms, fwd_flash_n = profile_forward(torch, model, tokens, patches,
                                                          what=f"{arch} ")
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
                                                            prompts, FAMILY_NEW_TOKENS)
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
            "forward_profile_flash_ms": fwd_flash_ms, "forward_profile_flash_launches": fwd_flash_n,
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
      requests of FAMILY_NEW_TOKENS over 4 slots of 4096, decode_attention 24
      launches a step; then one FORWARD_LEN-token ``LM.forward``,
      flash_attention 24 launches, and the share of routed assignments
      dropped at capacity (int(2048 * 4 / 60 * 1.25) = 170 slots an
      expert for a mean of 136.5);
    * internvl2-2b (24 layers, 16/8 heads of 128): the same requests,
      text only, as the JAX engine serves it; the forward on 256 seeded
      patch embeddings (bf16, ``make_batch``) and 1792 text tokens;
    * musicgen-medium (48 layers, 24/24 heads of 64 on ``flash_wgmma<64>``):
      ``ServeEngine`` must raise NotImplementedError, as the JAX
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


# -------------------------------------------------------------- phase 6f
def serve_recurrentgemma(np, torch, flash_ops, decode_ops, smi):
    """Phase 6f: recurrentgemma-9b (``(rec, rec, attn_geglu) x 12 + (rec,
    rec)``: 26 RG-LRU blocks and 12 local-attention blocks of 16/1 heads
    of 256, window 2048) at full width and full depth on ``cuda``, random
    weights from a seeded generator, TF32 off (phase 6 set it): 9.40 B
    parameters, nothing cut.  The init's time and peak, then the main path
    with the launch counts set to 0 just before it: ``ServeEngine.generate``
    on HYBRID_REQUESTS requests of HYBRID_PROMPT_LEN prompt tokens and
    HYBRID_NEW_TOKENS new ones over one slot of 4096 positions (the engine
    refuses more slots for recurrent kinds, as the JAX engine does),
    decode_attention exactly 12 launches a step and flash_attention none;
    then one ``LM.forward`` of HYBRID_FORWARD_LEN positions, where the
    window masks keys, flash_attention exactly 12 launches.  The forward's
    time (median of FORWARD_REPS after the first), its peak, a profile of
    one forward (device busy time, flash time) and of PROFILE_STEPS decode
    steps (busy share, launches a step), the median decode step and
    tokens/s are printed with the card's name and power limit.

    The reference route serves the same weights and the two routes are
    held to phase 6's limits (LOGIT_TOL, LOGIT_MEAN_TOL): forward logits at
    all 4096 positions, and decode logits teacher-forced on the kernel
    route's sequences.  The served lengths stay below the window, so the
    decode kernel branch (which has no window, as in the JAX package)
    computes the reference branch's function; greedy tokens are equal up
    to a request's first near tie.  Decode against forward: the
    reference's own arithmetic parts them (the forward rounds each rec
    block's conv output to bf16, decode does not), so the kernel route's
    gap must be within the reference route's plus LOGIT_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig

    t_phase = time.perf_counter()
    arch = HYBRID_ARCH
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    n_attn = sum(kind == "attn_geglu" for unit, count in cfg.segments for kind in unit * count)
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
    check(n_params == 9_396_088_832, f"{arch}: {n_params} parameters")
    kernel = flash_ops.kernel_name(cfg.compute_dtype, cfg.head_dim)
    print(f"{arch}: {cfg.n_layers} layers ({n_attn} attention), d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} ({kernel}), window "
          f"{cfg.window}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters, {weights} B "
          f"of weights; init on the card in {init_s!r} s, init peak {init_peak} B "
          f"({init_peak / 2**30:.2f} GiB; weights + {(init_peak - weights) / 2**30:.2f} GiB) "
          f"[{smi}]")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, HYBRID_PROMPT_LEN).astype(np.int32)
               for _ in range(HYBRID_REQUESTS)]
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (1, HYBRID_FORWARD_LEN)).astype(np.int32),
                          device=dev)
    scfg = ServeConfig(max_batch=1, max_len=4096)

    # the main path of this config: the counts start at 0 here
    flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
    engine, reqs_k, steps, lat_k, wall = serve_requests(torch, model, None, scfg, prompts,
                                                        HYBRID_NEW_TOKENS)
    final_lengths = engine.lengths.copy()
    del engine
    decode_launches = decode_ops.LAUNCHES
    check(decode_launches == n_attn * len(steps),
          f"{arch}: decode_attention launched {decode_launches} times in {len(steps)} steps")
    check(flash_ops.LAUNCHES == 0, f"{arch}: generate launched flash_attention")
    check(int(final_lengths.max()) < cfg.window, f"{arch}: served past the window")
    torch.cuda.reset_peak_memory_stats()
    logits_k = model(tokens)
    torch.cuda.synchronize()
    flash_launches = flash_ops.LAUNCHES
    check(flash_launches == n_attn,
          f"{arch}: flash_attention launched {flash_launches} times in one forward")
    check(decode_ops.LAUNCHES == decode_launches, f"{arch}: the forward launched decode_attention")
    check(tuple(logits_k.shape) == (1, HYBRID_FORWARD_LEN, cfg.vocab)
          and bool(torch.isfinite(logits_k).all()),
          f"{arch}: forward logits {tuple(logits_k.shape)} not finite of shape "
          f"(1, {HYBRID_FORWARD_LEN}, {cfg.vocab})")
    n_tokens = sum(len(r.generated) for r in reqs_k)
    print(f"{arch} main path: decode_attention launches {decode_launches} ({n_attn} x "
          f"{len(steps)} steps), flash_attention launches {flash_launches} (one forward of "
          f"{HYBRID_FORWARD_LEN} positions, window {cfg.window})")

    # timing: forwards (median of FORWARD_REPS after the first), profiles
    times = []
    for _ in range(FORWARD_REPS):
        t1 = time.perf_counter()
        model(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    fwd_peak = torch.cuda.max_memory_allocated() - held
    fwd_s = statistics.median(times)
    fwd_busy, fwd_flash_ms, fwd_flash_n = profile_forward(torch, model, tokens, None,
                                                          what=f"{arch} ")
    busy = profile_decode(torch, model, final_lengths, scfg.max_len, what=f"{arch} ")
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = flash_launches, decode_launches
    step_s = statistics.median(steps)
    print(f"{arch}: forward of {HYBRID_FORWARD_LEN} positions median of {FORWARD_REPS} after "
          f"the first {fwd_s!r} s (each {times!r}), peak device memory {fwd_peak} B "
          f"({fwd_peak / 2**30:.2f} GiB); {HYBRID_REQUESTS} requests, {len(steps)} decode steps, "
          f"{n_tokens} tokens in {wall!r} s ({n_tokens / wall!r} tokens/s), decode step median "
          f"{step_s!r} s (min {min(steps)!r}, max {max(steps)!r}); busy share over "
          f"{PROFILE_STEPS} profiled steps {busy!r}; per-request latency from submission (s) "
          f"{lat_k!r} [{smi}]")

    # the reference route, on the same weights (assigned, not copied)
    ref_model = LM(dataclasses.replace(cfg, use_flash_kernel=False))
    ref_model.load_state_dict(model.state_dict(), assign=True)
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    logits_r = ref_model(tokens)
    engine, reqs_r, steps_r, _, wall_r = serve_requests(torch, ref_model, None, scfg, prompts,
                                                        HYBRID_NEW_TOKENS)
    del engine
    check((flash_ops.LAUNCHES, decode_ops.LAUNCHES) == counts,
          f"{arch}: the reference route launched a kernel")
    print(f"{arch} reference route: decode step median {statistics.median(steps_r)!r} s, "
          f"{sum(len(r.generated) for r in reqs_r) / wall_r!r} tokens/s")
    check(bool(torch.isfinite(logits_r).all()), f"{arch}: reference forward logits not finite")
    check_logits(torch, f"{arch} forward of {HYBRID_FORWARD_LEN} positions", logits_k.float(),
                 logits_r.float())
    del logits_k, logits_r

    toks, valid, seqs = padded_sequences(np, torch, reqs_k)
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    tf_k = teacher_forced(torch, model, toks, scfg.max_len)
    tf_r = teacher_forced(torch, ref_model, toks, scfg.max_len)
    check(bool(torch.isfinite(tf_k[valid]).all() and torch.isfinite(tf_r[valid]).all()),
          f"{arch}: teacher-forced logits not finite")
    check_logits(torch, f"{arch} decode, teacher-forced on {int(valid.sum())} positions,",
                 tf_k[valid], tf_r[valid])
    same = 0
    for i, (rk, rr) in enumerate(zip(reqs_k, reqs_r)):
        p_len = len(rk.prompt)
        for j, (a, b) in enumerate(zip(rk.generated, rr.generated)):
            if a != b:
                top2 = torch.topk(tf_r[i, p_len + j - 1], 2).values
                margin = float(top2[0] - top2[1])
                print(f"{arch} request {i}: routes part at new token {j} ({a} vs {b}), "
                      f"reference top-2 margin {margin!r}")
                check(margin <= LOGIT_TOL, f"{arch} request {i}: tokens differ at margin {margin}")
                break
            same += 1
    print(f"{arch} greedy tokens: {same} of {n_tokens} equal between the routes before any "
          f"near tie")
    # decode against forward, on each route: a rec block's forward rounds
    # its conv output to bf16 and its decode step does not, and the scan
    # and the step add in other orders (as in the JAX package, whose own
    # test holds this config's decode to its forward at 5x the tolerance of
    # the attention configs), so the reference route's own gap is the
    # yardstick: the kernel route's within it plus LOGIT_TOL
    x = seqs[0]
    xt = torch.tensor(x[None], device=dev)
    full = model(xt)[0].float()
    cdiff = float((full - tf_k[0, :len(x)]).abs().max())
    rdiff = float((ref_model(xt)[0].float() - tf_r[0, :len(x)]).abs().max())
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts  # comparisons, not the main path
    print(f"{arch} decode vs forward on request 0 ({len(x)} tokens): max |diff| kernel route "
          f"{cdiff!r}, reference route {rdiff!r} (limit: the reference's + {LOGIT_TOL})")
    check(cdiff <= rdiff + LOGIT_TOL,
          f"{arch}: the kernel route's decode logits differ from its forward logits by more "
          f"than the reference route's")
    del model, ref_model, tf_k, tf_r, full
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"phase 6f ({arch}): {seconds!r} s [{smi}]")
    return {"decode_launches": decode_launches, "flash_launches": flash_launches,
            "decode_steps": len(steps), "n_layers": cfg.n_layers, "n_attention_layers": n_attn,
            "final_lengths": final_lengths, "init_s": init_s, "init_peak_bytes": init_peak,
            "forward_s": fwd_s, "forward_peak_bytes": fwd_peak, "decode_step_s": step_s,
            "tokens_per_s": n_tokens / wall, "busy_share": busy, "forward_busy_share": fwd_busy,
            "forward_profile_flash_ms": fwd_flash_ms,
            "forward_profile_flash_launches": fwd_flash_n, "seconds": seconds}


# -------------------------------------------------------------- phase 6g
def device_profile(torch, fn):
    """torch.profiler over one call of ``fn``, the host's and the device's
    activity as the other profiles here: (profiled wall s, device busy s
    or None, kernel launches, the kernels by device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = device_rows(prof)
    if not kernels:
        return wall, None, 0, []
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    return (wall, busy, sum(e.count for e in kernels),
            sorted(kernels, key=lambda e: -e.self_device_time_total))


def relative_limits(ref):
    """Phase 6g's stated bf16 limits for a layer's output whose largest
    magnitude is ``max|ref|``: 4 bf16 ulps of it (the max) and half an ulp
    (the mean)."""
    ulp = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
    return 4 * ulp, ulp / 2


def check_pair(what, got, want, tol, mean_tol):
    diff = (got.float() - want.float()).abs()
    print(f"{what}: max |diff| {float(diff.max())!r}, mean {float(diff.mean())!r} (limits "
          f"{tol!r}, {mean_tol!r}); max |reference| {float(want.float().abs().max())!r}")
    check(float(diff.max()) <= tol and float(diff.mean()) <= mean_tol, what)


def init_on_card(torch, cfg, arch, expect_params, smi):
    """``LM(cfg).init`` from SEED on the card: (model, init s, init peak B
    above what was held, weights B)."""
    from repro_torch.models import LM

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg).init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - held
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    check(n_params == expect_params, f"{arch}: {n_params} parameters")
    print(f"{arch}: {cfg.n_layers} layers {cfg.segments}, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab}; {n_params} parameters, {weights} B of "
          f"weights; init on the card in {init_s!r} s, init peak {init_peak} B "
          f"({init_peak / 2**30:.2f} GiB; weights + {(init_peak - weights) / 2**30:.2f} GiB) "
          f"[{smi}]")
    return model, init_s, init_peak, weights


def serve_and_forward(np, torch, flash_ops, decode_ops, model, arch, scfg, prompts, new_tokens,
                      tokens, smi, reps=FORWARD_REPS):
    """The main path of a phase 6g config, with the launch counts set to 0
    just before it: ``ServeEngine.generate`` on ``prompts``, then one
    ``LM.forward`` of ``tokens``; neither reaches an attention kernel.
    Then the forward's time (median of ``reps`` after the first) and
    peak, the decode step's median and tokens/s.  Returns the numbers and
    the main path's outputs."""
    counts = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    flash_ops.LAUNCHES = decode_ops.LAUNCHES = 0
    engine, reqs, steps, lat, wall = serve_requests(torch, model, None, scfg, prompts,
                                                    new_tokens)
    final_lengths = engine.lengths.copy()
    del engine
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    logits = model(tokens)
    torch.cuda.synchronize()
    check((flash_ops.LAUNCHES, decode_ops.LAUNCHES) == (0, 0),
          f"{arch}: the path launched an attention kernel")
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = counts
    check(tuple(logits.shape) == (1, tokens.shape[1], model.cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{arch}: forward logits {tuple(logits.shape)} not finite of shape "
          f"(1, {tokens.shape[1]}, {model.cfg.vocab})")
    del logits
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        model(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    fwd_peak = torch.cuda.max_memory_allocated() - held
    n_tokens = sum(len(r.generated) for r in reqs)
    out = {"forward_s": statistics.median(times), "forward_times": times,
           "forward_peak_bytes": fwd_peak, "decode_step_s": statistics.median(steps),
           "decode_steps": len(steps), "tokens_per_s": n_tokens / wall,
           "final_lengths": [int(x) for x in final_lengths], "n_layers": model.cfg.n_layers}
    print(f"{arch} main path: no attention kernel launched; {len(prompts)} requests, "
          f"{len(steps)} decode steps, {n_tokens} tokens in {wall!r} s "
          f"({n_tokens / wall!r} tokens/s), decode step median {out['decode_step_s']!r} s "
          f"(min {min(steps)!r}, max {max(steps)!r}); per-request latency (s) {lat!r}; forward "
          f"of {tokens.shape[1]} positions median of {reps} after the first "
          f"{out['forward_s']!r} s (each {times!r}), peak {fwd_peak} B "
          f"({fwd_peak / 2**30:.2f} GiB above the weights) [{smi}]")
    return out, reqs


def serve_xlstm(np, torch, flash_ops, decode_ops, smi):
    """Phase 6g, first config; see ``serve_xlstm_deepseek``."""
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.serve import ServeConfig

    t_arch = time.perf_counter()
    arch = XLSTM_ARCH
    cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
    model, init_s, init_peak, weights = init_on_card(torch, cfg, arch, 429_245_440, smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, HYBRID_PROMPT_LEN).astype(np.int32)
               for _ in range(HYBRID_REQUESTS)]
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (1, FORWARD_LEN)).astype(np.int32),
                          device=dev)
    scfg = ServeConfig(max_batch=1, max_len=4096)  # one slot: the recurrent kinds' rule
    out, reqs = serve_and_forward(np, torch, flash_ops, decode_ops, model, arch, scfg, prompts,
                                  XLSTM_NEW_TOKENS, tokens, smi, reps=XLSTM_FORWARD_REPS)

    # profiles of the forward's blocks over the same positions, one of each
    # kind (every block of a kind does the same work).  A profile of the
    # whole forward (559,093 kernels) took 126 s to read back on an H100,
    # so the forward's launches and busy time are the blocks' sums, times
    # their counts; the embedding, final norm and head add 11 launches (a
    # profile that small recorded no device time after the earlier phases)
    positions = torch.arange(FORWARD_LEN, device=dev)
    h = model._embed_tokens(model._modules, tokens)
    parts = {"mlstm": lambda: model._apply_block("mlstm", model.blocks[0], h, positions),
             "slstm": lambda: model._apply_block("slstm", model.blocks[1], h, positions)}
    counts = {kind: sum(k == kind for unit, n in cfg.segments for k in unit * n)
              for kind in parts}
    prof = {}
    for name, fn in parts.items():
        fn()  # a warm-up call, as profile_decode makes
        prof[name] = device_profile(torch, fn)
        wall, pbusy, n, _ = prof[name]
        print(f"{arch} profile of {name} over {FORWARD_LEN} positions: "
              + (f"{n} kernel launches, device busy {pbusy!r} s, wall {wall!r} s"
                 if pbusy is not None else "the profiler recorded no device time"))
    launches = sum(counts[n] * prof[n][2] for n in parts)
    measured = all(prof[n][1] is not None for n in parts)
    busy = sum(counts[n] * prof[n][1] for n in parts) if measured else None
    slstm_share = counts["slstm"] * prof["slstm"][2] / launches if measured else None
    if busy is None:
        print(f"{arch} profile: a part recorded no device time (the forward's busy share not "
              f"measured)")
    else:
        print(f"{arch} profile, forward of {FORWARD_LEN} positions from its blocks ("
              f"{counts['mlstm']} mLSTM, {counts['slstm']} sLSTM): "
              f"{launches} kernel launches, device busy {busy!r} s "
              f"({busy / out['forward_s']:.3f} of the median forward); the sLSTM blocks' share "
              f"of the launches {slstm_share!r} [{smi}]")
        for e in prof["slstm"][3][:6]:
            print(f"  sLSTM block: {e.self_device_time_total / 1e3:.3f} ms {e.count}x "
                  f"{e.key[:80]}")
    decode_busy = profile_decode(torch, model, out["final_lengths"], scfg.max_len,
                                 what=f"{arch} ")

    # the card against the CPU, the same weights (as served, through
    # bf16), in float32 compute (the algorithm) and in bf16 (as served),
    # the forward and the teacher-forced decode; the rule for each is in
    # serve_xlstm_deepseek's docstring
    x = np.concatenate([reqs[0].prompt, np.array(reqs[0].generated, np.int32)])
    seq = np.resize(x, CPU_CHECK_LEN)[None].astype(np.int32)  # the served request, repeated
    tree = params_to_numpy(model)
    seq_card, seq_cpu = torch.tensor(seq, device=dev), torch.tensor(seq)
    logits = {}
    for dt in (torch.float32, torch.bfloat16):
        dcfg = dataclasses.replace(cfg, compute_dtype=dt)
        card = model if dt == cfg.compute_dtype else params_from_numpy(tree, dcfg, device=dev)
        cpu = params_from_numpy(tree, dcfg, device="cpu")
        logits[dt] = {
            "card": (card(seq_card)[0].float().cpu(),
                     teacher_forced(torch, card, seq_card, CPU_CHECK_LEN)[0].cpu()),
            "cpu": (cpu(seq_cpu)[0].float(),
                    teacher_forced(torch, cpu, seq_cpu, CPU_CHECK_LEN)[0])}
        del card, cpu
    (f32_card, tf32_card), (f32_cpu, tf32_cpu) = logits[torch.float32].values()
    (bf_card, tfbf_card), (bf_cpu, tfbf_cpu) = logits[torch.bfloat16].values()
    check_pair(f"{arch} forward of {CPU_CHECK_LEN} positions in float32, the card vs the CPU",
               f32_card, f32_cpu, LOGIT_TOL, LOGIT_MEAN_TOL)
    gap_card, gap_cpu = (tf32_card - f32_card).abs(), (tf32_cpu - f32_cpu).abs()
    print(f"{arch} decode vs forward over {CPU_CHECK_LEN} positions in float32: the card max "
          f"|diff| {float(gap_card.max())!r}, mean {float(gap_card.mean())!r}; the CPU max "
          f"{float(gap_cpu.max())!r}, mean {float(gap_cpu.mean())!r} (limits the CPU's + "
          f"{LOGIT_TOL}, mean + {LOGIT_MEAN_TOL})")
    check(float(gap_card.max()) <= float(gap_cpu.max()) + LOGIT_TOL
          and float(gap_card.mean()) <= float(gap_cpu.mean()) + LOGIT_MEAN_TOL,
          f"{arch}: decode vs forward in float32 on the card beyond the CPU's gap")
    print(f"{arch} in bfloat16, the card vs the CPU directly: max |diff| "
          f"{float((bf_card - bf_cpu).abs().max())!r}, mean "
          f"{float((bf_card - bf_cpu).abs().mean())!r} (not a check: see the docstring)")
    for what, card_out, cpu_out in (("forward", bf_card, bf_cpu),
                                    ("teacher-forced decode", tfbf_card, tfbf_cpu)):
        d_card, d_cpu = (card_out - f32_cpu).abs(), (cpu_out - f32_cpu).abs()
        tol = 1.5 * float(d_cpu.max()) + LOGIT_TOL
        mean_tol = 1.5 * float(d_cpu.mean()) + LOGIT_MEAN_TOL
        print(f"{arch} bfloat16 {what} against the float32 forward: the card max |diff| "
              f"{float(d_card.max())!r}, mean {float(d_card.mean())!r}; the CPU max "
              f"{float(d_cpu.max())!r}, mean {float(d_cpu.mean())!r} (limits 1.5 x the CPU's + "
              f"{LOGIT_TOL}: {tol!r}, mean {mean_tol!r})")
        check(float(d_card.max()) <= tol and float(d_card.mean()) <= mean_tol,
              f"{arch}: bfloat16 {what} on the card farther from float32 than the CPU's")
    gaps = {"float32": (float(gap_card.max()), float(gap_cpu.max())),
            "bfloat16": (float((tfbf_card - bf_card).abs().max()),
                         float((tfbf_cpu - bf_cpu).abs().max()))}
    del model
    seconds = time.perf_counter() - t_arch
    print(f"phase 6g ({arch}): {seconds!r} s [{smi}]")
    return {**out, "init_s": init_s, "init_peak_bytes": init_peak, "weights_bytes": weights,
            "forward_busy_s": busy, "forward_launches": launches,
            "slstm_launch_share": slstm_share, "decode_busy_share": decode_busy,
            "decode_vs_forward": gaps, "seconds": seconds}


def serve_deepseek(np, torch, flash_ops, decode_ops, smi):
    """Phase 6g, second config; see ``serve_xlstm_deepseek``."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import rmsnorm
    from repro_torch.serve import ServeConfig

    t_arch = time.perf_counter()
    arch = MLA_ARCH
    base = get_config(arch)
    dense, moe = MLA_LAYERS
    cfg = dataclasses.replace(base, n_layers=dense + moe, use_flash_kernel=True,
                              segments=((("mla_dense",), dense), (("mla_moe",), moe)))
    model, init_s, init_peak, weights = init_on_card(torch, cfg, arch, 15_797_352_448, smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(8, 33))).astype(np.int32)
               for _ in range(CUT_REQUESTS)]
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (1, FORWARD_LEN)).astype(np.int32),
                          device=dev)
    scfg = ServeConfig(max_batch=4, max_len=4096)
    out, reqs = serve_and_forward(np, torch, flash_ops, decode_ops, model, arch, scfg, prompts,
                                  CUT_NEW_TOKENS, tokens, smi)
    fwd_busy, _, _ = profile_forward(torch, model, tokens, None, what=f"{arch} ")
    decode_busy = profile_decode(torch, model, out["final_lengths"], scfg.max_len,
                                 what=f"{arch} ")
    state = model.init_decode_state(scfg.max_batch, max_len=scfg.max_len)
    cache_bytes = sum(v.numel() * v.element_size() for seg in state.values()
                      for blk in seg.values() for v in blk.values())
    del state
    per_token = cache_bytes / (scfg.max_batch * scfg.max_len)
    mcfg = cfg.mla_config()
    per_head = cfg.n_layers * cfg.n_heads * (mcfg.qk_dim + mcfg.v_head_dim) * 2
    print(f"{arch} decode cache: {per_token!r} B a token over {cfg.n_layers} layers (c_kv "
          f"{mcfg.kv_lora_rank} + k_rope {mcfg.qk_rope_dim} in bf16 a layer); a per-head KV "
          f"cache of the same shape (k {cfg.n_heads} x {mcfg.qk_dim}, v {cfg.n_heads} x "
          f"{mcfg.v_head_dim} a layer) {per_head} B, {per_head / per_token!r}x more")

    # 1. the first layer's MLA: absorbed decode token by token against the
    # train path at the same positions, in float32 (the JAX test's rule)
    # and in bf16 (relative_limits)
    p = model.blocks[0]
    x = rmsnorm(p["norm1"], model._embed_tokens(model._modules, tokens[:, :MLA_CHECK_LEN]),
                eps=cfg.norm_eps)
    p32 = {k: {kk: vv.float() for kk, vv in v.items()} for k, v in p["attn"].items()}
    for dt, params in ((torch.float32, p32), (torch.bfloat16, p["attn"])):
        mc = dataclasses.replace(mcfg, compute_dtype=dt)
        xs = x.to(dt)
        train = mla_mod.mla_train(params, mc, xs, torch.arange(MLA_CHECK_LEN, device=dev))
        cache = mla_mod.init_mla_cache(mc, 1, MLA_CHECK_LEN, dtype=dt, device=dev)
        dec = torch.empty_like(train)
        for t in range(MLA_CHECK_LEN):
            step, cache = mla_mod.mla_decode_step(params, mc, xs[:, t:t + 1], cache,
                                                  torch.tensor([t], device=dev))
            dec[:, t] = step[:, 0]
        what = (f"{arch} layer 0 MLA, absorbed decode vs mla_train over {MLA_CHECK_LEN} "
                f"positions in {str(dt).split('.')[-1]}")
        if dt == torch.float32:
            excess = ((dec - train).abs() - (2e-4 * train.abs() + 2e-5)).max()
            print(f"{what}: max |diff| {float((dec - train).abs().max())!r}, largest excess "
                  f"over rtol 2e-4 / atol 2e-5 {float(excess)!r}")
            check(float(excess) <= 0, what)
        else:
            check_pair(what, dec, train, *relative_limits(train))
    # 2. mla_train with the chunk of 1024 against chunk=None at S = FORWARD_LEN
    x = rmsnorm(p["norm1"], model._embed_tokens(model._modules, tokens), eps=cfg.norm_eps)
    pos = torch.arange(FORWARD_LEN, device=dev)
    for dt, params in ((torch.float32, p32), (torch.bfloat16, p["attn"])):
        mc = dataclasses.replace(mcfg, compute_dtype=dt)
        chunked = mla_mod.mla_train(params, mc, x.to(dt), pos).float()
        dense_out = mla_mod.mla_train(params, dataclasses.replace(mc, chunk=None), x.to(dt),
                                      pos).float()
        what = (f"{arch} layer 0 MLA at S = {FORWARD_LEN}, chunk {mc.chunk} vs dense, in "
                f"{str(dt).split('.')[-1]}")
        if dt == torch.float32:
            excess = ((chunked - dense_out).abs() - (3e-3 * dense_out.abs() + 3e-3)).max()
            print(f"{what}: max |diff| {float((chunked - dense_out).abs().max())!r}, largest "
                  f"excess over rtol = atol = 3e-3 {float(excess)!r}")
            check(float(excess) <= 0, what)
        else:
            check_pair(what, chunked, dense_out, *relative_limits(dense_out))
    del p32, x, chunked, dense_out
    # 3. the whole model: DS_FORCED_LEN tokens teacher-forced through decode
    # against the forward; the forward's drops at capacity are counted
    seq = tokens[:, :DS_FORCED_LEN]
    with RouterRecord(torch, moe_mod) as rec_f:
        fwd = model(seq)[0].float()
    check(len(rec_f.calls) == moe, f"{arch}: {len(rec_f.calls)} MoE calls in the forward")
    cap = moe_mod.capacity(cfg.moe_config(), DS_FORCED_LEN)
    fwd_e = rec_f.calls[0]["top_e"]  # (1, S, k): the forward's one MoE call
    keep = torch.gather(rec_f.calls[0]["dispatched"], -1, fwd_e)  # (1, S, k)
    dropped = ~keep[0].all(-1)  # (S,): positions with an assignment dropped
    n_drop = int((~keep).sum())
    print(f"{arch} forward of {DS_FORCED_LEN} positions: capacity {cap} slots an expert, "
          f"{int(keep.sum())} of {keep.numel()} assignments dispatched ({n_drop} dropped, at "
          f"{int(dropped.sum())} positions {dropped.nonzero().flatten().tolist()})")
    with RouterRecord(torch, moe_mod) as rec_d:
        tf = teacher_forced(torch, model, seq, DS_FORCED_LEN)[0]
    dec_e = torch.cat([c["top_e"][0] for c in rec_d.calls])  # (S, k), a call a step
    tipped = (fwd_e[0].sort(-1).values != dec_e.sort(-1).values).any(-1)
    alike = ~tipped & ~dropped
    print(f"{arch} decode on its own router: {int(tipped.sum())} of {DS_FORCED_LEN} positions "
          f"routed to other experts than in the forward; {int(alike.sum())} positions routed "
          f"alike with nothing dropped")
    check(bool(alike.any()), f"{arch}: no position routed alike with nothing dropped")
    check_pair(f"{arch} decode vs forward at the {int(alike.sum())} positions routed alike "
               f"with nothing dropped", tf[alike], fwd[alike], LOGIT_TOL, LOGIT_MEAN_TOL)
    force = [{"top_e": fwd_e[:, t:t + 1], "keep": keep[:, t:t + 1].to(torch.float32)}
             for t in range(DS_FORCED_LEN)]
    with RouterRecord(torch, moe_mod, force=force):
        tf_forced = teacher_forced(torch, model, seq, DS_FORCED_LEN)[0]
    check_pair(f"{arch} decode on the forward's dispatch (its drops weighing 0) vs forward at "
               f"all {DS_FORCED_LEN} positions", tf_forced, fwd, LOGIT_TOL, LOGIT_MEAN_TOL)
    del model, fwd, tf, tf_forced
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_arch
    print(f"phase 6g ({arch}): {seconds!r} s [{smi}]")
    return {**out, "init_s": init_s, "init_peak_bytes": init_peak, "weights_bytes": weights,
            "forward_busy_share": fwd_busy, "decode_busy_share": decode_busy,
            "cache_bytes_per_token": per_token, "per_head_bytes_per_token": per_head,
            "tipped": int(tipped.sum()), "dropped": n_drop, "seconds": seconds}


def serve_xlstm_deepseek(np, torch, flash_ops, decode_ops, smi):
    """Phase 6g: xlstm-350m and deepseek-v3-671b on ``cuda``, one after
    the other, each freed before the next; random weights from a seeded
    generator, TF32 off (phase 6 set it).  Neither reaches an attention
    kernel (the xLSTM and MLA blocks are plain torch, as their JAX
    counterparts are ``lax.scan`` loops, not Pallas): the launch counts,
    set to 0 just before each main path, must stay 0.

    xlstm-350m (arXiv:2405.04517) at full width and depth, nothing cut: 24
    blocks, ``(mlstm, slstm) x 12``, d_model 1024, 4 heads, vocab 50304,
    tied embeddings, 429,245,440 parameters (float32 ``param_dtype``, the
    matmul weights served in bf16).  Main path: HYBRID_REQUESTS requests of
    HYBRID_PROMPT_LEN prompt tokens and XLSTM_NEW_TOKENS new ones through
    ``ServeEngine`` on one slot (the recurrent kinds' rule, as in the JAX
    engine), then one FORWARD_LEN-position ``LM.forward`` (32 mLSTM chunks
    and FORWARD_LEN sLSTM steps a layer).  Checks, over CPU_CHECK_LEN
    positions (the first request's tokens, repeated), against the same
    model on the CPU (``params_to_numpy`` -> ``params_from_numpy``, the
    served weights), in float32 compute and in bf16 (as served): the
    forward logits, and the teacher-forced decode against the forward on
    each device.  In float32 the card is held within LOGIT_TOL and
    LOGIT_MEAN_TOL of the CPU, and its decode-vs-forward gap within the
    CPU's plus LOGIT_TOL.  In bf16 this model at random weights amplifies
    a rounding difference about twofold an mLSTM block (on the CPU at
    full width and 8 layers, summing with one thread instead of 8 moves
    the logits by up to 0.43 in bf16 and 2.6e-4 in float32), so after 24
    blocks two orders of the same bf16 sums part by whole units (the card
    against the CPU: 2.89, mean 0.269, with their float32 logits 0.002
    apart).  There the rule is ``tests/test_torch_models.py``'s for bf16
    LMs: the card's bf16 forward, and its bf16 decode, no farther from
    the float32 forward than the CPU's, within 1.5 times it plus LOGIT_TOL
    (max) and LOGIT_MEAN_TOL (mean).

    deepseek-v3-671b (arXiv:2412.19437) at full width, MLA_LAYERS = the
    paper's 3 ``mla_dense`` layers and the first ``mla_moe`` layer, 4 of
    61: d_model 7168, 128 heads, q rank 1536, kv rank 512, nope 128, rope
    64, v 128, dense FFN 18432, 256 routed experts + 1 shared of 2048,
    top-8, vocab 129280, untied head, the MTP head built (read by
    ``LM.loss`` only): 15,797,352,448 parameters, 31.6 GB in bf16.  Depth
    is cut because 671 B parameters do not fit one card: each ``mla_moe``
    layer is 23 GB, and two would leave no room for the init's float32
    draws.  Main path: CUT_REQUESTS requests of CUT_NEW_TOKENS new tokens
    through ``ServeEngine`` on 4 slots (the MLA cache is gated by lengths
    like a KV cache), then one FORWARD_LEN-position ``LM.forward`` (MLA's
    chunked branch, chunk 1024).  Checks, limits stated before the first
    run: (1) the first layer's MLA, absorbed ``mla_decode_step`` token by
    token against ``mla_train`` over MLA_CHECK_LEN positions: in float32
    within the JAX test's rtol 2e-4 / atol 2e-5
    (``tests/test_mla.py``), in bf16 within ``relative_limits`` (4 bf16
    ulps of the largest output, the mean within half an ulp); (2)
    ``mla_train`` with the chunk of 1024 against ``chunk=None`` at S =
    FORWARD_LEN: in float32 within rtol = atol = 3e-3
    (``tests/test_chunked_attention.py``), in bf16 within
    ``relative_limits``; (3) the whole model, DS_FORCED_LEN tokens
    teacher-forced through ``decode_step`` against the forward.  The
    forward groups the 16 tokens with 4 slots an expert, and its random
    router sends more than 4 to some experts (16 of 128 assignments
    dropped on an H100 with these seeded weights), while decode routes
    each token alone and
    drops nothing; decode may also tip a near tie in the router's top 8.
    The MoE layer is the last, so a drop or a tip changes only its own
    position: the positions routed alike with nothing dropped within
    LOGIT_TOL and LOGIT_MEAN_TOL (at least one), and decode run again on
    the forward's dispatch, the assignments the forward dropped weighing
    0 (``RouterRecord(force=...)`` with ``keep``), within them at every
    position.

    Printed for each, with the card's name and power limit: init s and
    peak, forward s, busy share and launches, decode step s, tokens/s,
    launches a step and busy share; xlstm's sLSTM share of the forward's
    launches; deepseek's MLA cache bytes a token against a per-head KV
    cache of the same shape."""
    t_phase = time.perf_counter()
    out = {XLSTM_ARCH: serve_xlstm(np, torch, flash_ops, decode_ops, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    out[MLA_ARCH] = serve_deepseek(np, torch, flash_ops, decode_ops, smi)
    seconds = time.perf_counter() - t_phase
    print(f"phase 6g: {seconds!r} s [{smi}]")
    return out


# --------------------------------------------------------------- phase 7
def f32_path(f32):
    return f"phase 6h yi-6b float32 ({f32['n_layers']} layers)"


def f16_path(f16):
    return f"phase 6i yi-6b float16 ({f16['n_layers']} layers)"


def path_launches(served, trained, families, hybrid, f32, f16, key):
    """A kernel row's launches: phase 6's serve and phase 6d's trained
    model (Yi-6B), phase 6e's three configs, phase 6f's recurrentgemma-9b
    and phase 6h's float32 and 6i's float16 Yi-6B, each path's count read
    just after it ran."""
    by_path = {"phase 6 serve (yi-6b, 32 layers)": served[key],
               "phase 6d train -> serve (yi-6b, 4 layers)": trained[key]}
    for arch, fam in families.items():
        by_path[f"phase 6e {arch} ({fam['n_layers']} layers)"] = fam[key]
    by_path[f"phase 6f {HYBRID_ARCH} ({hybrid['n_layers']} layers)"] = hybrid[key]
    by_path[f32_path(f32)] = f32[key]
    by_path[f16_path(f16)] = f16[key]
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def sdpa_backend(torch, *args, **kwargs):
    """The SDPA backend that ``scaled_dot_product_attention(*args,
    **kwargs)`` runs: the choice PyTorch makes for these arguments
    (``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(*args, **kwargs)).name


def measure_attention(torch, flash_ops, flash_ref, decode_ops, decode_ref, served, cut_served,
                      full_served, trained, families, hybrid, f32, f16, card):
    import torch.nn.functional as F

    from repro_torch.launch.roofline import FP32_FLOPS, PEAK_FLOPS, TF32_FLOPS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    mem_rate = memory_rate(card)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    before = flash_ops.LAUNCHES, decode_ops.LAUNCHES
    ceilings = {}  # float32 flash: the CUDA cores' ceiling by heads, ms
    floors = {}  # 16-bit flash up to 32: the exponentials' floor by row, ms

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def timed(kernel, plain, library, nbytes, flops, yard=None, rate=PEAK_FLOPS):
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
        bytes_ms = nbytes / mem_rate * 1e3
        ops_ms = flops / rate * 1e3
        return {
            "max_abs_err": float((out.float() - want.float()).abs().max()),
            "ms": ms,
            "wrapper_ms": time_ms(torch, kernel, flush, queued=False)[0],
            "plain_ms": time_ms(torch, plain, flush)[0],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": time_ms(torch, library, flush)[0],
        }

    def expanded_sdpa(q, k, v, **kw):
        """SDPA with k and v expanded to q's heads beforehand (outside the
        timing), where the heads are grouped: ``enable_gqa`` sends float32
        to SDPA's ``MATH`` backend, the expanded call may take a fused one.
        Its time and backend, or Nones for one kv head a q head."""
        g = q.shape[1] // k.shape[1]
        if g == 1:
            return {"library_expanded_ms": None, "sdpa_expanded_backend": None}
        ek, ev = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        out = {"library_expanded_ms":
               time_ms(torch, lambda: F.scaled_dot_product_attention(q, ek, ev, **kw), flush)[0],
               "sdpa_expanded_backend": sdpa_backend(torch, q, ek, ev, **kw)}
        del ek, ev
        return out

    def decode_case(h, hkv, d, lens, s=DECODE_LEN, dtype=torch.bfloat16, expanded=False):
        """Decode over a cache of s rows at ``lens``.  The bound: the rows
        the function reads, each element once (2 or 4 bytes), at the card's
        memory rate, against its products (float32: three TF32 products a
        pair, the least for float32 accuracy) at their rate.  expanded:
        SDPA on k and v expanded to the q heads beside (``expanded_sdpa``)."""
        b, esz = len(lens), dtype.itemsize
        q = randn(b, h, d, dtype=dtype)
        k, v = randn(b, hkv, s, d, dtype=dtype), randn(b, hkv, s, d, dtype=dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        rows = sum(min(int(x), s) if x > 0 else s for x in lens)  # rows the function reads
        sdpa = (q[:, :, None], k, v), dict(attn_mask=mask, enable_gqa=True)
        flops = 4 * rows * h * d  # q.k and p.v per valid row, every q head
        row = timed(
            lambda: decode_ops.decode_attention(q, k, v, lengths),
            lambda: decode_ref.decode_attention_ref(q, k, v, lengths),
            lambda: F.scaled_dot_product_attention(*sdpa[0], **sdpa[1]),
            nbytes=rows * hkv * d * esz * 2 + 2 * q.numel() * esz + b * 4,
            flops=flops if esz == 2 else 3 * flops,
            rate=PEAK_FLOPS if esz == 2 else TF32_FLOPS,
        )
        if expanded:
            row.update(expanded_sdpa(q[:, :, None], k, v, attn_mask=mask))
        n_splits, chunk = decode_ops.split_plan(s, b * hkv, sms, h // hkv, d, dtype)
        kernel = decode_ops.decode_kernel(dtype, h // hkv, d)
        return {**row, "sdpa_backend": sdpa_backend(torch, *sdpa[0], **sdpa[1]),
                "kernel": kernel, "plan": [n_splits, chunk],
                "partial_bytes_written_and_read": 2 * decode_ops.partial_bytes(b, h, d, n_splits),
                "cache_bytes": b * hkv * s * d * esz * 2, "ptxas": PTXAS.get(kernel)}

    def flash_case(h, hkv, d, window=None, fs=FORWARD_LEN, dtype=torch.bfloat16,
                   expanded=False):
        """One fs-token prompt, causal.  A window of fs or more masks
        nothing more, so SDPA's causal call computes the same function;
        a narrower one goes to SDPA as an explicit boolean mask, and the
        bound counts the (query, key) pairs it leaves.  bf16: the products
        at the bf16 tensor-core rate; float32: three TF32 products a pair
        (the least the card can take for float32 accuracy); the CUDA cores'
        ceiling for one float32 product a pair goes to ``ceilings``, not
        to the row.  At 16-bit head dims up to 32 the floor the exponentials
        put under it at EX2_RATE (one a visible pair and q head, computed)
        goes to ``floors``.  expanded: SDPA on k and v expanded beside."""
        esz = dtype.itemsize
        fq = randn(1, h, fs, d, dtype=dtype)
        fk, fv = randn(1, hkv, fs, d, dtype=dtype), randn(1, hkv, fs, d, dtype=dtype)
        if window is None or window >= fs:
            sdpa = dict(is_causal=True, enable_gqa=True)
            flops = 2 * h * fs * fs * d  # q.k and p.v over the causal half
            pairs = fs * (fs + 1) // 2
        else:
            pos = torch.arange(fs, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            sdpa = dict(attn_mask=mask, enable_gqa=True)
            pairs = sum(min(i + 1, window) for i in range(fs))
            flops = 4 * h * d * pairs  # q.k and p.v over the visible pairs
        kernel = flash_ops.kernel_name(dtype, d)
        row = timed(
            lambda: flash_ops.flash_attention(fq, fk, fv, causal=True, window=window),
            lambda: flash_ref.attention_ref(fq, fk, fv, causal=True, window=window),
            lambda: F.scaled_dot_product_attention(fq, fk, fv, **sdpa),
            nbytes=(2 * fq.numel() + fk.numel() + fv.numel()) * esz,
            flops=flops if esz == 2 else 3 * flops,
            yard=(lambda: flash_yardstick(fq, fk, fv, causal=True, window=window))
            if p_rounded(dtype, d) else None,
            rate=PEAK_FLOPS if esz == 2 else TF32_FLOPS,
        )
        label = flash_ops.kernel_label(dtype, d)
        if esz == 4:
            ceilings[f"{h}/{hkv} x {d}"] = flops / FP32_FLOPS * 1e3
        elif flash_ops.width(dtype, d) == 32:
            floors[f"{h}/{hkv} x {d} {str(dtype).split('.')[-1]}"] = h * pairs / EX2_RATE * 1e3
        if expanded:
            row.update(expanded_sdpa(fq, fk, fv, **{k: w for k, w in sdpa.items()
                                                    if k != "enable_gqa"}))
        return {**row, "sdpa_backend": sdpa_backend(torch, fq, fk, fv, **sdpa),
                "kernel": kernel, "instantiation": label, "ptxas": PTXAS.get(label)}

    def wide_flash(h, hkv, dtype):
        """A flash row above head dim 256 (WIDE_TIMED_DIM), on no path."""
        name = str(dtype).split(".")[-1]
        return {**flash_case(h, hkv, WIDE_TIMED_DIM, dtype=dtype, expanded=True),
                "launches": 0, "launches_by_path": {},
                "groups": flash_ops.wide_groups(dtype, WIDE_TIMED_DIM),
                "shape": f"B=1 H={h} Hkv={hkv} S={FORWARD_LEN} D={WIDE_TIMED_DIM} {name} causal"}

    # the main path's shapes: decode over 4 slots of 4096 positions, 32/4
    # heads; flash on one 2048-token prompt
    h, hkv, d, _, b = ATTENTION_ROWS["yi-6b"]
    s = DECODE_LEN
    final = [int(x) for x in served["final_lengths"]]
    dec = decode_case(h, hkv, d, final)
    dec_full = decode_case(h, hkv, d, [s] * b)
    fl = flash_case(h, hkv, d)
    # phase 6b's shapes, at full length
    flash_cut, decode_cut = {}, {}
    for arch in FULL_ARCHS:
        ch, chkv, cd, window, cb = ATTENTION_ROWS[arch]
        full = full_served[arch]
        flash_cut[arch] = {**flash_case(ch, chkv, cd, window),
                           "kernel": flash_ops.kernel_name(torch.bfloat16, cd),
                           "launches": cut_served[arch]["flash_launches"],
                           "full_depth_launches": full["flash_launches"],
                           "full_depth_forward_s": full["forward_s"],
                           "full_depth_layers": full["n_layers"],
                           "shape": f"B=1 H={ch} Hkv={chkv} S={FORWARD_LEN} D={cd} bf16 "
                                    f"causal window={window}"}
        decode_cut[arch] = {**decode_case(ch, chkv, cd, [s] * cb),
                            "launches": cut_served[arch]["decode_launches"],
                            "shape": f"B={cb} H={ch} Hkv={chkv} S={s} D={cd} bf16 full length"}
    # phase 6e's shapes: MHA 16/16 and GQA 16/8 at D = 128, MHA 24/24 at
    # D = 64 (flash_wgmma)
    for arch in FAMILY_ARCHS:
        fh, fhkv, fd, _, fb = ATTENTION_ROWS[arch]
        fam = families[arch]
        path = f"phase 6e {arch} ({fam['n_layers']} layers)"
        flash_cut[arch] = {**flash_case(fh, fhkv, fd),
                           "kernel": flash_ops.kernel_name(torch.bfloat16, fd),
                           "launches": fam["flash_launches"],
                           "launches_by_path": {path: fam["flash_launches"]},
                           "full_depth_forward_s": fam["forward_s"],
                           "full_depth_layers": fam["n_layers"],
                           "shape": f"B=1 H={fh} Hkv={fhkv} S={FORWARD_LEN} D={fd} bf16 causal"}
        decode_cut[arch] = {**decode_case(fh, fhkv, fd, [s] * fb),
                            "launches": fam["decode_launches"],
                            "launches_by_path": {path: fam["decode_launches"]},
                            "shape": f"B={fb} H={fh} Hkv={fhkv} S={s} D={fd} bf16 full length"}
    # phase 6b's granite-34b: MQA 48/1 at D = 128
    gh, ghkv, gd, _, gb = ATTENTION_ROWS["granite-34b"]
    gran = cut_served["granite-34b"]
    gpath = f"phase 6b granite-34b ({CUT_LAYERS} layers)"
    flash_cut["granite-34b"] = {
        **flash_case(gh, ghkv, gd),
        "kernel": flash_ops.kernel_name(torch.bfloat16, gd),
        "launches": gran["flash_launches"],
        "launches_by_path": {gpath: gran["flash_launches"]},
        "shape": f"B=1 H={gh} Hkv={ghkv} S={FORWARD_LEN} D={gd} bf16 causal"}
    decode_cut["granite-34b"] = {
        **decode_case(gh, ghkv, gd, [s] * gb),
        "launches": gran["decode_launches"],
        "launches_by_path": {gpath: gran["decode_launches"]},
        "shape": f"B={gb} H={gh} Hkv={ghkv} S={s} D={gd} bf16 full length"}
    # phase 6f's recurrentgemma-9b: MQA 16/1 at D = 256, window 2048
    rh, rhkv, rd, rw, rb = ATTENTION_ROWS[HYBRID_ARCH]
    hpath = f"phase 6f {HYBRID_ARCH} ({hybrid['n_layers']} layers)"
    flash_by_path = {hpath: hybrid["flash_launches"]}
    decode_by_path = {hpath: hybrid["decode_launches"]}
    flash_cut[f"{HYBRID_ARCH}, S={HYBRID_FORWARD_LEN} window {rw}"] = {
        **flash_case(rh, rhkv, rd, window=rw, fs=HYBRID_FORWARD_LEN),
        "kernel": flash_ops.kernel_name(torch.bfloat16, rd),
        "launches": hybrid["flash_launches"], "launches_by_path": flash_by_path,
        "full_depth_forward_s": hybrid["forward_s"], "full_depth_layers": hybrid["n_layers"],
        "shape": f"B=1 H={rh} Hkv={rhkv} S={HYBRID_FORWARD_LEN} D={rd} bf16 causal "
                 f"window={rw}"}
    flash_cut[f"{HYBRID_ARCH}, S={FORWARD_LEN} causal"] = {
        **flash_case(rh, rhkv, rd, window=rw),
        "kernel": flash_ops.kernel_name(torch.bfloat16, rd),
        "launches": hybrid["flash_launches"], "launches_by_path": flash_by_path,
        "shape": f"B=1 H={rh} Hkv={rhkv} S={FORWARD_LEN} D={rd} bf16 causal window={rw} "
                 f"(masks nothing at this S)"}
    hfinal = [int(x) for x in hybrid["final_lengths"]]
    decode_cut[f"{HYBRID_ARCH}, the serve's lengths"] = {
        **decode_case(rh, rhkv, rd, hfinal),
        "launches": hybrid["decode_launches"], "launches_by_path": decode_by_path,
        "shape": f"B={len(hfinal)} H={rh} Hkv={rhkv} S={s} D={rd} bf16 lengths={hfinal}"}
    decode_cut[f"{HYBRID_ARCH}, full length"] = {
        **decode_case(rh, rhkv, rd, [s] * rb),
        "launches": hybrid["decode_launches"], "launches_by_path": decode_by_path,
        "shape": f"B={rb} H={rh} Hkv={rhkv} S={s} D={rd} bf16 full length"}
    # float32 (flash_tf32 and decode_split<f32, D>) at the heads of
    # FLOAT32_ARCHS, and flash at head dim 32 in both dtypes (flash_tf32):
    # phase 6h runs Yi-6B's shapes; the others are on no path (0 launches)
    fpath = f32_path(f32)
    flash_f32, decode_f32 = {}, {}
    for arch in FLOAT32_ARCHS:
        ah, ahkv, ad, aw, ab = ATTENTION_ROWS[arch]
        on_path = arch == "yi-6b"
        fl_n = f32["flash_launches"] if on_path else 0
        dec_n = f32["decode_launches"] if on_path else 0
        flash_f32[f"{arch} float32"] = {
            **flash_case(ah, ahkv, ad, window=aw, dtype=torch.float32, expanded=True),
            "launches": fl_n, "launches_by_path": {fpath: fl_n} if on_path else {},
            "shape": f"B=1 H={ah} Hkv={ahkv} S={FORWARD_LEN} D={ad} float32 causal"
                     + (f" window={aw} (masks nothing at this S)" if aw else "")}
        decode_f32[f"{arch} float32, full length"] = {
            **decode_case(ah, ahkv, ad, [s] * ab, dtype=torch.float32, expanded=True),
            "launches": dec_n, "launches_by_path": {fpath: dec_n} if on_path else {},
            "shape": f"B={ab} H={ah} Hkv={ahkv} S={s} D={ad} float32 full length"}
    f32_final = [int(x) for x in f32["final_lengths"]]
    decode_f32["yi-6b float32, the serve's lengths"] = {
        **decode_case(h, hkv, d, f32_final, dtype=torch.float32, expanded=True),
        "launches": f32["decode_launches"],
        "launches_by_path": {fpath: f32["decode_launches"]},
        "shape": f"B={len(f32_final)} H={h} Hkv={hkv} S={s} D={d} float32 lengths={f32_final}"}
    dh, dhkv = D32_HEADS
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        flash_f32[f"{dh}/{dhkv} x 32 {name}"] = {
            **flash_case(dh, dhkv, 32, dtype=dtype, expanded=True), "launches": 0,
            "launches_by_path": {},
            "shape": f"B=1 H={dh} Hkv={dhkv} S={FORWARD_LEN} D=32 {name} causal"}
    # float16 at Yi-6B's shapes, phase 6i's path; and the new
    # domain's configs, on no path: Phi-3-mini's flash (MHA 32/32 x 96,
    # flash_wgmma_any<bf16, 96>) and Falcon-7B's decode (MQA 71/1 x 64, two
    # slices of the group)
    hpath16 = f16_path(f16)
    f16_final = [int(x) for x in f16["final_lengths"]]
    domain = {
        "yi-6b float16 flash": {
            **flash_case(h, hkv, d, dtype=torch.float16),
            "launches": f16["flash_launches"],
            "launches_by_path": {hpath16: f16["flash_launches"]},
            "shape": f"B=1 H={h} Hkv={hkv} S={FORWARD_LEN} D={d} float16 causal"},
        "yi-6b float16 decode, the serve's lengths": {
            **decode_case(h, hkv, d, f16_final, dtype=torch.float16),
            "launches": f16["decode_launches"],
            "launches_by_path": {hpath16: f16["decode_launches"]},
            "shape": f"B={len(f16_final)} H={h} Hkv={hkv} S={s} D={d} float16 "
                     f"lengths={f16_final}"},
        "yi-6b float16 decode, full length": {
            **decode_case(h, hkv, d, [s] * b, dtype=torch.float16),
            "launches": f16["decode_launches"],
            "launches_by_path": {hpath16: f16["decode_launches"]},
            "shape": f"B={b} H={h} Hkv={hkv} S={s} D={d} float16 full length"},
    }
    ph, phkv, pd = PHI3_HEADS
    domain["phi-3-mini flash"] = {
        **flash_case(ph, phkv, pd), "launches": 0, "launches_by_path": {},
        "shape": f"B=1 H={ph} Hkv={phkv} S={FORWARD_LEN} D={pd} bf16 causal"}
    # a head dim whose rows are not whole 16-byte pieces (33 bf16 elements):
    # the kernel reads q, k and v as they are and writes the output at 33
    # columns, no copy (flash_wgmma_any's narrow loader); and a row at 160,
    # S = FORWARD_LEN, causal
    check(flash_ops.row_elems(torch.bfloat16, NARROW_DIM) == NARROW_DIM,
          f"the wrapper pads head dim {NARROW_DIM}")
    domain[f"32/4 x {NARROW_DIM} bf16 flash (no padded copy)"] = {
        **flash_case(32, 4, NARROW_DIM), "launches": 0, "launches_by_path": {},
        "shape": f"B=1 H=32 Hkv=4 S={FORWARD_LEN} D={NARROW_DIM} bf16 causal"}
    ah, ahkv, ad = ANY_TIMED_HEADS
    domain[f"{ah}/{ahkv} x {ad} bf16 flash"] = {
        **flash_case(ah, ahkv, ad), "launches": 0, "launches_by_path": {},
        "shape": f"B=1 H={ah} Hkv={ahkv} S={FORWARD_LEN} D={ad} bf16 causal"}
    fh, fhkv, fd = FALCON_HEADS
    domain["falcon-7b decode, full length"] = {
        **decode_case(fh, fhkv, fd, [s] * 4), "launches": 0, "launches_by_path": {},
        "slices": list(decode_ops.group_slices(fh // fhkv)),
        "shape": f"B=4 H={fh} Hkv={fhkv} S={s} D={fd} bf16 full length"}
    # head dims above 256 (flash_wgmma_wide, flash_tf32_wide, decode_wide),
    # on no path.  SDPA's flash and cuDNN backends refuse them, so the backend
    # named is what ran; every row also times SDPA on k and v expanded to the
    # q heads (EFFICIENT_ATTENTION takes D > 256; enable_gqa sends it to MATH)
    wd = WIDE_TIMED_DIM
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for wh, whkv in WIDE_TIMED_FLASH:
            domain[f"{wh}/{whkv} x {wd} {name} flash"] = wide_flash(wh, whkv, dtype)
        domain[f"32/4 x {wd} {name} decode, full length"] = {
            **decode_case(32, 4, wd, [s] * 4, dtype=dtype, expanded=True), "launches": 0,
            "launches_by_path": {},
            "shape": f"B=4 H=32 Hkv=4 S={s} D={wd} {name} full length"}
    # float16 above 256 runs flash_wgmma_wide too (drawn last, so the rows
    # above keep their inputs)
    wh, whkv = WIDE_TIMED_FLASH[0]
    domain[f"{wh}/{whkv} x {wd} float16 flash"] = wide_flash(wh, whkv, torch.float16)
    # decode_wide in float16, at a slice tail and on rows that are not whole
    # 16-byte pieces (WIDE_TIMED_DECODE's second, fourth and fifth rows: 32/4
    # x 512 float16, 16/1 x 576 bf16, 32/4 x 515 bf16: decode_wide_narrow),
    # drawn last too
    for wh, whkv, wdd, name in WIDE_TIMED_DECODE[1::2] + WIDE_TIMED_DECODE[4:]:
        domain[f"{wh}/{whkv} x {wdd} {name} decode, full length"] = {
            **decode_case(wh, whkv, wdd, [s] * 4, dtype=getattr(torch, name), expanded=True),
            "launches": 0, "launches_by_path": {},
            "shape": f"B=4 H={wh} Hkv={whkv} S={s} D={wdd} {name} full length"}
    # float16 at 32 and bf16 at 16 (flash_wgmma_any<bf16, 32>) beside bf16
    # at 32, drawn last
    for dd, name in D32_TIMED:
        flash_f32[f"{dh}/{dhkv} x {dd} {name}"] = {
            **flash_case(dh, dhkv, dd, dtype=getattr(torch, name), expanded=True),
            "launches": 0, "launches_by_path": {},
            "shape": f"B=1 H={dh} Hkv={dhkv} S={FORWARD_LEN} D={dd} {name} causal"}
    flash_ops.LAUNCHES, decode_ops.LAUNCHES = before  # timing is not the main path
    print("timing: kernels device-only (queued behind a sleep kernel); plain versions and "
          "SDPA queued the same way")
    print("float32 flash, the CUDA cores' ceiling (one float32 product a pair at FP32_FLOPS, "
          "computed, not measured; the rows' bound_ms counts three TF32 products a pair): "
          + json.dumps({shape: ms for shape, ms in ceilings.items()}))
    print("16-bit flash up to head dim 32, the exponentials' floor (one ex2 a visible pair "
          "and q head at EX2_RATE, computed, not measured): " + json.dumps(floors))
    rows = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
         **fl, **path_launches(served, trained, families, hybrid, f32, f16, "flash_launches"),
         "kernel": flash_ops.kernel_name(torch.bfloat16, d),
         "shape": f"B=1 H={h} Hkv={hkv} S={FORWARD_LEN} D={d} bf16 causal",
         "by_config": flash_cut, "float32_and_d32": flash_f32,
         "float16_and_domain": {k: r for k, r in domain.items() if "flash" in k}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:85",
         **dec, **path_launches(served, trained, families, hybrid, f32, f16, "decode_launches"),
         "shape": f"B={b} H={h} Hkv={hkv} S={s} D={d} bf16 lengths={final}",
         "at_full_length": dec_full, "by_config": decode_cut, "float32": decode_f32,
         "float16_and_domain": {k: r for k, r in domain.items() if "decode" in k}},
    ]
    return rows


# --------------------------------------------------------------- phase 8
#: phase 8: the example editions, each run as a process at its default
#: device (the card)
EXAMPLE_EDITIONS = ("torch_quickstart", "torch_taxi_pipeline", "torch_train_lm",
                    "torch_serve_lm", "torch_reasonable_scale")
#: processes that plan phase 8's dry-run cells at once (the cells take
#: 0.2-26 s of one core each on meta tensors)
PLAN_WORKERS = 4
#: the phase's seconds must stay below this
PLANNER_PHASE_S = 90.0
#: the planned init peak may differ from the measured one by this share
INIT_PEAK_SHARE = 0.05


def plan_cell(arch, shape_name):
    """One single-pod dry-run cell (a process of phase 8's pool)."""
    import contextlib
    import io

    import torch

    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    with contextlib.redirect_stdout(io.StringIO()):
        rec = lower_cell(arch, SHAPES[shape_name], make_production_mesh())
    return f"{arch}/{shape_name}/single", rec


def plan_sweep(pool):
    """(a): every arch x shape on the abstract 16 x 16 mesh: the skip
    records, and a future of each live cell's record on ``pool``, the
    longest cells first."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.shapes import SHAPES, shape_applicable

    skipped, live = {}, []
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            skip = shape_applicable(get_config(arch), shape)
            if skip:
                skipped[f"{arch}/{name}/single"] = {"skipped": skip}
            else:
                live.append((arch, name))
    live.sort(key=lambda c: (SHAPES[c[1]].kind != "train",
                             c[0] not in ("xlstm_350m", "deepseek_v3_671b")))
    return skipped, [pool.submit(plan_cell, arch, name) for arch, name in live]


def place_yi(np, torch, smi):
    """(b): phase 6's Yi-6B parameters (the same seed) placed by
    DEFAULT_RULES as DTensors on a 1 x 1 ``make_host_mesh()`` on the card;
    each ``to_local()`` bitwise equal to its parameter; the group torn
    down."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.distribution import DEFAULT_RULES, param_shardings, to_placements
    from repro_torch.launch.mesh import close_host_mesh, make_host_mesh
    from repro_torch.models import LM

    t0 = time.perf_counter()
    model = LM(get_config("yi-6b")).init(torch.Generator(device="cuda").manual_seed(SEED))
    mesh = make_host_mesh()
    try:
        specs = param_shardings(DEFAULT_RULES, mesh, model)
        sharded = 0
        for name, p in model.named_parameters():
            placements = to_placements(specs[name], mesh)
            d = distribute_tensor(p.detach(), mesh, placements)
            check(isinstance(d, DTensor) and d.device_mesh is mesh,
                  f"{name}: not a DTensor on the host mesh")
            check(bitwise_equal(torch, d.to_local(), p.detach()),
                  f"{name}: to_local() differs from the parameter")
            sharded += any(type(pl).__name__ == "Shard" for pl in placements)
            del d
        n = len(specs)
    finally:
        close_host_mesh()
    check(not torch.distributed.is_initialized(), "the host mesh's group is still open")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 8 (b): yi-6b's {n} parameters placed by DEFAULT_RULES as DTensors on a "
          f"1 x 1 host mesh (NCCL), {sharded} with a Shard placement, each to_local() "
          f"bitwise equal to its parameter, group torn down, in "
          f"{time.perf_counter() - t0!r} s [{smi}]")


def roofline_vs_card(served, full_served, smi):
    """(c): the roofline of phase 6's decode step and phase 6c's
    full-depth forwards on a 1 x 1 mesh, on the kernel route: each bound
    at most the card's measured time, and the planner's serving weights
    equal to phase 6c's, below its init peak, the planned init peak
    within INIT_PEAK_SHARE of the measured one."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import WorkloadShape
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.launch.roofline import cell_report

    mesh = AbstractMesh({"data": 1, "model": 1})
    cells = [("yi-6b", WorkloadShape("serve_decode", DECODE_LEN, 4, "decode"),
              served["decode_step_s"], None)]
    cells += [(arch, WorkloadShape("forward", FORWARD_LEN, 1, "prefill"),
               full_served[arch]["forward_s"], full_served[arch]) for arch in FULL_ARCHS]
    out = {}
    for arch, shape, measured, full in cells:
        cfg = dataclasses.replace(get_config(arch), use_flash_kernel=True)
        rec = lower_cell(arch.replace("-", "_").replace(".", "_"), shape, mesh,
                         cfg_override=cfg)
        r = cell_report(rec, cfg, shape)
        frac = r["bound_s"] / measured
        terms = {k: v * 1e3 for k, v in r["terms_s"].items()}
        print(f"phase 8 (c): {arch} {shape.kind} (B = {shape.global_batch}, S = "
              f"{shape.seq_len}, kernel route): roofline terms ms {terms!r}, bound "
              f"{r['bound_s'] * 1e3!r} ms ({r['dominant']}), measured {measured * 1e3!r} ms, "
              f"fraction {frac!r}; counted {rec['flops_per_device']!r} FLOPs, "
              f"{rec['bytes_per_device']!r} B [{smi}]")
        check(r["bound_s"] <= measured, f"{arch}: roofline bound {r['bound_s']} s exceeds the "
              f"measured {measured} s")
        if full is not None:
            planned, peak = rec["serve_param_bytes_global"], full["init_peak_bytes"]
            model_peak = rec["serve_init_peak_bytes"]
            share = abs(model_peak - peak) / peak
            print(f"phase 8 (c): {arch} weights planned {planned} B, measured "
                  f"{full['weights_bytes']} B; init peak planned {model_peak} B, measured "
                  f"{peak} B ({share!r} apart)")
            check(planned == full["weights_bytes"] and planned <= peak,
                  f"{arch}: planned weights {planned} B against {full['weights_bytes']} B "
                  f"measured, init peak {peak} B")
            check(share <= INIT_PEAK_SHARE, f"{arch}: planned init peak {model_peak} B is "
                  f"{share:.3f} from the measured {peak} B")
        out[arch] = {"bound_s": r["bound_s"], "measured_s": measured, "fraction": frac}
    return out


def planner_and_examples(np, torch, served, full_served, smi):
    """Phase 8: the planner and the example editions (see the module's
    docstring).  The editions start first and run while the planner
    counts; each must exit 0."""
    from repro_torch.launch.roofline import build_report, markdown_table

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for name in EXAMPLE_EDITIONS:  # output to files: nobody reads a pipe meanwhile
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}.py")], cwd=ROOT, env=env,
            stdout=out, stderr=err, text=True), out, err, time.perf_counter())
    try:
        with ProcessPoolExecutor(PLAN_WORKERS, mp_context=multiprocessing.get_context("spawn")
                                 ) as pool:
            records, futures = plan_sweep(pool)
            # (b) and (c) here while the pool plans
            place_yi(np, torch, smi)
            fractions = roofline_vs_card(served, full_served, smi)
            records.update(f.result() for f in futures)
        plan_s = time.perf_counter() - t_phase
        n_live = len(futures)
        report = build_report(records, path=None)
        print(markdown_table(report))
        failed = [k for k, r in report.items() if "error" in r]
        ok = sum(1 for r in records.values() if r.get("ok"))
        skipped = sum(1 for r in records.values() if "skipped" in r)
        print(f"phase 8 (a): {ok} of {n_live} live cells planned on the abstract 16 x 16 "
              f"mesh, {skipped} skipped by shape_applicable, by {plan_s!r} s into the "
              f"phase with {PLAN_WORKERS} processes; counting seconds by cell "
              f"{sum(r['lower_s'] for r in records.values() if r.get('ok'))!r} in all "
              f"[{smi}]")
        check(not failed and ok == n_live, f"dry-run cells failed: {failed}")
        for name, (proc, out, err, started) in procs.items():
            proc.wait(timeout=max(PLANNER_PHASE_S - (time.perf_counter() - t_phase), 1.0))
            took = time.perf_counter() - started
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            print(f"phase 8 (d): examples/{name}.py exited {proc.returncode} within "
                  f"{took!r} s, {len(lines)} lines, the last {lines[-1:]!r}")
            check(proc.returncode == 0, f"examples/{name}.py failed: {err.read()[-2000:]}")
    finally:
        for proc, out, err, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    seconds = time.perf_counter() - t_phase
    print(f"phase 8: {seconds!r} s [{smi}]")
    check(seconds < PLANNER_PHASE_S, f"phase 8 took {seconds} s")
    return {"fractions": fractions, "phase_s": seconds}


def main() -> int:
    t_start = time.perf_counter()
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

    sass = build_kernels((ops, flash_ops, decode_ops))
    check(sass["HGMMA"] > 0, "the flash library has no wgmma instruction")
    check(sass["TF32"] > 0, "the flash library has no TF32 tensor-core instruction")
    want32 = {f"flash_wgmma{a}<{t}, 32>" for a in ("", "_any") for t in ("bf16", "f16")}
    check(set(sass["d32"]) == want32 and all(
        c["HGMMA"] > 0 and c["LDL/STL"] == 0 for c in sass["d32"].values()),
        f"the head-dim-32 kernels' SASS: {sass['d32']}")
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
    domain_vs_plain(torch, flash_ops, flash_ref, decode_ops, decode_ref, ops, ref, inputs)
    served = serve_yi(np, torch, flash_ops, decode_ops)
    cut_served = {arch: serve_cut(np, torch, flash_ops, decode_ops, arch) for arch in CUT_ARCHS}
    full_served = {arch: forward_full(np, torch, flash_ops, arch, smi) for arch in FULL_ARCHS}
    trained = train_serve(np, torch, flash_ops, decode_ops, smi)
    families = serve_families(np, torch, flash_ops, decode_ops, smi)
    hybrid = serve_recurrentgemma(np, torch, flash_ops, decode_ops, smi)
    ssm_mla = serve_xlstm_deepseek(np, torch, flash_ops, decode_ops, smi)
    f32 = serve_yi_float32(np, torch, flash_ops, decode_ops, smi)
    f16 = serve_yi_float16(np, torch, flash_ops, decode_ops, smi)
    rows = measure_attention(torch, flash_ops, flash_ref, decode_ops, decode_ref, served,
                             cut_served, full_served, trained, families, hybrid, f32, f16,
                             card)
    planner_and_examples(np, torch, served, full_served, smi)
    music = families["musicgen-medium"]
    print(f"musicgen-medium (phase 6e): forward of {FORWARD_LEN} positions "
          f"{music['forward_s']!r} s, flash_attention launches {music['flash_launches']} a "
          f"forward ({flash_ops.kernel_name(torch.bfloat16, 64)}), flash kernels in the "
          f"forward profile {music['forward_profile_flash_ms']!r} ms in "
          f"{music['forward_profile_flash_launches']} launches [{smi}]")
    print(f"{HYBRID_ARCH} (phase 6f): forward of {HYBRID_FORWARD_LEN} positions "
          f"{hybrid['forward_s']!r} s, busy share {hybrid['forward_busy_share']!r}, flash "
          f"kernels in the forward profile {hybrid['forward_profile_flash_ms']!r} ms in "
          f"{hybrid['forward_profile_flash_launches']} launches; decode step "
          f"{hybrid['decode_step_s']!r} s, busy share {hybrid['busy_share']!r} [{smi}]")
    for arch, r in ssm_mla.items():
        print(f"{arch} (phase 6g, {r['n_layers']} layers): init {r['init_s']!r} s, peak "
              f"{r['init_peak_bytes']} B; forward of {FORWARD_LEN} positions "
              f"{r['forward_s']!r} s; decode step {r['decode_step_s']!r} s, "
              f"{r['tokens_per_s']!r} tokens/s, busy share {r['decode_busy_share']!r}; no "
              f"attention kernel on the path [{smi}]")
    print(f"chip_smoke.py: {time.perf_counter() - t_start!r} s in all [{smi}]")
    print(json.dumps({"kernels": [{**row, "card": smi} for row in (ffa_row, *rows)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
