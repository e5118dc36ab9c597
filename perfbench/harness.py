"""One run of one cell: set-up, the measured (or traced) window, the check.

``run_cell`` is the whole run but for the look for a chip, so that the
tests can drive it on the CPU at a small size, with the timed path broken
underneath (``make_forward``).  ``perfbench/run.py`` looks for the chip,
fixes the caches, calls it and prints the result.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perfbench import check, job, spec, tracing
from perfbench.weights import make_tokens

GIB = 2.0 ** 30


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def end_to_end(cell: spec.Cell, loop: job.LoopResult, setup_s: float,
               memory_peak_bytes: int) -> Dict[str, float]:
    """The cell's end-to-end metrics of an untraced window."""
    values = {
        "tokens_per_s": loop.batches * cell.tokens_per_batch / (loop.end - loop.start),
        "latency_p95_s": float(np.percentile(loop.latencies, 95)),
        "peak_mem_gib": memory_peak_bytes / GIB,
        "setup_s": setup_s,
    }
    return {m["name"]: values[m["name"]] for m in cell.end_to_end}


def work(cell: spec.Cell) -> tracing.Work:
    """What one of the cell's batches asks of the card, by its model."""
    return tracing.Work(
        batch_flops=cell.model.batch_flops(cell.config, cell.rows, cell.seq_len),
        flash_launch_bound_s=cell.model.flash_launch_bound_s(cell.config, cell.rows,
                                                             cell.seq_len),
    )


def traced(cell: spec.Cell, forward: Callable, pool, clients: int):
    """The closed loop under torch.profiler for one warm-up step and
    ``trace_batches`` active ones: (loop, window)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    active = int(cell.traffic["trace_batches"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=active, repeat=1)) as prof:
        loop = job.closed_loop(forward, pool, clients=clients, batches=active + 1,
                               on_done=prof.step)
    return loop, tracing.from_profile(prof.events(), active, work(cell))


def run_cell(cell: spec.Cell, *, seed: int, seconds: float, traced_run: bool,
             device: torch.device, t0: float,
             make_forward: Optional[Callable] = None) -> dict:
    """Everything of a run after the look for a chip; the result line as a
    dict.  ``make_forward(model, weights)`` gives the timed entry point
    (``model.forward`` when None)."""
    stamps = [("imports", time.perf_counter())]
    cfg = cell.model.port_config(cell.config)
    shape = cell.model.ref_shape(cell.config)
    traffic = cell.traffic
    clients = int(traffic["clients"])
    weights = cell.model.make_weights(cell.config, seed, device)
    stamps.append(("weights", time.perf_counter()))
    model = cell.model.build(cfg, weights)
    forward = make_forward(model, weights) if make_forward else model.forward
    pool = make_tokens(shape.vocab, int(traffic["pool_batches"]), cell.rows, cell.seq_len,
                       seed, device)
    stamps.append(("model and tokens", time.perf_counter()))
    job.closed_loop(forward, pool, clients=clients, batches=int(traffic["warmup_batches"]))
    start = time.perf_counter()
    stamps.append(("warm-up", start))
    setup_s = start - t0
    parts = ", ".join(f"{name} {b - a:.3f}" for (name, b), (_, a)
                      in zip(stamps, [("", t0)] + stamps))
    log(f"{cell.name}: seed {seed}, {cell.rows} x {cell.seq_len} tokens a batch, "
        f"{clients} in flight; set-up {setup_s:.3f} s ({parts})")

    window = None
    if traced_run:
        loop, window = traced(cell, forward, pool, clients)
    else:
        loop = job.closed_loop(forward, pool, clients=clients, seconds=seconds)
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window: {loop.batches} batches in {loop.end - loop.start:.3f} s")

    picked = check.sample(seed, loop.batches, int(traffic["check_batches"]))
    rows = torch.cat([pool[i] for i in picked])
    got = np.concatenate([loop.answers[i] for i in picked])
    failed = sum(not np.isfinite(a).all() for a in loop.answers.values())
    del model, forward, pool
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = cell.model.score_rows(weights, rows, shape).cpu().numpy()
    log(f"reference: {rows.shape[0]} rows of batches {picked} in "
        f"{time.perf_counter() - t:.3f} s")
    within, checks = check.judge(check.readings(got, want), cell.limits)

    result = {"correct": bool(within and failed == 0), "attempted": loop.batches,
              "failed": int(failed)}
    if window is None:
        values = end_to_end(cell, loop, setup_s, memory_peak)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    else:
        values = tracing.read(window, spec.metric_readers(cell))
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()}
    result["device"] = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if window is not None:
        result["device"].update(busy_s=window.busy_s, window_s=window.window_s)
        result["breakdown"] = {"device_ops": tracing.device_table(window),
                               "idle_gaps": tracing.idle_table(window)}
    result["checks"] = checks
    return result
