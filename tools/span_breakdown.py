#!/usr/bin/env python3
"""A traced run of a benchmark cell, its device time put down to the
program's spans, and what a span costs on this host.

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 tools/span_breakdown.py --workload yi-6b.score-4k --seed 7 \\
        [--out spans-yi-6b.score-4k.json]

It sets the cell up as ``perfbench/run.py`` does (the same weights, tokens
and warm-up from ``--seed``), traces it with the benchmark's own
``perfbench.harness.traced``, and writes one JSON object to ``--out`` and as
the last line of standard output:

* ``metrics``: the cell's per-layer metrics of the window, as a
  ``--trace 1`` run reads them (no correctness check is made here);
* ``attribution``: ``table`` of the window (the matched share of its device
  time, the unspanned share, and by innermost span the device seconds,
  share and operations a batch), with the device operations that took
  most time under each span; null where ``perfbench/spans.py``'s anchor
  check refuses the pairing (a program without the spans);
* ``host_calls``: the host's calls that are neither ``aten::`` ops nor
  spans, by name, a batch: the launch calls ``perfbench/spans.py`` pairs
  are among them;
* ``spans_a_batch`` and ``span_us``: the ``lm.*`` spans a traced batch
  enters, and the host microseconds of one span's enter and exit with no
  profiler, with a profiler recording, and of an unguarded
  ``record_function`` with no profiler.

It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]


def table(window) -> Optional[Dict]:
    """The attribution in figures: the matched share of the window's device
    time, and by innermost span its device seconds, share of the matched
    time and operations a batch.  A batch is one ``score.forward`` the host
    entered in the window: the matched operations are those its launches
    made."""
    from perfbench import spans

    found = spans.attribute(window)
    if found is None:
        return None
    device_s = sum(op.seconds for op in window.device_ops)
    batches = sum(h.name == "score.forward" for h in window.host) or window.batches
    rows: Dict[str, List[float]] = {}
    for op, path in found.matched:
        row = rows.setdefault(spans.innermost(path), [0.0, 0])
        row[0] += op.seconds
        row[1] += 1
    flash_s = sum(op.seconds for op, _ in found.matched if "flash_" in op.name)
    return {
        "matched_share": 100.0 * found.matched_s / device_s,
        "unmatched_ops": len(found.unmatched),
        "unspanned_share": 100.0 * rows.get(spans.UNSPANNED, [0.0])[0] / found.matched_s,
        "flash_s": flash_s,
        "spans": [[name, s, 100.0 * s / found.matched_s, count / batches]
                  for name, (s, count) in sorted(rows.items(), key=lambda kv: -kv[1][0])],
    }


def traced_window(cell, seed: int, device):
    """The cell set up from ``seed`` on ``device`` and traced."""
    import repro_torch.kernels.build as kernel_build
    from perfbench import harness, job, program, run, spec
    from perfbench.weights import make_tokens, make_weights

    run.fix_caches()
    kernel_build.BUILD_DIR = run.BUILD / "kernels"
    cfg = program.port_config(cell.config)
    shape = spec.ref_shape(cell.config)
    clients = int(cell.traffic["clients"])
    model = program.build(cfg, make_weights(shape, cfg.n_layers, seed, device))
    pool = make_tokens(shape.vocab, int(cell.traffic["pool_batches"]), cell.rows,
                       cell.seq_len, seed, device)
    job.closed_loop(model.forward, pool, clients=clients,
                    batches=int(cell.traffic["warmup_batches"]))
    return harness.traced(cell, model.forward, pool, clients)[1]


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds of one enter and exit of a span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    try:
        from repro_torch.telemetry.spans import span
    except ImportError:  # a program without the spans
        return {}

    def loop(make) -> float:
        t = time.perf_counter()
        for _ in range(n):
            with make("lm.mlp"):
                pass
        return 1e6 * (time.perf_counter() - t) / n

    out = {"off": loop(span), "record_function_off": loop(record_function)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on"] = loop(span)
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import spans, spec, tracing

    if not torch.cuda.is_available():
        print("span_breakdown: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    window = traced_window(cell, args.seed, torch.device("cuda", 0))
    found = table(window)
    if found is not None:
        top = {}
        for op, path in spans.attribute(window).matched:
            top.setdefault(spans.innermost(path), Counter())[tracing.short_name(op.name)] += \
                op.seconds
        found["top_ops"] = {name: [[k, v] for k, v in c.most_common(6)]
                            for name, c in top.items()}
    calls = Counter(h.name for h in window.host
                    if not h.name.startswith(("aten::", "lm.", "score.")))
    result = {
        "workload": args.workload, "seed": args.seed, "batches": window.batches,
        "metrics": tracing.read(window, spec.metric_readers(cell)),
        "device_s": sum(op.seconds for op in window.device_ops),
        "kernels": len(window.kernels), "transfers": len(window.transfers),
        "span_kernels": sum(k.name.startswith(("lm.", "score.")) for k in window.kernels),
        "attribution": found,
        "host_calls": {k: v / window.batches for k, v in calls.most_common(30)},
        "spans_a_batch": sum(h.name.startswith("lm.") for h in window.host) / window.batches,
        "span_us": span_cost_us(),
    }
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
