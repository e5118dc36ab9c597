#!/usr/bin/env python3
"""Time the port's fused_filter_agg at Q2's row count, by group count.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 tools/time_filter_agg.py [--root DIR] [--label TEXT]

It builds ``fused_filter_agg.cu`` of DIR's ``src/repro_torch`` (default:
the checkout that holds this script) and prints its ptxas registers and
spill bytes, then one JSON line per group count G of GROUPS: 2,796,308
rows (Q2's, ``chip_smoke.py`` phase 2) with keys drawn over [0, G),
integer values in [0, 9) and a float filter over [0, 1) kept at >= 0.5,
all from ``chip_smoke.SEED``; each line has the kernel's device time (CUDA
events, L2 flushed, median of ``chip_smoke.TIMING_REPS``, launches queued
behind a sleep kernel), ``torch.bincount``'s on the kept rows, whether the
host queued each ahead of the card (``ahead``, ``bincount_ahead``: bincount
reads the largest key first, so it synchronises and never is), and
whether the kernel's sums and counts equal the plain version's (integer
values: exact).

The inputs and the timing are those of the ``chip_smoke.py`` beside this
script; only the kernel comes from DIR, so two commits compare on one
card: unpack the parent into a directory that .gitignore lists and run the
script on each tree in turns (parent, change, change, parent) in one
call.  It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROWS = 2_796_308
GROUPS = (64, 1024, 1025, 4096, 65536, 262144)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import torch

    if not torch.cuda.is_available():
        print("time_filter_agg.py: no CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    ops = importlib.import_module("repro_torch.kernels.fused_filter_agg.ops")
    ref = importlib.import_module("repro_torch.kernels.fused_filter_agg.ref")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or str(root)
    print(f"time_filter_agg: {label}: torch {torch.__version__} on [{smi}]", flush=True)
    ops.load()
    build = importlib.import_module("repro_torch.kernels.build")
    print(f"time_filter_agg: {label}: ptxas {json.dumps(cs.ptxas_report(build.BUILD_LOG))}",
          flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    vals = torch.randint(0, 9, (ROWS,), generator=gen, device=dev, dtype=torch.int32)
    filt = torch.rand(ROWS, generator=gen, device=dev)
    keep = filt >= 0.5
    for g in GROUPS:
        keys = torch.randint(0, g, (ROWS,), generator=gen, device=dev, dtype=torch.int32)
        kw = dict(op="ge", threshold=0.5, num_groups=g)
        s_k, c_k = ops.fused_filter_agg(keys, vals, filt, **kw)
        s_p, c_p = ref.fused_filter_agg_ref(keys, vals, filt, **kw)
        torch.cuda.synchronize()
        ok = bool(torch.equal(s_k, s_p) and torch.equal(c_k, c_p))
        mk, mv = keys[keep], vals[keep].to(torch.float32)
        t, ahead = cs.time_ms(torch, lambda: ops.fused_filter_agg(keys, vals, filt, **kw), flush)
        t_lib, ahead_lib = cs.time_ms(
            torch, lambda: torch.bincount(mk, weights=mv, minlength=g), flush)
        print(json.dumps({"tree": label, "num_groups": g, "rows": ROWS,
                          "passing_rows": int(keep.sum()), "ms": t, "bincount_ms": t_lib,
                          "ahead": ahead, "bincount_ahead": ahead_lib, "ok": ok,
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
