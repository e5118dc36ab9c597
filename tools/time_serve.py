#!/usr/bin/env python3
"""Time phase 6's Yi-6B serve, the decode step's host clock.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 tools/time_serve.py [--root DIR] [--serves 3]

It builds Yi-6B at full size on the kernel route from DIR's
``src/repro_torch`` (default: the checkout that holds this script), with
random weights from ``chip_smoke.SEED``, and serves phase 6's requests
(``chip_smoke.yi_requests``: 6 prompts, ``chip_smoke.NEW_TOKENS`` new
tokens each, 4 slots of 4096) ``--serves`` times through
``chip_smoke.serve_requests``, printing one JSON line a serve with the
decode step's median and least host-clock seconds (each step ends in a
synchronise).  The requests and the timing are those of the
``chip_smoke.py`` beside this script; only the model code comes from DIR,
so two commits compare on one card: unpack the parent into a directory
that .gitignore lists and run the script on each tree in turns (parent,
change, change, parent) in one call.  It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--serves", type=int, default=3)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_serve.py: no CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("yi-6b"), use_flash_kernel=True)
    model = LM(cfg).init(torch.Generator(device="cuda").manual_seed(cs.SEED))
    decode_ops.load()
    prompts, _ = cs.yi_requests(np, torch, cfg.vocab)
    scfg = ServeConfig(max_batch=4, max_len=4096)
    for serve in range(args.serves):
        _, _, steps, _, wall = cs.serve_requests(torch, model, None, scfg, prompts,
                                                 cs.NEW_TOKENS)
        print(json.dumps({"root": str(root), "serve": serve, "steps": len(steps),
                          "decode_step_median_s": statistics.median(steps),
                          "decode_step_min_s": min(steps), "wall_s": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
