"""Serving launcher: batched greedy generation for a ported arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \
      --prompts 3 --new-tokens 8 [--device cpu]

The weights are random, drawn from a seeded ``torch.Generator`` on the
device.  Without ``--device`` it runs on the card and fails without one.
Like the JAX launcher it refuses codebook LMs (musicgen), which the
engine does not serve, and gives recurrent archs one slot.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.models import LM
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import RECURRENT_KINDS
from repro_torch.utils.device import resolve_device


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"one of {[a.replace('_', '-') for a in PORTED]}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--prompts", type=int, default=3)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.n_codebooks > 1:
        raise SystemExit("codebook serving demo not wired; see tests")
    device = resolve_device(args.device)
    model = LM(cfg).init(torch.Generator(device=device).manual_seed(0))
    recurrent = RECURRENT_KINDS & {k for unit, _ in cfg.segments for k in unit}
    max_batch = 1 if recurrent else args.max_batch
    engine = ServeEngine(
        model, None, ServeConfig(max_batch=max_batch, max_len=64), device=device
    )
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=rng.integers(1, cfg.vocab, rng.integers(1, 5)).astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.prompts)
    ]
    engine.generate(reqs)
    for i, r in enumerate(reqs):
        print(f"req{i}: {r.prompt.tolist()} -> {r.generated}")


if __name__ == "__main__":
    main()
