#!/usr/bin/env python3
"""Find inputs at which bf16 flash attention at scale 0 misses the bf16 flash rule.

At scale 0 every score is 0 and every p exactly 1, so the output is the
mean of v over the visible keys. The chunked bf16 route, the yardstick of
``chip_smoke.flash_bf16_close``, then equals the plain version exactly.
Twice its error, 0, would ask the kernel's float32 sums on the tensor cores
to round to the same bf16 as the plain version's, though the two sum in
another order; so where the route's error is exactly 0 the rule holds the
kernel to one bf16 ulp plus 1e-5, as every other bf16 kernel is held. The
probe counts the cases that miss the rule as ``flash_bf16_close`` has it.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 tools/flash_scale0_probe.py [--seeds N] [--first SEED] [--device cpu]

It builds ``flash_attention.cu`` and, for each seed from FIRST to
FIRST + N - 1, seeds a generator on the device with it and draws q, then
k, then v (standard normal, cast to bf16) at each shape of phase 5's scale
cases (``chip_smoke.SCALE_SHAPES``, B = 1, S = ``chip_smoke.SCALE_LEN``),
then runs each case of ``chip_smoke.FLASH_MASKS`` at scale 0 as phase 5
does. It prints one JSON line for each case that misses the rule (the seed,
shape and mask; the kernel's and the route's largest and mean error; how
many elements lie beyond 1e-5 and the first of them with both values), and
a last line with the totals. It exits 0 whatever it finds, and non-zero
without a CUDA device. ``--device cpu`` runs the wrapper's plain version
in place of the kernel, which meets the rule by construction.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=256)
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("flash_scale0_probe.py: no CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    fops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    fref = importlib.import_module("repro_torch.kernels.flash_attention.ref")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        cs.build_kernels((fops,))

    cases = failed = 0
    for seed in range(args.first, args.first + args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for d, h, hkv in cs.SCALE_SHAPES:
            q, k, v = (torch.randn(1, n, cs.SCALE_LEN, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (h, hkv, hkv))
            qy, _ = fops.positive_scale(q, 0.0)
            for causal, window in cs.FLASH_MASKS:
                kw = dict(causal=causal, window=window)
                got = fops.flash_attention(q, k, v, scale=0.0, **kw)
                want = fref.attention_ref(q, k, v, scale=0.0, **kw)
                ok, stats = cs.flash_bf16_close(torch, got, want, cs.flash_yardstick(qy, k, v, **kw))
                cases += 1
                if ok:
                    continue
                failed += 1
                err = (got.float() - want.float()).abs()
                first = [int(i) for i in torch.nonzero(err > 1e-5)[0]]
                print(json.dumps({
                    "seed": seed, "shape": [1, h, hkv, cs.SCALE_LEN, d], **kw,
                    "kernel_max_mean": stats[:2], "route_max_mean": stats[2:],
                    "elements_beyond_1e-5": int((err > 1e-5).sum()), "elements": err.numel(),
                    "first": first, "kernel_value": float(got[tuple(first)]),
                    "plain_value": float(want[tuple(first)])}), flush=True)
    print(json.dumps({"device": str(dev), "seeds": [args.first, args.first + args.seeds - 1],
                      "cases": cases, "failed": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
