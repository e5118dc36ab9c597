#!/usr/bin/env python3
"""Time the port's two attention kernels at the rows of PERF.md §6.

Run from the root of a checkout on a machine with one NVIDIA GPU and the
CUDA toolkit::

    python3 tools/time_attention.py [--root DIR] [--label TEXT] [--only TEXT]

It builds ``flash_attention.cu`` and ``decode_attention.cu`` of DIR's
``src/repro_torch`` (default: the checkout that holds this script) with the
port's nvcc flags, prints their ptxas registers and spill bytes and the
SASS counts of flash_wgmma<256>, of every flash_wgmma_any and flash_tf32
instance and of the wide kernels, decode_wide's included (wgmma
instructions, the waits on them: one after every HGMMA means ptxas
serialised them, mma.sync instructions and those in TF32, spill loads
and stores, the highest register), then one JSON
line per row: decode at full length and flash on one causal prompt for
every config of ``chip_smoke.ATTENTION_ROWS`` in bf16, the recurrent
hybrid's decode at its serve's length and its flash at its forward's
length, where the window masks; then the same decode and flash rows in
float32 at the configs of ``chip_smoke.FLOAT32_ARCHS``, and flash at head
dim 32 (heads ``chip_smoke.D32_HEADS``) in float32 and bf16, then float16
at 32 and bf16 at 16 (``chip_smoke.D32_TIMED``); then the rows
off the compiled widths in bf16 (``--only any`` keeps only them):
Phi-3-mini's ``chip_smoke.PHI3_HEADS``, head dim ``chip_smoke.NARROW_DIM``
(33, rows that are not whole 16-byte pieces) at 32/4,
``chip_smoke.ANY_TIMED_HEADS`` (32/4 x 160), and 32/4 at 100, 150, 90, 170,
210 and 250 (rows that are not whole 16-byte pieces; the wrapper pads
the last two), S = ``chip_smoke.FORWARD_LEN``,
causal; then the wide
rows, flash at head dim ``chip_smoke.WIDE_TIMED_DIM`` (S =
``chip_smoke.FORWARD_LEN``, causal) at the heads of
``chip_smoke.WIDE_TIMED_FLASH`` in bf16, float16 and float32, and decode
above 256 (``chip_smoke.WIDE_TIMED_DECODE``: 32/4 x 512, B = 4, S =
``chip_smoke.DECODE_LEN``, full length, in bf16, float16 and float32;
bf16 16/1 x 576, a slice tail; bf16 32/4 x 515, rows that are not whole
16-byte pieces) (``--only wide`` keeps only them). Each row names the
kernel DIR's wrapper launches
(``runs``) and has the device time (CUDA events, L2 flushed, median of
``chip_smoke.TIMING_REPS``, launches queued behind a sleep kernel), SDPA's
time on the same inputs (the wide rows add ``sdpa_expanded_ms``: SDPA on k
and v expanded to the q heads, which takes ``EFFICIENT_ATTENTION`` where
``enable_gqa`` falls back to ``MATH``), whether the host queued both ahead
of the card (``ahead``; where not, the times hold host gaps), and whether
the result held to the plain version (``close_enough`` for decode and for
flash in float32 or at head dims up to 32 or above 256, ``flash_bf16_close``
for bf16 and float16 flash at head dims 33 to 256: ``chip_smoke.p_rounded``).
``--only TEXT`` keeps the rows whose name matches the regular expression TEXT (a plain word matches
where the name holds it; the rows' inputs then differ from a full run's:
they draw from one generator in turn).

The rows, the timing, the rules and the ptxas parser are those of the
``chip_smoke.py`` beside this script; only the kernels come from DIR, so
the script runs on a parent that predates it.  To compare two commits on
one card, unpack the parent into a directory that .gitignore lists and run
the script on each tree in turns (parent, change, change, parent) in one
call.  It fails without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def sass_stats(cs, so: Path, pattern: str) -> dict:
    """``chip_smoke.sass_counts`` (wgmma instructions and the waits on them,
    mma.sync and its TF32 form, spills, the highest register) for each
    kernel of the library ``so`` whose mangled name matches ``pattern``,
    from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    sass = subprocess.run([str(Path(build.nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    return cs.sass_counts(sass, pattern)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(HERE)]
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_attention.py: no CUDA device", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    build = importlib.import_module("repro_torch.kernels.build")
    dops = importlib.import_module("repro_torch.kernels.decode_attention.ops")
    dref = importlib.import_module("repro_torch.kernels.decode_attention.ref")
    fops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    fref = importlib.import_module("repro_torch.kernels.flash_attention.ref")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or str(root)
    print(f"time_attention: {label}: torch {torch.__version__} on [{smi}]", flush=True)
    cs.build_kernels((fops, dops))
    stats = sass_stats(cs, build.built_path(fops.SOURCE),
                       r"flash_wgmmaI\w+Li(256|32)E|flash_wgmma_any|flash_tf32|_wide")
    print(f"time_attention: {label}: SASS flash_attention: {json.dumps(stats)}", flush=True)
    stats = sass_stats(cs, build.built_path(dops.SOURCE), r"decode_wide")
    print(f"time_attention: {label}: SASS decode_attention: {json.dumps(stats)}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    flush.zero_()  # its kernel's module loads here, not in the first row's queued loop
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def ms(fn):
        """(ms, ahead): ahead is false where the host fell behind the card
        while queuing the launches, so the time holds host gaps."""
        return cs.time_ms(torch, fn, flush)

    # half a second of products first, so the first row does not run while
    # the card's clocks still rise from idle
    x, t0 = randn(4096, 4096), time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    del x

    def report(kernel, row, got, sdpa, ok, runs, expanded=None):
        (t, ahead), (t_sdpa, ahead_sdpa) = ms(got), ms(sdpa)
        extra = {"sdpa_expanded_ms": ms(expanded)[0]} if expanded is not None else {}
        print(json.dumps({"tree": label, "kernel": kernel, "runs": runs, "row": row,
                          "ms": t, "sdpa_ms": t_sdpa, **extra, "ahead": ahead and ahead_sdpa,
                          "ok": ok, "card": smi}), flush=True)

    s = cs.DECODE_LEN
    bf16, f32 = torch.bfloat16, torch.float32
    decode_rows = [(arch, h, hkv, d, [s] * b, bf16)
                   for arch, (h, hkv, d, _, b) in cs.ATTENTION_ROWS.items()]
    h, hkv, d, _, b = cs.ATTENTION_ROWS[cs.HYBRID_ARCH]
    decode_rows.append((cs.HYBRID_ARCH, h, hkv, d,
                        [cs.HYBRID_PROMPT_LEN + cs.HYBRID_NEW_TOKENS] * b, bf16))
    decode_rows += [(arch, h, hkv, d, [s] * b, f32) for arch, (h, hkv, d, _, b) in
                    ((a, cs.ATTENTION_ROWS[a]) for a in cs.FLOAT32_ARCHS)]
    for arch, h, hkv, d, lens, dtype in decode_rows:
        b = len(lens)
        row = (f"{arch} {h}/{hkv} x {d}, B={b}, {str(dtype).split('.')[-1]}, "
               + ("full length" if lens[0] == s else f"length {lens[0]}"))
        if not re.search(args.only, row):
            continue
        q = randn(b, h, d, dtype=dtype)
        k, v = randn(b, hkv, s, d, dtype=dtype), randn(b, hkv, s, d, dtype=dtype)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        kernel = lambda: dops.decode_attention(q, k, v, lengths)  # noqa: E731
        ok = cs.close_enough(torch, kernel(), dref.decode_attention_ref(q, k, v, lengths))
        mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        report("decode_attention", row, kernel, lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                              attn_mask=mask, enable_gqa=True),
               ok, dops.decode_kernel(dtype, h // hkv, d))

    flash_rows = [(arch, h, hkv, d, cs.FORWARD_LEN, window, bf16)
                  for arch, (h, hkv, d, window, _) in cs.ATTENTION_ROWS.items()]
    h, hkv, d, window, _ = cs.ATTENTION_ROWS[cs.HYBRID_ARCH]
    flash_rows.append((cs.HYBRID_ARCH, h, hkv, d, cs.HYBRID_FORWARD_LEN, window, bf16))
    flash_rows += [(arch, h, hkv, d, cs.FORWARD_LEN, window, f32) for arch, (h, hkv, d, window, _)
                   in ((a, cs.ATTENTION_ROWS[a]) for a in cs.FLOAT32_ARCHS)]
    h, hkv = cs.D32_HEADS
    flash_rows += [("head dim 32", h, hkv, 32, cs.FORWARD_LEN, None, dt) for dt in (f32, bf16)]
    flash_rows += [(f"head dim {d}", h, hkv, d, cs.FORWARD_LEN, None, getattr(torch, name))
                   for d, name in cs.D32_TIMED]
    for arch, h, hkv, d, fs, window, dtype in flash_rows:
        row = (f"{arch} {h}/{hkv} x {d}, {str(dtype).split('.')[-1]}, S={fs}"
               + (f", window {window}" if window is not None and window < fs else ""))
        if not re.search(args.only, row):
            continue
        q = randn(1, h, fs, d, dtype=dtype)
        k, v = randn(1, hkv, fs, d, dtype=dtype), randn(1, hkv, fs, d, dtype=dtype)
        kw = dict(causal=True, window=window)
        kernel = lambda: fops.flash_attention(q, k, v, **kw)  # noqa: E731
        want = fref.attention_ref(q, k, v, **kw)
        wgmma = cs.p_rounded(dtype, d)
        ok = (cs.flash_bf16_close(torch, kernel(), want, cs.flash_yardstick(q, k, v, **kw))[0]
              if wgmma else cs.close_enough(torch, kernel(), want))
        del want
        if window is None or window >= fs:
            sdpa_kw = dict(is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(fs, device=dev)
            sdpa_kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                           & (pos[None, :] > pos[:, None] - window), enable_gqa=True)
        report("flash_attention", row, kernel, lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw), ok,
               fops.kernel_name(dtype, d))

    # the rows off the compiled widths (flash_wgmma_any), on no path:
    # Phi-3-mini's heads, head dim 33 (no padded copy) and 160;
    # then rows that are not whole 16-byte pieces at the narrow loader's
    # other geometries (100: a producer, 128-key tiles; 150 and 170: no
    # producer, 64-key tiles; 90: no producer, 128-key tiles) and above 192,
    # where the wrapper pads them (210, 250)
    for name, (h, hkv, d) in (("phi-3-mini", cs.PHI3_HEADS), ("head dim 33", (32, 4, cs.NARROW_DIM)),
                              ("head dim 160", cs.ANY_TIMED_HEADS),
                              *((f"head dim {n}", (32, 4, n)) for n in (100, 150, 250, 90, 170, 210))):
        row = f"any {name} {h}/{hkv} x {d}, bf16, S={cs.FORWARD_LEN}"
        if not re.search(args.only, row):
            continue
        q = randn(1, h, cs.FORWARD_LEN, d)
        k, v = randn(1, hkv, cs.FORWARD_LEN, d), randn(1, hkv, cs.FORWARD_LEN, d)
        kernel = lambda: fops.flash_attention(q, k, v, causal=True)  # noqa: E731
        ok = cs.flash_bf16_close(torch, kernel(), fref.attention_ref(q, k, v, causal=True),
                                 cs.flash_yardstick(q, k, v, causal=True, window=None))[0]
        report("flash_attention", row, kernel,
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
               ok, fops.kernel_label(bf16, d))

    # the wide rows: above head dim 256, on no path
    d, fs = cs.WIDE_TIMED_DIM, cs.FORWARD_LEN
    for dtype in (bf16, torch.float16, f32):
        for h, hkv in cs.WIDE_TIMED_FLASH:
            row = f"wide {h}/{hkv} x {d}, {str(dtype).split('.')[-1]}, S={fs}"
            if not re.search(args.only, row):
                continue
            q = randn(1, h, fs, d, dtype=dtype)
            k, v = randn(1, hkv, fs, d, dtype=dtype), randn(1, hkv, fs, d, dtype=dtype)
            kernel = lambda: fops.flash_attention(q, k, v, causal=True)  # noqa: E731
            ok = cs.close_enough(torch, kernel(), fref.attention_ref(q, k, v, causal=True))
            ek, ev = k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1)
            report("flash_attention", row, kernel,
                   lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                   ok, fops.kernel_label(dtype, d),
                   expanded=lambda: F.scaled_dot_product_attention(q, ek, ev, is_causal=True))
            del ek, ev
    # decode above head dim 256 (decode_wide), on no path: drawn after the
    # flash rows, so theirs keep their inputs
    for h, hkv, d, name in cs.WIDE_TIMED_DECODE:
        dtype = getattr(torch, name)
        row = f"wide decode {h}/{hkv} x {d}, B=4, {name}, S={s}, full length"
        if not re.search(args.only, row):
            continue
        q = randn(4, h, d, dtype=dtype)
        k, v = randn(4, hkv, s, d, dtype=dtype), randn(4, hkv, s, d, dtype=dtype)
        lengths = torch.full((4,), s, dtype=torch.int32, device=dev)
        kernel = lambda: dops.decode_attention(q, k, v, lengths)  # noqa: E731
        ok = cs.close_enough(torch, kernel(), dref.decode_attention_ref(q, k, v, lengths))
        ek, ev = k.repeat_interleave(h // hkv, dim=1), v.repeat_interleave(h // hkv, dim=1)
        report("decode_attention", row, kernel,
               lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, enable_gqa=True),
               ok, dops.decode_kernel(dtype, h // hkv, d),
               expanded=lambda: F.scaled_dot_product_attention(q[:, :, None], ek, ev))
        del ek, ev
    return 0


if __name__ == "__main__":
    sys.exit(main())
