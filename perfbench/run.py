"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload yi-6b.score-4k --seed 7 --seconds 45 --trace 0

from the root of a checkout, on a machine with the chips the cell asks
for.  The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the correctness check
compared beside its limit; those are also the last lines of standard error.
The run fails, and prints no result, without a CUDA device, with fewer
devices than the cell asks for, outside a checkout that holds the port, or
when JAX or the JAX package was loaded.

Every cache a run writes lies at a fixed path under ``build/`` in the
checkout: the port's kernels (``build/kernels``), PyTorch's extensions and
Triton's and the CUDA driver's caches.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
#: top-level modules no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def fix_caches() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fix_caches()
    # the checkout's packages, and not this folder's modules as top-level ones
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        return fail(f"no port under {ROOT / 'src'}: run from a checkout of the repository")
    import torch

    from perfbench import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} asks for {cell.chips} devices, "
                    f"{torch.cuda.device_count()} found")
    import repro_torch
    import repro_torch.kernels.build as kernel_build

    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        return fail(f"repro_torch loaded from {repro_torch.__file__}, not this checkout")
    kernel_build.BUILD_DIR = BUILD / "kernels"

    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              traced_run=bool(args.trace), device=torch.device("cuda", 0),
                              t0=T0)
    leaked = loaded_forbidden()
    if leaked:
        return fail(f"the run loaded {', '.join(leaked)}")
    harness.log(f"device: {power_limit()}")
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
