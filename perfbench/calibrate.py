"""The readings a cell's limits are set from, many seeds in one process.

    python3 perfbench/calibrate.py --workload yi-6b.score-4k --seeds 11-22 --control 11-14

For each seed of ``--seeds`` it makes the run's weights and token ids,
drives the program through a short closed loop at the cell's own load
(``clients`` in flight, ``calibrate_batches`` batches, 8 when the mix does
not say), draws the batches to check from the seed as a run does, and
compares the program's scores with the reference's.  For each seed of
``--control`` it puts the control in the program's place: the reference
with every product's operands in the precision below the one the
configuration states (the model module's ``control()``: float8 e4m3 below
bf16 for the Llama cells), on the same rows.  One JSON line a reading; the
benchmark's own runs never run this.  It needs the card, as a run does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    args = ap.parse_args(argv)
    # the checkout's packages, and not this folder's modules as top-level ones
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]
    import numpy as np
    import torch

    from perfbench import check, job, spec
    from perfbench.run import BUILD
    from perfbench.weights import make_tokens

    import repro_torch.kernels.build as kernel_build

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    kernel_build.BUILD_DIR = BUILD / "kernels"
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    cfg = cell.model.port_config(cell.config)
    shape = cell.model.ref_shape(cell.config)
    traffic = cell.traffic
    n = int(traffic.get("calibrate_batches", 8))
    control = set(seed_list(args.control))
    for seed in sorted(set(seed_list(args.seeds)) | control):
        weights = cell.model.make_weights(cell.config, seed, device)
        pool = make_tokens(shape.vocab, n, cell.rows, cell.seq_len, seed, device)
        picked = check.sample(seed, n, int(traffic["check_batches"]))
        rows = torch.cat([pool[i] for i in picked])
        lines = []
        if seed in set(seed_list(args.seeds)):
            model = cell.model.build(cfg, weights)
            loop = job.closed_loop(model.forward, pool, clients=int(traffic["clients"]),
                                   batches=n)
            got = np.concatenate([loop.answers[i] for i in picked])
            del model, loop
            lines.append(("program", got))
        torch.cuda.empty_cache()
        t = time.perf_counter()
        want = cell.model.score_rows(weights, rows, shape).cpu().numpy()
        ref_s = time.perf_counter() - t
        if seed in control:
            lines.append(("control", cell.model.score_rows(weights, rows, shape,
                                                           cell.model.control()).cpu().numpy()))
        for side, got in lines:
            print(json.dumps({"workload": cell.name, "seed": seed, "side": side,
                              "reference_s": ref_s, **check.readings(got, want)}), flush=True)
        del weights, pool, rows
        torch.cuda.empty_cache()
    print(f"device: {torch.cuda.get_device_name(device)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
