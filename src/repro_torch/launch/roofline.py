"""Roofline analysis of the dry-run's counts, on the NVIDIA H100 SXM's
figures.

Per (arch × shape × mesh) cell, three terms in SECONDS per step:

  compute    = FLOPs/device       / 989e12  (dense bf16 tensor-core peak)
  memory     = bytes/device       / 3.35e12 (HBM3)
  collective = wire_bytes/device  / 450e9   (NVLink 4, one direction)

The figures are NVIDIA's data sheet for the H100 SXM at its 700 W limit
(the card ``chip_smoke.py`` runs on; a card set below 700 W is slower).
Every product is counted at the bf16 peak, float32 ones too (the RG-LRU
gates, MLA's dense attention, the xLSTM scans), so the compute term is a
lower bound.  The counts come from ``repro_torch.launch.dryrun``, which
already holds every layer and every step of a time loop (it counts depth
and sequence variants and :func:`extrapolate`s them, the way the JAX
roofline does for XLA's scan bodies); this module adds

  MODEL_FLOPS       6·N_active·D (train) or 2·N_active·D_tokens (serve)
  useful ratio      MODEL_FLOPS / counted FLOPs  (remat/dispatch overheads)

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline            # single-pod cells
  PYTHONPATH=src python -m repro_torch.launch.roofline --mesh all --arch yi-6b

It reads ``results/torch_dryrun.json`` and writes
``results/torch_roofline.json`` and ``.md``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: dense bf16 tensor-core FLOP/s of one H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = 989e12
#: float32 FLOP/s outside the tensor cores (H100 SXM data sheet)
FP32_FLOPS = 67e12
#: dense TF32 tensor-core FLOP/s of one H100 SXM (NVIDIA data sheet); a
#: float32-accurate product split into three TF32 products runs at a third
TF32_FLOPS = 494.7e12
#: HBM3 bytes/s of one H100 SXM
HBM_BW = 3.35e12
#: NVLink 4 bytes/s a card sends in one direction (900 GB/s both ways)
LINK_BW = 450e9

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results"
DRYRUN_PATH = RESULTS_DIR / "torch_dryrun.json"
ROOFLINE_PATH = RESULTS_DIR / "torch_roofline.json"


# ------------------------------------------------------- analytic FLOPs
def active_params(cfg) -> Tuple[int, int]:
    """(total_params, active_params) from an LMConfig, analytically, over
    the JAX-layout tree (``LM.init_params`` on meta tensors)."""
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import flatten_with_paths

    total = 0
    expert_total = 0
    for path, leaf in flatten_with_paths(LM(cfg).init_params(None)).items():
        n = int(np.prod(leaf.shape))
        total += n
        if "/experts/" in path:
            expert_total += n
    if cfg.num_experts:
        active = total - expert_total + expert_total * cfg.top_k // cfg.num_experts
    else:
        active = total
    return total, active


def model_flops(cfg, shape, kind: str) -> float:
    """6·N_active·D for train; 2·N_active per generated/processed token."""
    _, active = active_params(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * active * tokens


# ----------------------------------------------------------- variants
def variant_config(cfg, reps: List[int]):
    """``cfg`` with segment i cut to ``reps[i]`` units: the depth
    variants the dry-run counts and :func:`extrapolate` takes to the full
    depth.  (The JAX roofline expands a segment into ``reps[i]`` separate
    segments instead, since XLA's cost analysis counts a scan body once;
    the port counts every layer it runs, so a segment keeps its stack
    and the variants' trees keep the full config's paths.)"""
    segments = tuple((unit, r) for (unit, _), r in zip(cfg.segments, reps))
    n_layers = sum(len(u) * c for u, c in segments)
    return dataclasses.replace(cfg, segments=segments, n_layers=n_layers)


def extrapolate(var: Dict[str, Any], field: str) -> float:
    """total = v0 + sum_i (count_i - 1) * (v_i - v0)."""
    v0 = var["v0"][field]
    total = v0
    for i, count in enumerate(var["counts"]):
        vi = var[f"v{i + 1}"][field]
        total += (count - 1) * max(vi - v0, 0.0)
    return total


# -------------------------------------------------------------- reporting
def bottleneck_hint(dom: str, arch: str, kind: str) -> str:
    hints = {
        "compute": "raise arithmetic efficiency: cut remat recompute and "
                   "dispatch overhead so counted FLOPs approach 6·N·D, or trade "
                   "memory for less remat",
        "memory": "cut bytes: fuse elementwise chains (one kernel a chain), "
                  "bf16 master/state, wider sequence sharding so activations "
                  "stream fewer HBM round-trips",
        "collective": "re-balance sharding: move collectives off the step "
                      "critical path (overlap with compute), hierarchical "
                      "reduce, or shift TP→DP to shrink per-step traffic",
    }
    return hints[dom]


def cell_terms(rec: Dict[str, Any]) -> Dict[str, float]:
    """The three terms, in seconds, of one dry-run record."""
    wire = sum(c["wire_bytes"] for c in rec["collectives"].values())
    return {
        "compute": rec["flops_per_device"] / PEAK_FLOPS,
        "memory": rec["bytes_per_device"] / HBM_BW,
        "collective": wire / LINK_BW,
    }


def cell_report(rec: Dict[str, Any], cfg, shape) -> Dict[str, Any]:
    """One record's roofline: its terms, the dominant one and its bound,
    the model FLOPs and how much of the counted work they are."""
    chips = int(np.prod(list(rec["mesh"].values())))
    terms = cell_terms(rec)
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(cfg, shape, rec["kind"])
    flops_dev = rec["flops_per_device"]
    useful_s = (mf / chips) / PEAK_FLOPS
    return {
        "chips": chips,
        "terms_s": terms,
        "dominant": dom,
        "bound_s": bound,
        "model_flops": mf,
        "counted_flops_global": flops_dev * chips,
        "useful_ratio": mf / max(flops_dev * chips, 1.0),
        "roofline_fraction": useful_s / max(bound, 1e-30),
        "memory_fit_gb": (
            (rec["memory"]["argument_bytes"] or 0) + (rec["memory"]["temp_bytes"] or 0)
        ) / 2**30,
        "hint": bottleneck_hint(dom, rec["arch"], rec["kind"]),
    }


def build_report(
    dryrun: Optional[Dict[str, Any]] = None,
    *,
    mesh_filter: Optional[str] = None,
    archs: Optional[List[str]] = None,
    path: Optional[Path] = ROOFLINE_PATH,
) -> Dict[str, Any]:
    """The roofline of every dry-run cell (``dryrun``: the records by key,
    else ``results/torch_dryrun.json``), written to ``path`` unless it is
    None."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES

    if dryrun is None:
        dryrun = json.loads(DRYRUN_PATH.read_text()) if DRYRUN_PATH.exists() else {}
    report: Dict[str, Any] = {}
    for key, rec in sorted(dryrun.items()):
        arch, shape_name, mesh_name = key.split("@")[0].split("/")
        if mesh_filter and mesh_name != mesh_filter:
            continue
        if archs and arch not in archs:
            continue
        if rec.get("skipped"):
            report[key] = {"skipped": rec["skipped"]}
            continue
        if not rec.get("ok"):
            report[key] = {"error": rec.get("error", "?")}
            continue
        report[key] = cell_report(rec, get_config(arch), SHAPES[shape_name])
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1, sort_keys=True))
    return report


def markdown_table(report: Dict[str, Any]) -> str:
    lines = [
        "| cell | chips | compute s | memory s | collective s | dominant | "
        "useful ratio | roofline frac | fit GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in sorted(report.items()):
        if "skipped" in r:
            lines.append(f"| {key} | — | — | — | — | skipped | — | — | — |")
            continue
        if "error" in r:
            lines.append(f"| {key} | — | — | — | — | ERROR | — | — | — |")
            continue
        t = r["terms_s"]
        lines.append(
            f"| {key} | {r['chips']} | {t['compute']:.3e} | {t['memory']:.3e} "
            f"| {t['collective']:.3e} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} "
            f"| {r['memory_fit_gb']:.1f} |"
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "all"])
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)
    mesh_filter = None if args.mesh == "all" else args.mesh
    archs = [args.arch.replace("-", "_")] if args.arch else None
    report = build_report(mesh_filter=mesh_filter, archs=archs)
    table = markdown_table(report)
    print(table)
    (RESULTS_DIR / "torch_roofline.md").write_text(table)


if __name__ == "__main__":
    main()
