"""What a cell is, read from data: ``BENCHMARK.json`` names the cell, its
configuration and its traffic mix; each is a file of its own under
``perfbench/`` that this module finds by name.

* ``perfbench/configs/<config>.json``: the model as published (the keys of
  its ``config.json``), the port's architecture it runs as
  (``port_arch``), ``reduced`` and ``assumed``;
* ``perfbench/traffic/<traffic>.json``: the mix (window length, tokens a
  batch, jobs in flight, batches drawn, traced and checked);
* ``perfbench/limits/<workload>.json``: the limit of each number the
  correctness check compares, with the readings it was set from;
* ``perfbench/metrics/<metric>.py``: one reader a per-layer metric, a
  function ``read(window)`` of a traced window (``perfbench/tracing.py``)
  that returns a number or None.

A later cell, mix or metric is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.  Nothing here imports the
program.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from perfbench import roofline
from perfbench.reference.lm import RefShape

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def seq_len(self) -> int:
        return int(self.traffic["seq_len"])

    @property
    def rows(self) -> int:
        """Windows of ``seq_len`` tokens a batch."""
        return int(self.traffic["tokens_per_batch"]) // self.seq_len

    @property
    def tokens_per_batch(self) -> int:
        return self.rows * self.seq_len


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files; a
    KeyError for a name it does not hold."""
    bench = bench or benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[entry["config"]]["file"])
    traffic = read_json(HERE / "traffic" / f"{entry['traffic']}.json")
    if int(traffic["tokens_per_batch"]) % int(traffic["seq_len"]):
        raise ValueError(f"{entry['traffic']}: tokens_per_batch is not a whole number of "
                         f"windows of seq_len")
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        limits=read_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
    )


def ref_shape(config: dict) -> RefShape:
    """The reference's view of a configuration."""
    return RefShape(
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_head=config["head_dim"],
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        window=config.get("sliding_window"),
    )


def work_shape(config: dict) -> roofline.Shape:
    """The roofline's view of a configuration."""
    return roofline.Shape(
        n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_head=config["head_dim"],
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        window=config.get("sliding_window"),
    )


def metric_reader(name: str) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``, loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    module_name = "perfbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"]) for m in cell.per_layer}
