"""What a cell is, read from data: ``BENCHMARK.json`` names the cell, its
configuration and its traffic mix; each is a file of its own under
``perfbench/`` that this module finds by name.

* ``perfbench/configs/<config>.json``: the model as published (the keys of
  its ``config.json``), the model module it runs as (``model``), the
  port's architecture (``port_arch``), ``reduced`` and ``assumed``;
* ``perfbench/models/<model>.py``: what turns the configuration into work,
  loaded by its path and kept on the cell (``Cell.model``).  It gives

  - ``ref_shape(config)``: the reference's view of the configuration; its
    ``vocab`` is the range the token ids are drawn over;
  - ``make_weights(config, seed, device)``: the weights from the seed, on
    the device, drawn with ``perfbench/weights.py``'s helpers and laid out
    as the reference reads them;
  - ``port_config(config)``: the program's configuration, refused where
    the port's own registry differs from the file in a width;
  - ``build(cfg, weights)``: the program holding those weights, whose
    ``forward(tokens)`` gives logits (B, S, V) for token ids (B, S);
  - ``score_rows(weights, rows, shape, rounding=None)``: the plain
    reference's log-probabilities (R, S - 1) of the next tokens of
    ``rows`` (R, S), every product's operands put through ``rounding``
    where one is given.  The reference lives in
    ``perfbench/reference/<name>.py`` and imports nothing of the program;
  - ``control()``: the rounding of the control, the precision below the
    one the configuration states;
  - ``batch_flops(config, rows, seq_len)``: the model FLOPs of one forward
    over a batch (rows, seq_len);
  - ``flash_launch_bound_s(config, rows, seq_len)``: the least time one
    ``flash_*`` launch of that forward can take, or None for a model that
    launches none;

* ``perfbench/traffic/<traffic>.json``: the mix (window length, tokens a
  batch, jobs in flight, batches drawn, traced and checked);
* ``perfbench/limits/<workload>.json``: the limit of each number the
  correctness check compares, with the readings it was set from;
* ``perfbench/metrics/<metric>.py``: one reader a per-layer metric, a
  function ``read(window)`` of a traced window (``perfbench/tracing.py``)
  that returns a number or None.

A later cell, mix, metric or model is a new file and a new entry in
``BENCHMARK.json``; nothing here changes.  Nothing here imports the
program; a model module does.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: a model module's name, as the contract has every name
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    model: ModuleType
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
    traffic = read_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json")
    if int(traffic["tokens_per_batch"]) % int(traffic["seq_len"]):
        raise ValueError(f"{entry['traffic']}: tokens_per_batch is not a whole number of "
                         f"windows of seq_len")
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        model=model_module(config, root),
        traffic=traffic,
        limits=read_json(root / "perfbench" / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
    )


def load_module(path: Path, module_name: str) -> ModuleType:
    """The module of the file ``path``, loaded by its path as
    ``module_name``."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def model_module(config: dict, root: Path = ROOT) -> ModuleType:
    """``perfbench/models/<model>.py`` under ``root``, for the ``model`` the
    configuration names; a configuration that names none is refused, so
    that no model falls silently onto another's path."""
    name = config.get("model")
    if name is None:
        raise ValueError(f"{config.get('name')}: the configuration names no model module "
                         f"(its \"model\" key, a file perfbench/models/<model>.py)")
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{config.get('name')}: {name!r} is not a model module's name")
    path = root / "perfbench" / "models" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{config.get('name')}: no model module {path}")
    return load_module(path, "perfbench_model_" + re.sub(r"\W", "_", name))


def metric_reader(name: str) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``, loaded by its path."""
    path = HERE / "metrics" / f"{name}.py"
    return load_module(path, "perfbench_metric_" + re.sub(r"\W", "_", name)).read


def metric_readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: metric_reader(m["name"]) for m in cell.per_layer}
