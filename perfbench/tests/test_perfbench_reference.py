"""The plain reference against the port on the CPU, and what a run imports.

* the reference (``perfbench/reference/lm.py``) and the port's ``LM.forward``
  (its CPU route, the flash kernel's plain version) agree at a small size of
  each configuration: to float32 rounding with the port in float32, and
  within bf16's reach with the port in bf16, as a cell runs it;
* nothing a run loads is ``jax``, ``jaxlib``, ``flax`` or the JAX package
  ``repro``, compared by the whole top-level name (``repro_torch`` is the
  port, not ``repro``), and the reference imports nothing of the port.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import job
from perfbench.reference import lm as reference
from perfbench.weights import make_tokens
from repro_torch.models.lm import LM

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def small(workload, small_cell):
    cell = small_cell(workload)
    return cell, cell.model.ref_shape(cell.config)


def port_model(cell, weights, dtype):
    cfg = dataclasses.replace(cell.model.lm_config(cell.config), compute_dtype=dtype)
    model = LM(cfg)
    sd = cell.model.state_dict(weights)
    model.load_state_dict({k: v.to(dtype) if v.dim() == 2 else v for k, v in sd.items()},
                          assign=True, strict=True)
    return model


@pytest.mark.parametrize("workload", ["yi-6b.score-4k", "h2o-danube-3-4b.score-4k"])
def test_the_reference_is_the_port_in_float32(workload, small_cell):
    cell, shape = small(workload, small_cell)
    weights = cell.model.make_weights(cell.config, 5, "cpu")
    tokens = make_tokens(shape.vocab, 1, cell.rows, cell.seq_len, 5, "cpu")[0]
    want = reference.logits_rows(weights, tokens, shape)
    got = port_model(cell, weights, torch.float32).forward(tokens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("workload", ["yi-6b.score-4k", "h2o-danube-3-4b.score-4k"])
def test_the_port_in_bf16_scores_within_reach_of_the_reference(workload, small_cell):
    cell, shape = small(workload, small_cell)
    weights = cell.model.make_weights(cell.config, 6, "cpu")
    tokens = make_tokens(shape.vocab, 1, cell.rows, cell.seq_len, 6, "cpu")[0]
    want = reference.score_rows(weights, tokens, shape)
    got = job.score_batch(port_model(cell, weights, torch.bfloat16).forward, tokens)
    gap = (got - want).abs()
    # bf16 keeps 8 bits: a score of about -6 moves by its rounding through
    # two layers; the cells' own limits are 0.5 (widest) and 0.1 (mean)
    assert gap.max() < 0.1 and gap.mean() < 0.02


def test_the_window_masks_what_it_should(small_cell):
    """Danube at the small size has a window of 16 in rows of 48: the
    reference without it differs, with it matches the port."""
    cell, shape = small("h2o-danube-3-4b.score-4k", small_cell)
    assert shape.window == 16 < cell.seq_len
    weights = cell.model.make_weights(cell.config, 7, "cpu")
    tokens = make_tokens(shape.vocab, 1, cell.rows, cell.seq_len, 7, "cpu")[0]
    port = port_model(cell, weights, torch.float32).forward(tokens)
    full = reference.logits_rows(weights, tokens, dataclasses.replace(shape, window=None))
    assert (port[:, 16:] - full[:, 16:]).abs().max() > 1e-2
    torch.testing.assert_close(port[:, :16], full[:, :16], rtol=1e-4, atol=1e-4)


def imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imported_names(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported_names(path)}
    assert tops <= {"__future__", "contextlib", "dataclasses", "typing", "torch"}, tops


_WHOLE_RUN = r'''
import dataclasses, sys, time
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1], sys.argv[1] + "/perfbench/tests"]
import torch
from perfbench import calibrate, harness, program, run
from conftest import _small_cell
program.check_widths = lambda cfg, port: None
for workload, traced in (("yi-6b.score-4k", False), ("h2o-danube-3-4b.score-4k", True)):
    result = harness.run_cell(_small_cell(workload), seed=3, seconds=0.2, traced_run=traced,
                              device=torch.device("cpu"), t0=time.perf_counter())
    assert result["correct"], result
leaked = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
assert not leaked, leaked
assert "repro_torch.models.lm" in sys.modules
print("ok")
'''


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", _WHOLE_RUN, str(ROOT)], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import perfbench.reference.lm; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro'}))")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stderr[-2000:]
