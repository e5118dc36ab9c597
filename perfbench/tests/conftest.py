"""The benchmark's tests: on the CPU at small sizes, and (marked ``card``)
on a CUDA device.  Run from the root of the repository:

    python -m pytest perfbench/tests -q
"""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run these on the card")
    return torch.device("cuda", 0)


#: small widths a configuration keeps its ratios at: (heads, kv heads, head
#: dim, d_ff) by configuration; two layers, 512 ids, windows of 48 tokens
SMALL = {"yi-6b": (8, 1, 32, 704), "h2o-danube-3-4b": (8, 2, 24, 512)}
#: Danube's window at the small size, so that the mask cuts rows of 48
SMALL_WINDOW = 16


def _small_cell(workload, *, layers=2, vocab=512, seq_len=48, rows=None, **traffic):
    """The cell ``workload`` at a size the CPU runs in a moment: the same
    kind of block, GQA group and mask, and windows a batch; small widths
    and windows; the cell's own limits."""
    from perfbench import spec

    cell = spec.load_cell(workload)
    heads, kv, d_head, d_ff = SMALL[cell.config["name"]]
    config = dict(cell.config, hidden_size=heads * d_head, intermediate_size=d_ff,
                  num_attention_heads=heads, num_key_value_heads=kv, head_dim=d_head,
                  num_hidden_layers=layers, vocab_size=vocab,
                  sliding_window=SMALL_WINDOW if cell.config["sliding_window"] else None)
    mix = dict(cell.traffic, seq_len=seq_len, tokens_per_batch=(rows or cell.rows) * seq_len,
               pool_batches=6,
               warmup_batches=1, trace_batches=2, **traffic)
    return dataclasses.replace(cell, config=config, traffic=mix)


@pytest.fixture
def unguarded(monkeypatch):
    """The width guard off, for cells at small sizes (its own test keeps it)."""
    from perfbench import program

    monkeypatch.setattr(program, "check_widths", lambda cfg, port: None)


@pytest.fixture
def small_cell():
    """``small_cell(workload, **sizes)``: a cell at a size the CPU runs in
    a moment (``_small_cell``)."""
    return _small_cell
