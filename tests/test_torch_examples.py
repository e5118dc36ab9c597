"""The port's editions of ``examples/`` against the JAX editions.

* ``torch_quickstart``, ``torch_taxi_pipeline`` and
  ``torch_reasonable_scale`` print exactly what their JAX editions print
  (queries, tables, plans, io counts, verdicts), on the CPU;
* ``torch_train_lm`` (tiny, 20 steps, killed and resumed) and
  ``torch_serve_lm`` run the same flows as the JAX editions.  Their
  weights come from different generators (torch's and JAX's), so their
  numbers differ: each package's final loss must pass the audit (below
  log V), and the two final losses must be within 0.25 nats of each
  other (they measured 5.476 and 5.561 nats at 20 steps); the served
  requests have the JAX edition's prompts and lengths;
* ``repro_torch.cli lint --strict`` finds the two pipeline editions clean
  (the mirror of ``test_lint.py::test_examples_lint_clean``);
* at the default device, with no card, an edition refuses to run.
"""
import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples_data import TAXI_SCHEMA, make_taxi_data

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "taxi_pipeline", "reasonable_scale"])
def test_edition_prints_what_the_jax_edition_prints(name, capsys):
    _load(name).main()
    want = capsys.readouterr().out
    port = _load(f"torch_{name}")
    port.main() if name == "reasonable_scale" else port.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert got.strip()


def _final_loss(text):
    return float(re.search(r"final loss ([\d.]+)", text).group(1))


def test_train_lm_edition_against_the_jax_edition(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--tiny", "--steps", "20"])
    _load("train_lm").main()
    want = capsys.readouterr().out
    out = _load("torch_train_lm").main(["--tiny", "--steps", "20", "--device", "cpu"])
    got = capsys.readouterr().out
    vocab = 2048
    for text in (want, got):
        assert "[phase1] crashed at step 11" in text
        assert "[phase2] resumed, ran 9 more steps" in text
        assert _final_loss(text) < np.log(vocab)
    assert abs(_final_loss(got) - _final_loss(want)) <= 0.25
    assert len(out["phase1"]) == 11 and len(out["phase2"]) == 9
    assert out["phase2"][-1] < out["phase1"][0]  # the loss falls
    assert out["tables"] == ["corpus", "models/lm-3m/checkpoint"]
    assert re.search(r"promoted checkpoint to main @ \w+: \['corpus', "
                     r"'models/lm-3m/checkpoint'\]", want)


def test_serve_lm_edition_against_the_jax_edition(capsys):
    _load("serve_lm").main()
    want = capsys.readouterr().out
    reqs = _load("torch_serve_lm").main(["--device", "cpu"])
    got = capsys.readouterr().out
    for text in (want, got):
        assert "serving checkpoint from step 30" in text
    pattern = re.compile(r"req(\d): prompt=(\[[\d, ]*\]) -> \[([\d, ]*)\]")
    want_reqs = pattern.findall(want)
    got_reqs = pattern.findall(got)
    assert [(i, p) for i, p, _ in got_reqs] == [(i, p) for i, p, _ in want_reqs]
    assert all(len(g.split(",")) == 8 for _, _, g in got_reqs)
    assert all(len(r.generated) == 8 and all(0 <= t < 512 for t in r.generated) for r in reqs)


def test_pipeline_editions_lint_clean(tmp_path, rng, capsys):
    """The mirror of ``tests/test_lint.py::test_examples_lint_clean``."""
    from repro_torch.api import Client
    from repro_torch.cli import main

    with Client(tmp_path / "lake", device="cpu") as c:
        c.write_table("taxi_table", make_taxi_data(200, rng), schema=TAXI_SCHEMA)
        c.write_table(
            "orders",
            {
                "user_id": rng.integers(0, 100, 500).astype(np.int32),
                "amount": (rng.random(500) * 200).astype(np.float32),
                "country": rng.integers(0, 30, 500).astype(np.int32),
            },
        )
    for example in ("examples/torch_taxi_pipeline.py", "examples/torch_quickstart.py"):
        main(["--device", "cpu", "--lake", str(tmp_path / "lake"), "lint",
              str(ROOT / example), "--strict"])
        assert "preflight clean" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_taxi_pipeline", "torch_train_lm",
                                  "torch_serve_lm"])
def test_edition_needs_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main(["--tiny"] if name == "torch_train_lm" else [])
