"""``correct`` comes out false when it should: each run below is a whole run
of a cell but for the look for a chip (``harness.run_cell`` on the CPU, at
a small size, with the cell's own limits), with the timed path broken
underneath, or with the control in the program's place.  A sound run of
the same cell comes out true, so that a false is the fault's doing."""
import time

import pytest
import torch

from perfbench import harness, spec
from perfbench.reference import lm as reference

CELLS = ["yi-6b.score-4k", "h2o-danube-3-4b.score-4k", "yi-6b.score-512"]
CPU = torch.device("cpu")
#: large enough that the float8 control's mean gap passes the cells' limit
#: of 0.1 nats at this small size (it reads 0.137-0.167 on seeds 1-4)
CONTROL_SIZE = dict(layers=8, seq_len=96, vocab=2048)


def run(cell, make_forward=None, seed=2**31 + 11):
    return harness.run_cell(cell, seed=seed, seconds=0.2, traced_run=False, device=CPU,
                            t0=time.perf_counter(), make_forward=make_forward)


def half_batch(model, weights):
    """Half of the batch left out: the first half's rows stand in for the rest."""
    def forward(tokens):
        half = model.forward(tokens[: tokens.shape[0] // 2])
        return torch.cat([half, half])
    return forward


def token_altered(model, weights):
    """One token of each row altered on its way into the model."""
    def forward(tokens):
        tokens = tokens.clone()
        mid = tokens.shape[1] // 2
        tokens[:, mid] = (tokens[:, mid] + 1) % model.cfg.vocab
        return model.forward(tokens)
    return forward


def answer_altered(model, weights):
    """One answer of each row altered where it is produced: at position 5
    the logit of the next token is 2 too high."""
    def forward(tokens):
        logits = model.forward(tokens).clone()
        rows = torch.arange(tokens.shape[0])
        logits[rows, 5, tokens[:, 6]] += 2.0
        return logits
    return forward


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, small_cell, unguarded):
    result = run(small_cell(workload))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 2


@pytest.mark.parametrize("fault", [half_batch, token_altered, answer_altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, small_cell, unguarded):
    assert run(small_cell(workload))["correct"]
    result = run(small_cell(workload), make_forward=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_is_not_correct(workload, seed, small_cell, unguarded):
    """The reference in the program's place, its products' operands in
    float8 e4m3 (the precision below the bf16 the configurations state)."""
    cell = small_cell(workload, **CONTROL_SIZE)
    shape = cell.model.ref_shape(cell.config)

    def control(model, weights):
        return lambda tokens: reference.logits_rows(weights, tokens, shape, reference.Float8())

    assert run(cell, seed=seed)["correct"]
    result = run(cell, make_forward=control, seed=seed)
    assert not result["correct"], result["checks"]
    assert result["checks"]["mean_gap"]["value"] > result["checks"]["mean_gap"]["limit"]


def test_a_score_that_is_not_finite_fails(small_cell, unguarded):
    def nan_row(model, weights):
        def forward(tokens):
            logits = model.forward(tokens).clone()
            logits[0, 3, 0] = float("nan")
            return logits
        return forward

    result = run(small_cell(CELLS[0]), make_forward=nan_row)
    assert not result["correct"] and result["failed"] == result["attempted"]
