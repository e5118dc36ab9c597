"""Weights and token ids made from the seed, on the device, in a few calls.

The weights are the benchmark's own, in the reference's layout
(``perfbench/reference/lm.py``): ``embed`` (V, d), ``layers`` (a dict a
layer: ``norm1``, ``wq``, ``wk``, ``wv``, ``wo``, ``norm2``, ``gate``,
``up``, ``down``; matrices stored (d_in, d_out)), ``final_norm`` and
``head`` (d, V).  Every matrix is a view of one bf16 buffer drawn by a
single ``torch.randn`` on the card, then scaled in place; the norm scales
are views of one float32 draw.  The same seed gives the same values, and
both the program and the reference read these same tensors.

Scales: a matrix with d_in inputs is drawn at d_in ** -0.5, so that a
unit-RMS input gives unit-RMS outputs, as the port's own init does (a
head's scores then have a standard deviation of about 1); norm scales are
1 + 0.1 * N(0, 1).  Sharper attention (q and k drawn sqrt(3) times larger,
scores of deviation 3) makes the 32-layer model chaotic: bf16 rounding
alone then moves a score by a nat, and no limit parts it from float8.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from perfbench.reference.lm import RefShape

NORM_SPREAD = 0.1


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from a run's ``--seed`` (any whole
    number, of any size)."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(n, dtype=np.uint64)
    return [int(w) >> 1 for w in words]


def matrix_plan(shape: RefShape, n_layers: int) -> List[tuple]:
    """(key, layer or None, (d_in, d_out), scale) of every matrix, in the
    order the buffer holds them."""
    d, hd = shape.d_model, shape.d_head
    plan = [("embed", None, (shape.vocab, d), d ** -0.5)]
    for i in range(n_layers):
        plan += [
            ("wq", i, (d, shape.n_heads * hd), d ** -0.5),
            ("wk", i, (d, shape.n_kv_heads * hd), d ** -0.5),
            ("wv", i, (d, shape.n_kv_heads * hd), d ** -0.5),
            ("wo", i, (shape.n_heads * hd, d), (shape.n_heads * hd) ** -0.5),
            ("gate", i, (d, shape.d_ff), d ** -0.5),
            ("up", i, (d, shape.d_ff), d ** -0.5),
            ("down", i, (shape.d_ff, d), shape.d_ff ** -0.5),
        ]
    plan.append(("head", None, (d, shape.vocab), d ** -0.5))
    return plan


def make_weights(shape: RefShape, n_layers: int, seed: int, device) -> Dict[str, object]:
    """The model's weights from ``seed``: matrices in bf16, norm scales in
    float32, all on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seeds(seed, 2)[0])
    plan = matrix_plan(shape, n_layers)
    total = sum(a * b for _, _, (a, b), _ in plan)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    norms = torch.randn((2 * n_layers + 1, shape.d_model), generator=gen, device=device,
                        dtype=torch.float32).mul_(NORM_SPREAD).add_(1.0)
    weights: Dict[str, object] = {
        "layers": [{"norm1": norms[2 * i], "norm2": norms[2 * i + 1]} for i in range(n_layers)],
        "final_norm": norms[-1],
    }
    off = 0
    for key, i, (a, b), scale in plan:
        view = flat[off:off + a * b].view(a, b).mul_(scale)
        off += a * b
        if i is None:
            weights[key] = view
        else:
            weights["layers"][i][key] = view
    return weights


@dataclass
class TokenPool:
    """``batches`` (n, B, S) of token ids drawn over the vocabulary."""
    batches: torch.Tensor

    def __len__(self) -> int:
        return self.batches.shape[0]

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.batches[i % len(self)]


def make_tokens(vocab: int, n: int, batch: int, seq_len: int, seed: int, device) -> TokenPool:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seeds(seed, 2)[1])
    return TokenPool(torch.randint(vocab, (n, batch, seq_len), generator=gen, device=device))
