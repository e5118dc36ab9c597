"""Weights and token ids made from the seed, on the device, in a few calls.

A model module (``perfbench/models/<model>.py``) lays its weights out as
its reference reads them and draws them with these helpers: a plan of
matrices, each a view of one bf16 buffer drawn by a single ``torch.randn``
on the card and then scaled in place, and norm scales as views of one
float32 draw, both from one generator seeded from the run's ``--seed``.
The same seed gives the same values, and both the program and the
reference read these same tensors.

Scales: a matrix with d_in inputs is drawn at d_in ** -0.5, so that a
unit-RMS input gives unit-RMS outputs, as the port's own init does (a
head's scores then have a standard deviation of about 1); norm scales are
1 + 0.1 * N(0, 1).  Sharper attention (q and k drawn sqrt(3) times larger,
scores of deviation 3) makes the 32-layer model chaotic: bf16 rounding
alone then moves a score by a nat, and no limit parts it from float8.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

NORM_SPREAD = 0.1


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from a run's ``--seed`` (any whole
    number, of any size)."""
    words = np.random.SeedSequence(abs(int(seed))).generate_state(n, dtype=np.uint64)
    return [int(w) >> 1 for w in words]


def generator(seed: int, device) -> torch.Generator:
    """The weights' generator: the first of the seed's two sub-seeds (the
    token ids take the second)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seeds(seed, 2)[0])
    return gen


def matrices(gen: torch.Generator, plan: Sequence[Tuple[Tuple[int, ...], float]],
             device) -> List[torch.Tensor]:
    """One bf16 view a ``(shape, scale)`` of ``plan``, in its order: one
    ``torch.randn`` over the whole buffer, then each view scaled in place."""
    total = sum(math.prod(shape) for shape, _ in plan)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.bfloat16)
    views, off = [], 0
    for shape, scale in plan:
        n = math.prod(shape)
        views.append(flat[off:off + n].view(shape).mul_(scale))
        off += n
    return views


def norm_scales(gen: torch.Generator, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Norm scales ``1 + NORM_SPREAD * N(0, 1)``, float32, in one draw."""
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(NORM_SPREAD).add_(1.0)


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
