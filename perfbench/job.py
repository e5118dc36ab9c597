"""The scoring job: windows of token ids through the program's forward,
reduced to the log-probability of each next token and copied to the host,
in a closed loop that keeps ``clients`` batches in flight.

A batch is issued, then the oldest in flight is waited for; when its
scores are on the host the next batch is issued.  A batch's latency runs
from its issue to its scores on the host.  The spans (``score.*``) mark
the job's steps for the traced run's breakdown.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.weights import TokenPool


def score_batch(forward: Callable, tokens: torch.Tensor) -> torch.Tensor:
    """log p(tokens[:, t + 1] | tokens[:, :t + 1]) for every t, (B, S - 1)
    in float32, from the logits ``forward`` gives for tokens (B, S)."""
    with record_function("score.forward"):
        logits = forward(tokens)
    with record_function("score.logprob"):
        x = logits[:, :-1].float()
        del logits
        gold = x.gather(-1, tokens[:, 1:, None])[..., 0]
        return gold - torch.logsumexp(x, dim=-1)


@dataclass
class LoopResult:
    start: float
    end: float
    latencies: List[float] = field(default_factory=list)
    #: batch index (in issue order) -> its scores (B, S - 1) on the host
    answers: Dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def batches(self) -> int:
        return len(self.latencies)


def closed_loop(forward: Callable, pool: TokenPool, *, clients: int,
                seconds: Optional[float] = None, batches: Optional[int] = None,
                on_done: Optional[Callable[[], None]] = None) -> LoopResult:
    """Issue batches ``pool[0], pool[1], ...`` while ``seconds`` have not
    passed since the first (or until ``batches`` are issued), at most
    ``clients`` in flight, and wait for every one issued."""
    rows, seq_len = pool.batches.shape[1:]
    cuda = pool.batches.device.type == "cuda"
    slots = [torch.empty((rows, seq_len - 1), dtype=torch.float32, pin_memory=cuda)
             for _ in range(clients)]
    inflight: deque = deque()
    issued = 0
    result = LoopResult(start=time.perf_counter(), end=0.0)

    def still_open() -> bool:
        if batches is not None:
            return issued < batches
        return time.perf_counter() - result.start < seconds

    while True:
        while len(inflight) < clients and still_open():
            t = time.perf_counter()
            slot = slots[issued % clients]
            slot.copy_(score_batch(forward, pool[issued]), non_blocking=cuda)
            done = torch.cuda.Event() if cuda else None
            if cuda:
                done.record()
            inflight.append((issued, t, done, slot))
            issued += 1
        if not inflight:
            break
        i, t, done, slot = inflight.popleft()
        with record_function("score.wait"):
            if cuda:
                done.synchronize()
        result.latencies.append(time.perf_counter() - t)
        result.answers[i] = slot.numpy().copy()
        if on_done is not None:
            on_done()
    result.end = time.perf_counter()
    return result
