"""Serving engine: batched decode over a slot table, on one device.

The port of the JAX package's ``serve/engine.py``, step for step:

* slots: a fixed-capacity request table (ragged ``lengths``);
* admission: a new request claims a free slot between decode steps, its
  slot's cache is zeroed, and its prompt goes through the decode step one
  token at a time (the JAX engine has no blocked prefill either);
* every decode step runs the whole slot table: idle slots write k/v at
  their current length too, and only the live slots' lengths advance, so
  a stray write is overwritten by that slot's next real token (the cache
  update replaces) and a write at ``length >= max_len`` is dropped;
* stopping: after ``max_new_tokens`` tokens, or when the slot's length
  reaches ``max_len - 1``; greedy is ``argmax`` (first index on ties),
  and ``temperature > 0`` samples with ``rng.choice`` over a float32
  softmax from the numpy generator ``generate`` seeds.

Lengths live on the host (numpy) and are copied to the device for each
step; the JAX engine keeps them on the device and reads them back for the
stop rule.
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from repro_torch.models.lm import LM
from repro_torch.utils.device import DeviceLike, resolve_device

#: block kinds that carry a recurrent state instead of a KV cache
RECURRENT_KINDS = frozenset({"mlstm", "slstm", "rec"})


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    max_len: int = 256
    temperature: float = 0.0  # 0 = greedy


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 16
    # filled by the engine:
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serves ``model`` on ``device`` (None: the card, raising without
    one).  ``params``, when given, are the weights to serve as
    ``LM.state_dict()`` names them; they are assigned into ``model``
    without a copy.  With None the model serves the weights it holds.

    It refuses what the JAX engine refuses, on the same conditions: a
    model with parallel codebooks (the slot table holds one token a
    slot), and recurrent block kinds with ``max_batch != 1`` (their state
    updates are not gated by ``lengths``, so slots would leak into each
    other: recurrentgemma-9b's ``rec`` blocks).  With one slot, a new
    request's ``_reset_slot`` zeroes its recurrent state as it zeroes a
    KV cache."""

    def __init__(self, model: LM, params: Optional[Mapping[str, torch.Tensor]],
                 cfg: ServeConfig, device: DeviceLike = None):
        if model.cfg.n_codebooks > 1:
            raise NotImplementedError("the reference engine serves single-codebook LMs")
        kinds = {k for unit, _ in model.cfg.segments for k in unit}
        if kinds & RECURRENT_KINDS and cfg.max_batch != 1:
            raise NotImplementedError(
                "recurrent-state archs: use max_batch=1 in the reference engine")
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params, assign=True)
        self.model = model.to(self.device)  # no copy when it is there already
        self.cfg = cfg
        self.state = model.init_decode_state(cfg.max_batch, max_len=cfg.max_len)
        self.lengths = np.zeros((cfg.max_batch,), np.int32)
        self.free = list(range(cfg.max_batch))
        self._decode = model.decode_step

    def _reset_slot(self, slot: int) -> None:
        """Zero a slot's cache and length before reuse."""
        for block in self.state.values():
            for cache in block.values():
                for s in cache.values():
                    s[:, slot] = 0
        self.lengths[slot] = 0

    def _step(self, tokens: np.ndarray) -> torch.Tensor:
        logits, self.state = self._decode(
            self.state,
            torch.tensor(tokens, device=self.device),
            torch.tensor(self.lengths, device=self.device),
        )
        return logits

    # ------------------------------------------------------------ admission
    def admit(self, req: Request) -> bool:
        if not self.free:
            return False
        req.slot = self.free.pop(0)
        self._reset_slot(req.slot)
        # prefill: feed prompt tokens one step at a time through the same
        # decode path
        for tok in req.prompt:
            logits = self._step(self._slot_tokens(req.slot, int(tok)))
            self.lengths[req.slot] += 1
        req._next_logits = logits[req.slot, 0]
        return True

    def _slot_tokens(self, slot: int, token: int) -> np.ndarray:
        toks = np.zeros((self.cfg.max_batch, 1), np.int32)
        toks[slot, 0] = token
        return toks

    # --------------------------------------------------------------- decode
    def _sample(self, logits: torch.Tensor, rng: np.random.Generator) -> int:
        if self.cfg.temperature <= 0.0:
            return int(torch.argmax(logits))
        p = torch.softmax(logits.to(torch.float32) / self.cfg.temperature, dim=-1)
        p = p.cpu().numpy()
        return int(rng.choice(len(p), p=p / p.sum()))

    def step(self, live: List[Request], rng: np.random.Generator) -> None:
        """One synchronized decode step over all live requests."""
        if not live:
            return
        toks = np.zeros((self.cfg.max_batch, 1), np.int32)
        for req in live:
            nxt = self._sample(req._next_logits, rng)
            req.generated.append(nxt)
            toks[req.slot, 0] = nxt
        logits = self._step(toks)
        for req in live:
            req._next_logits = logits[req.slot, 0]
            self.lengths[req.slot] += 1
            if (
                len(req.generated) >= req.max_new_tokens
                or int(self.lengths[req.slot]) >= self.cfg.max_len - 1
            ):
                req.done = True
                self.free.append(req.slot)

    # ------------------------------------------------------------------ run
    def generate(self, requests: List[Request], *, seed: int = 0) -> List[Request]:
        rng = np.random.default_rng(seed)
        queue = list(requests)
        live: List[Request] = []
        while queue or live:
            while queue and self.free:
                req = queue.pop(0)
                if self.admit(req):
                    live.append(req)
            self.step(live, rng)
            live = [r for r in live if not r.done]
        return requests
