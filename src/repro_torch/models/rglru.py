"""RG-LRU recurrent block (Griffin / RecurrentGemma).

The port of the JAX package's ``models/rglru.py``.  The Real-Gated Linear
Recurrent Unit:

    r_t = sigmoid(W_a x_t)                      (recurrence gate)
    i_t = sigmoid(W_x x_t)                      (input gate)
    log a_t = c * r_t * log(sigmoid(Lambda))    (elementwise decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

wrapped in the Griffin structure: linear in -> causal depthwise conv
(width 4) -> LRU, times a GeLU gate branch, then linear out.

The recurrence is linear, so the full sequence runs as an associative
scan.  Torch has no ``lax.associative_scan``; :func:`associative_scan`
writes out the same recursion (combine adjacent pairs, scan the halved
sequence, fill in the even positions, interleave), so the combines happen
in JAX's order: log2(S) levels of elementwise passes over the whole
batch, never a loop over positions.  It is plain torch, so autograd
differentiates through it (``LM.loss``).  Decode is one O(1) update of
the state ``h`` (B, d_rnn) and the conv history (B, width - 1, d_rnn),
both float32, in place.

Precision, as the JAX code has it: the gates' projections ``w_a`` and
``w_x`` take float32 operands (``linear(..., compute_dtype=float32)``),
so the serving ``LM`` keeps their weights in ``param_dtype``
(:data:`FLOAT32_LINEARS`); ``conv`` and ``lam`` are read as float32 at
every use and stay in ``param_dtype`` too.  The full-sequence conv output
is rounded to the compute dtype before the gates (``_causal_conv``); the
decode step's is not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, device_of, init_linear, linear

_C = 8.0

#: the block's linears whose products take float32 operands: their weights
#: stay in param_dtype in the serving LM (every other ``w`` is stored cast)
FLOAT32_LINEARS = ("w_a", "w_x")


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int  # recurrence width (== d_model for recurrentgemma)
    conv_width: int = 4
    compute_dtype: Any = torch.bfloat16


def init_rglru(generator, cfg: RGLRUConfig, *, dtype=torch.float32) -> Params:
    """The JAX ``init_rglru``'s shapes and scales, drawn in its key order
    from one stream (meta tensors when ``generator`` is None): Lambda so
    that a = sigmoid(Lambda)^c is spread in (0.9, 0.999)."""
    d, dr = cfg.d_model, cfg.d_rnn
    dev = device_of(generator)
    w_in = init_linear(generator, d, dr, dtype=dtype)
    w_gate = init_linear(generator, d, dr, dtype=dtype)
    w_a = init_linear(generator, dr, dr, dtype=dtype)
    w_x = init_linear(generator, dr, dr, dtype=dtype)
    if generator is None:
        lam = torch.empty((dr,), dtype=dtype, device=dev)
        conv = torch.empty((cfg.conv_width, dr), dtype=dtype, device=dev)
    else:
        u = 0.9 + 0.099 * torch.rand((dr,), generator=generator, device=dev)
        lam = torch.log(u ** (1.0 / _C) / (1 - u ** (1.0 / _C))).to(dtype)
        conv = (torch.randn((cfg.conv_width, dr), generator=generator, device=dev)
                * 0.1).to(dtype)
    w_out = init_linear(generator, dr, d, dtype=dtype, scale=dr**-0.5)
    return {"w_in": w_in, "w_gate": w_gate, "conv": conv, "w_a": w_a, "w_x": w_x,
            "lam": lam, "w_out": w_out}


def _causal_conv(p: Params, cfg: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time in float32, rounded back to x's
    dtype.  x: (B, S, dr)."""
    w = p["conv"].to(torch.float32)  # (W, dr)
    pad = cfg.conv_width - 1
    xp = F.pad(x.to(torch.float32), (0, 0, pad, 0))
    s = x.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, cfg.conv_width):  # the JAX sum's order
        out = out + xp[:, i:i + s] * w[i]
    return out.to(x.dtype)


def _lru_gates(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., dr) float32 -> (a, the gated input), float32."""
    r = torch.sigmoid(linear(p["w_a"], x, compute_dtype=torch.float32))
    i = torch.sigmoid(linear(p["w_x"], x, compute_dtype=torch.float32))
    log_a = _C * r * F.logsigmoid(p["lam"].to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-8)) * (i * x)
    return a, gated


def _combine(left, right):
    """(a1, b1) then (a2, b2): h -> a2 (a1 h + b1) + b2."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even at positions 0, 2, ... and odd at 1, 3, ... along dim 1;
    ``even`` has as many elements as ``odd`` or one more."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return pairs if even.shape[1] == n else torch.cat([pairs, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``_combine`` over dim 1 of (a, b), with
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    scan the halved sequence (the odd positions), combine it with the
    even elements from 2 on, put element 0 first, interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    reduced = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    odd_a, odd_b = associative_scan(*reduced)
    if n % 2 == 0:
        even = _combine((odd_a[:, :-1], odd_b[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even[0]], dim=1)
    even_b = torch.cat([b[:, :1], even[1]], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_block(p: Params, cfg: RGLRUConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence path (training / prefill). x: (B, S, d_model)."""
    cd = cfg.compute_dtype
    inner = linear(p["w_in"], x, compute_dtype=cd)
    # jax.nn.gelu defaults to the tanh approximation
    gate = F.gelu(linear(p["w_gate"], x, compute_dtype=cd), approximate="tanh")
    conv = _causal_conv(p, cfg, inner).to(torch.float32)
    a, gated = _lru_gates(p, conv)
    _, h = associative_scan(a, gated)  # h_t = a_t h_{t-1} + b_t
    out = h.to(cd) * gate
    return linear(p["w_out"], out, compute_dtype=cd)


def init_rglru_state(cfg: RGLRUConfig, batch: int, *, device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=torch.float32,
                            device=device),
    }


def rglru_decode_step(
    p: Params, cfg: RGLRUConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token path. x: (B, 1, d_model).  Returns (out, state), the
    state updated in place (JAX returns a new one)."""
    cd = cfg.compute_dtype
    inner = linear(p["w_in"], x, compute_dtype=cd)  # (B, 1, dr)
    gate = F.gelu(linear(p["w_gate"], x, compute_dtype=cd), approximate="tanh")
    w = p["conv"].to(torch.float32)
    hist = torch.cat([state["conv"], inner[:, 0:1].to(torch.float32)], dim=1)  # (B, W, dr)
    conv = torch.einsum("bwd,wd->bd", hist, w)
    a, gated = _lru_gates(p, conv)
    h = a * state["h"] + gated
    out = h[:, None].to(cd) * gate
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return linear(p["w_out"], out, compute_dtype=cd), state
