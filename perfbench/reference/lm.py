"""A plain decoder of the Llama kind, in float32, to judge the port by.

Written from the published description of Yi-6B and H2O-Danube3 (both
``LlamaForCausalLM``): token embedding; per layer a pre-norm (RMSNorm with
a learned scale), q, k and v projections, rotary position embedding
(rotate-half form: a head's first half turns against its second, with
frequencies ``rope_theta ** (-2i / d_head)``), causal grouped-query
attention (each key head serves ``n_heads / n_kv_heads`` query heads; with
a sliding window, query i sees keys i - window + 1 .. i), an output
projection and a residual add; a second pre-norm, a SwiGLU MLP (``silu(x
W_gate) * (x W_up)``, then ``W_down``) and a residual add; a final norm and
an untied head.  A score is the log-probability of the next token, from a
float32 log-softmax over the vocabulary.

Everything is computed in float32 with TF32 off, from the weights and
tokens the benchmark made: nothing here reads the program, and nothing of
the program is imported.  Products take ``x @ W`` with W stored (d_in,
d_out), as the weights are made.  The work goes layer by layer over the
rows it is given, and attention a key head at a time, so that a check at
the timed sizes fits beside nothing else on the card.

``rounding`` puts a lower precision under every product (both operands)
and nothing else: the control that a sound check has to refuse.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

Weights = Dict[str, object]


@dataclass(frozen=True)
class RefShape:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float
    window: Optional[int] = None


class Exact:
    """float32 operands, as they are."""

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w.float()

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Float8:
    """Operands rounded to float8 e4m3 the way an fp8 GEMM takes them: a
    weight (or v) with one scale for the tensor, an activation (or a row of
    probabilities) with one scale a row, each scale putting the largest
    magnitude at e4m3's largest, 448."""

    LARGEST = 448.0

    @staticmethod
    def _round(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        scale = amax.clamp_min(1e-30) / Float8.LARGEST
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return self._round(w, w.abs().amax())

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        return self._round(x, x.abs().amax(dim=-1, keepdim=True))


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale.float()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_tables(seq_len: int, d_head: int, theta: float, device) -> tuple:
    inv_freq = 1.0 / theta ** (torch.arange(0, d_head, 2, device=device,
                                            dtype=torch.float32) / d_head)
    angles = torch.arange(seq_len, device=device, dtype=torch.float32)[:, None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)  # (S, D)
    return angles.cos(), angles.sin()


def attention(q, k, v, shape: RefShape, rnd) -> torch.Tensor:
    """One row: q (H, S, D), k and v (Hkv, S, D) -> (S, H * D)."""
    n_q, s, d = q.shape
    group = n_q // k.shape[0]
    pos = torch.arange(s, device=q.device)
    visible = pos[None, :] <= pos[:, None]
    if shape.window is not None:
        visible &= pos[None, :] > pos[:, None] - shape.window
    out = torch.empty((s, n_q, d), dtype=torch.float32, device=q.device)
    for j in range(k.shape[0]):
        qj = rnd.rows(q[j * group:(j + 1) * group])
        scores = qj @ rnd.rows(k[j]).transpose(0, 1) / d ** 0.5  # (G, S, S)
        probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
        del scores
        out[:, j * group:(j + 1) * group] = (rnd.rows(probs) @ rnd.weight(v[j])).transpose(0, 1)
        del probs
    return out.reshape(s, n_q * d)


def layer(h: torch.Tensor, w: Dict[str, torch.Tensor], shape: RefShape, rope, rnd
          ) -> torch.Tensor:
    """One decoder layer over h (R, S, d), in place of h."""
    cos, sin = rope
    x = rnd.rows(rms_norm(h, w["norm1"], shape.norm_eps))
    r, s, _ = h.shape
    q = (x @ rnd.weight(w["wq"])).reshape(r, s, shape.n_heads, shape.d_head).transpose(1, 2)
    k = (x @ rnd.weight(w["wk"])).reshape(r, s, shape.n_kv_heads, shape.d_head).transpose(1, 2)
    v = (x @ rnd.weight(w["wv"])).reshape(r, s, shape.n_kv_heads, shape.d_head).transpose(1, 2)
    q = q * cos + rotate_half(q) * sin
    k = k * cos + rotate_half(k) * sin
    wo = rnd.weight(w["wo"])
    for i in range(r):
        h[i] += rnd.rows(attention(q[i], k[i], v[i], shape, rnd)) @ wo
    del q, k, v, wo
    x = rnd.rows(rms_norm(h, w["norm2"], shape.norm_eps))
    gate = x @ rnd.weight(w["gate"])
    up = x @ rnd.weight(w["up"])
    h += rnd.rows(torch.nn.functional.silu(gate) * up) @ rnd.weight(w["down"])
    return h


def final_hidden(weights: Weights, tokens: torch.Tensor, shape: RefShape, rnd) -> torch.Tensor:
    """The final norm's input (R, S, d) for rows ``tokens`` (R, S)."""
    h = weights["embed"][tokens].float()
    rope = rope_tables(tokens.shape[1], shape.d_head, shape.rope_theta, h.device)
    layers: List[Dict[str, torch.Tensor]] = weights["layers"]
    for w in layers:
        h = layer(h, w, shape, rope, rnd)
    return h


def head_logits(weights: Weights, h: torch.Tensor, shape: RefShape, rnd, head=None
                ) -> torch.Tensor:
    head = rnd.weight(weights["head"]) if head is None else head
    return rnd.rows(rms_norm(h, weights["final_norm"], shape.norm_eps)) @ head


def logits_rows(weights: Weights, tokens: torch.Tensor, shape: RefShape,
                rounding=None) -> torch.Tensor:
    """Logits (R, S, V) for rows ``tokens`` (R, S): small sizes only."""
    rnd = rounding or Exact()
    with torch.no_grad(), no_tf32():
        return head_logits(weights, final_hidden(weights, tokens, shape, rnd), shape, rnd)


def score_rows(weights: Weights, tokens: torch.Tensor, shape: RefShape,
               rounding=None) -> torch.Tensor:
    """Log-probabilities (R, S - 1) of tokens[:, 1:] given what precedes
    them, for rows ``tokens`` (R, S) on the weights' device; the logits a
    row at a time."""
    rnd = rounding or Exact()
    with torch.no_grad(), no_tf32():
        h = final_hidden(weights, tokens, shape, rnd)
        head = rnd.weight(weights["head"])
        out = []
        for i in range(tokens.shape[0]):
            logp = torch.log_softmax(head_logits(weights, h[i, :-1], shape, rnd, head), dim=-1)
            out.append(logp.gather(-1, tokens[i, 1:, None])[:, 0])
            del logp
        return torch.stack(out)
