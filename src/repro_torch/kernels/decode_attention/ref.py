"""Plain PyTorch version of decode attention, with the kernel's semantics.

Same function as the CUDA kernel and the JAX package's Pallas kernel:
scores in float32 from ``q * scale`` (q cast to float32 first), cache rows
at or past ``lengths[b]`` set to -1e30 (not -inf), a float32 softmax with
the denominator clamped at 1e-30, and the output cast to q's dtype.  The
-1e30 mask matters at length 0: every score is then -1e30, every weight
exp(0) = 1, and the result is the mean of all S cache rows, as the Pallas
kernel returns (its jnp oracle, masking with -inf, returns NaN there).
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,        # (B, H, D) — the single new token's queries
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) int — valid cache entries per sequence
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, group, d).to(torch.float32) * scale
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k_cache.to(torch.float32))
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", p, v_cache.to(torch.float32))
    out = out / l.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)
