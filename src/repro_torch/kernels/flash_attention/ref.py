"""Plain PyTorch version of flash attention, with the kernel's semantics.

Same function as the CUDA kernel and the JAX package's Pallas kernel:
scores in float32 from ``q * scale`` (q cast to float32 first), masked
entries set to -1e30 (not -inf), a float32 softmax with the denominator
clamped at 1e-30, and the output cast to q's dtype.  The -1e30 mask only
differs from -inf for a row that sees no valid key, which causal and
windowed masks never leave.  K/V are never repeated: q heads are grouped
over their kv head.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,  # sliding window size (None = full)
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qg = q.reshape(b, hkv, group, s, d).to(torch.float32) * scale
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32))
    rows = torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    scores = scores.masked_fill(~mask, _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(torch.float32))
    out = out / l.clamp_min(1e-30)
    return out.reshape(b, h, s, d).to(q.dtype)
