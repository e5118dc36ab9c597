"""Multi-head Latent Attention (DeepSeek-V2/V3).

The port of the JAX package's ``models/mla.py``, function for function.
Queries and KV are low-rank-compressed; only the compressed latent
``c_kv`` (rank 512) and the small decoupled-RoPE key ``k_rope`` (64) are
cached for decode: (512 + 64) values a token and layer instead of
2 x 128 heads x (128 + 64).

Shapes follow the V3 paper: d_model 7168, q rank 1536, kv rank 512,
per-head nope 128 + rope 64 query/key dims, v head 128.

Two forward branches, as the reference has them (:func:`mla_train`): the
dense :func:`_attend` in float32 with ``-inf`` masks, and, when ``chunk``
is set and S exceeds it, :func:`_attend_chunked`, an online softmax over
key chunks whose products take compute-dtype operands with float32 sums
(the operands widened to float32 first, which is exact for bf16
products), ``q·scale`` rounded to the compute dtype, ``-1e30`` masks and
keys padded to a multiple of the chunk.  That branch pins heads to the
tensor-parallel mesh axis (``constrain_heads``, at the JAX call site),
which does nothing until a mesh is registered
(``distribution.sharding``).

Decode is the weight-absorbed step (:func:`mla_decode_step`); the cache is
updated in place (JAX returns a new one), with the same REPLACE semantics
as ``attention.decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distribution.sharding import constrain_heads
from repro_torch.models.attention import _write_at
from repro_torch.models.common import (
    Params,
    apply_rope,
    device_of,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
)

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    #: kv-chunked online softmax for the train path (see attention.py)
    chunk: Optional[int] = 1024
    compute_dtype: Any = torch.bfloat16

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def init_mla(generator, cfg: MLAConfig, *, dtype=torch.float32) -> Params:
    """The JAX ``init_mla``'s shapes and scales, drawn in its key order
    (meta tensors when ``generator`` is None)."""
    h, dq, dkv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dev = device_of(generator)
    wq_a = init_linear(generator, cfg.d_model, dq, dtype=dtype)
    wq_b = init_linear(generator, dq, h * cfg.qk_dim, dtype=dtype)
    wkv_a = init_linear(generator, cfg.d_model, dkv + cfg.qk_rope_dim, dtype=dtype)
    wkv_b = init_linear(generator, dkv, h * (cfg.qk_nope_dim + cfg.v_head_dim), dtype=dtype)
    wo = init_linear(generator, h * cfg.v_head_dim, cfg.d_model, dtype=dtype,
                     scale=(h * cfg.v_head_dim) ** -0.5)
    return {
        "wq_a": wq_a,
        "q_norm": init_rmsnorm(dq, dtype=dtype, device=dev),
        "wq_b": wq_b,
        "wkv_a": wkv_a,
        "kv_norm": init_rmsnorm(dkv, dtype=dtype, device=dev),
        "wkv_b": wkv_b,
        "wo": wo,
    }


def _compress(p: Params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor):
    """The Q/KV compression both paths share: (q_nope (B,H,S,nope), q_rope
    (B,H,S,rope), c_kv (B,S,dkv), k_rope (B,1,S,rope), one key head
    shared by every query head)."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    h = cfg.n_heads
    # queries: down, norm, up, split nope / rope
    cq = rmsnorm(p["q_norm"], linear(p["wq_a"], x, compute_dtype=cd))
    q = linear(p["wq_b"], cq, compute_dtype=cd).reshape(b, s, h, cfg.qk_dim)
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:].transpose(1, 2), positions,
                        theta=cfg.rope_theta)
    # the kv latent and the decoupled rope key
    kv_a = linear(p["wkv_a"], x, compute_dtype=cd)
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:][:, None], positions,
                        theta=cfg.rope_theta)
    return q_nope.transpose(1, 2), q_rope, c_kv, k_rope


def _expand_kv(p: Params, cfg: MLAConfig, c_kv: torch.Tensor):
    """The latent up-projected to per-head (k_nope (B,H,T,nope), v
    (B,H,T,v))."""
    b, t, _ = c_kv.shape
    kv = linear(p["wkv_b"], c_kv, compute_dtype=cfg.compute_dtype)
    kv = kv.reshape(b, t, cfg.n_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return kv[..., :cfg.qk_nope_dim].transpose(1, 2), kv[..., cfg.qk_nope_dim:].transpose(1, 2)


def _attend(cfg, q_nope, q_rope, k_nope, k_rope, v, *, causal_rows, visible_cols):
    """Dense attention in float32: (B,H,S,v)."""
    f32 = torch.float32
    scale = cfg.qk_dim**-0.5
    scores = (q_nope.to(f32) @ k_nope.to(f32).transpose(-1, -2)
              + q_rope.to(f32) @ k_rope.to(f32).transpose(-1, -2)) * scale
    mask = visible_cols[None, :] <= causal_rows[:, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return w @ v.to(f32)


def _attend_chunked(cfg, q_nope, q_rope, k_nope, k_rope, v, *, chunk):
    """Online softmax over kv chunks (working set S x chunk, not S x S):
    (B,H,S,v) float32."""
    cd, f32 = cfg.compute_dtype, torch.float32
    q_nope = constrain_heads(q_nope)
    q_rope = constrain_heads(q_rope)
    k_nope = constrain_heads(k_nope)
    v = constrain_heads(v)
    b, h, s, _ = q_nope.shape
    t = k_nope.shape[2]
    pad = -t % chunk
    if pad:  # padded keys sit past every causal row: masked for free
        k_nope = torch.nn.functional.pad(k_nope, (0, 0, 0, pad))
        k_rope = torch.nn.functional.pad(k_rope, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        t += pad
    scale = cfg.qk_dim**-0.5
    # q·scale rounded to the compute dtype, then widened for exact products
    qn = (q_nope.to(f32) * scale).to(cd).to(f32)
    qr = (q_rope.to(f32) * scale).to(cd).to(f32)
    rows = torch.arange(s, device=q_nope.device)
    acc = torch.zeros((b, h, s, cfg.v_head_dim), dtype=f32, device=q_nope.device)
    m = torch.full((b, h, s), _NEG, dtype=f32, device=q_nope.device)
    l = torch.zeros((b, h, s), dtype=f32, device=q_nope.device)
    for c0 in range(0, t, chunk):
        kn = k_nope[:, :, c0:c0 + chunk].to(cd).to(f32)
        kr = k_rope[:, :, c0:c0 + chunk].to(cd).to(f32)
        vs = v[:, :, c0:c0 + chunk].to(cd).to(f32)
        scores = qn @ kn.transpose(-1, -2) + qr @ kr.transpose(-1, -2)  # (B,H,S,c)
        cols = c0 + torch.arange(chunk, device=q_nope.device)
        mask = cols[None, :] <= rows[:, None]
        scores = scores.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        pw = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pw.sum(dim=-1)
        acc = acc * corr[..., None] + pw.to(cd).to(f32) @ vs
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def mla_train(p: Params, cfg: MLAConfig, x: torch.Tensor, positions: torch.Tensor
              ) -> torch.Tensor:
    """Causal MLA over the full sequence: x (B, S, d_model) -> (B, S,
    d_model).  The chunked branch when ``chunk`` is set and S > chunk."""
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _compress(p, cfg, x, positions)
    k_nope, v = _expand_kv(p, cfg, c_kv)
    if cfg.chunk is not None and s > cfg.chunk:
        out = _attend_chunked(cfg, q_nope, q_rope, k_nope, k_rope, v, chunk=cfg.chunk)
    else:
        ar = torch.arange(s, device=x.device)
        out = _attend(cfg, q_nope, q_rope, k_nope, k_rope, v, causal_rows=ar, visible_cols=ar)
    merged = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.v_head_dim)
    return linear(p["wo"], merged.to(cfg.compute_dtype), compute_dtype=cfg.compute_dtype)


# ------------------------------------------------------------------ serving
def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, *, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    """The MLA cache: only (c_kv, k_rope), rank 512 + 64 a token, instead
    of every head's keys and values."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, 1, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def mla_decode_step(
    p: Params,
    cfg: MLAConfig,
    x: torch.Tensor,        # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weight-absorbed decode (the MLA inference trick).

    Instead of expanding the compressed cache into per-head K/V (a
    (B, H, T, d) tensor), the up-projections are absorbed into the
    attention math:

      scores_nope = (q_nope · W_uk) @ c_kv^T      (q in latent space)
      out         = (softmax @ c_kv) · W_uv       (context in latent space)

    so the only T-sized tensors are the latent cache and the (B, H, T)
    scores.  ``wkv_b`` is viewed as (dkv, H, nope + v), no copy.  Returns
    (out, cache), the cache updated in place."""
    b = x.shape[0]
    cd, f32 = cfg.compute_dtype, torch.float32
    h, dn, dv, dkv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope, c_new, kr_new = _compress(p, cfg, x, lengths[:, None])
    # the rows at ``lengths``, as attention's cache: c_kv viewed as one head
    _write_at(cache["c_kv"][:, None], c_new, lengths)
    _write_at(cache["k_rope"], kr_new[:, :, 0], lengths)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_max = c_kv.shape[1]

    wkv = p["wkv_b"]["w"].to(cd).view(dkv, h, dn + dv)
    w_uk, w_uv = wkv[..., :dn], wkv[..., dn:]
    # q into latent space: (B, H, dkv), in the compute dtype
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, :, 0].to(cd), w_uk)
    scale = cfg.qk_dim**-0.5
    scores = (q_eff.to(f32) @ c_kv.to(f32).transpose(1, 2)
              + q_rope[:, :, 0].to(cd).to(f32) @ k_rope[:, 0].to(f32).transpose(1, 2)
              ) * scale  # (B, H, T)
    visible = torch.arange(s_max, device=x.device)[None, :] < (lengths + 1)[:, None]
    scores = scores.masked_fill(~visible[:, None], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    ctx = w.to(cd).to(f32) @ c_kv.to(f32)  # (B, H, dkv): the context in latent space
    out = torch.einsum("bhk,khd->bhd", ctx.to(cd), w_uv)
    merged = out.reshape(b, 1, h * dv)
    return linear(p["wo"], merged.to(cd), compute_dtype=cd), cache
