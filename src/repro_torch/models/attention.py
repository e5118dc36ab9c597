"""GQA/MQA/MHA attention with RoPE, optional qk-norm and sliding window.

Three entry points matching the three workload shapes, as in the JAX
package's ``models/attention.py``:

* ``attend_train`` — full-sequence causal attention (training / prefill):
  the torch translation of the reference math by default, the flash
  kernel (``kernels/flash_attention``) when ``use_flash_kernel`` is set;
* ``prefill``      — causal pass that also writes the KV cache;
* ``decode_step``  — one token against a KV cache (serving): the
  reference masked softmax by default, the decode kernel
  (``kernels/decode_attention``) when ``use_flash_kernel`` is set.

``use_flash_kernel=False`` is the reference route, the counterpart of
the jnp code; it is not the kernels' plain versions (those live beside
the kernels).  On CPU tensors the kernel route takes the kernels' plain
versions.  The chunked forward pins heads to the tensor-parallel mesh
axis (``constrain_heads``, at the JAX call site), which does nothing
until a mesh is registered (``distribution.sharding``).  The KV cache
is updated in place (JAX returns a new array); the returned cache is
the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distribution.sharding import constrain_heads
from repro_torch.models.common import (
    Params,
    device_of,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
    rope_mix_table,
    rope_rotate,
    rope_rotate_out,
    rope_tables,
)
from repro_torch.telemetry.spans import span


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window size (SWA archs)
    use_flash_kernel: bool = False  # the hand-written CUDA kernels
    #: kv-chunked online-softmax: bounds the scores working set to
    #: S×chunk instead of S×S. None = dense S×S scores.
    chunk: Optional[int] = 1024
    compute_dtype: Any = torch.bfloat16


def init_attention(generator, cfg: AttentionConfig, *, dtype=torch.float32) -> Params:
    p: Params = {
        "wq": init_linear(generator, cfg.d_model, cfg.n_heads * cfg.d_head, dtype=dtype),
        "wk": init_linear(generator, cfg.d_model, cfg.n_kv_heads * cfg.d_head, dtype=dtype),
        "wv": init_linear(generator, cfg.d_model, cfg.n_kv_heads * cfg.d_head, dtype=dtype),
        "wo": init_linear(
            generator, cfg.n_heads * cfg.d_head, cfg.d_model, dtype=dtype,
            scale=(cfg.n_heads * cfg.d_head) ** -0.5,
        ),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(cfg.d_head, dtype=dtype, device=device_of(generator))
        p["k_norm"] = init_rmsnorm(cfg.d_head, dtype=dtype, device=device_of(generator))
    return p


def _project(
    p: Params, cfg: AttentionConfig, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q, k and v projections (B, S, H, D), q and k normed with qk_norm."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    q = linear(p["wq"], x, compute_dtype=cd).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = linear(p["wk"], x, compute_dtype=cd).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = linear(p["wv"], x, compute_dtype=cd).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    return q, k, v


#: ``_rope``'s calls by path since import (read by tests and chip_smoke.py)
ROPE_CALLS = {"three_pass": 0, "autograd": 0}


def _rope(cfg: AttentionConfig, q, k, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on q and k (B, S, H, D), each to a contiguous (B, H, S, D),
    from one set of tables.  Where autograd records q or k, the rotation
    it differentiates (``rope_rotate``); elsewhere the same numbers in three
    float32 passes (``rope_rotate_out``, whose ``out=`` writes autograd
    cannot record)."""
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    cos, sin = rope_tables(positions, q.shape[-1], theta=cfg.rope_theta, device=q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        ROPE_CALLS["autograd"] += 1
        return rope_rotate(q, cos, sin), rope_rotate(k, cos, sin)
    ROPE_CALLS["three_pass"] += 1
    mix = rope_mix_table(cos, sin)
    return rope_rotate_out(q, mix), rope_rotate_out(k, mix)


def _project_qkv(
    p: Params, cfg: AttentionConfig, x: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project(p, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    return q, k, v.transpose(1, 2)  # (B,H,S,D)


def _mask(s: int, t: int, *, causal: bool, window: Optional[int], q_offset, device):
    rows = q_offset + torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def _sdpa(
    q: torch.Tensor,  # (B,H,S,D)
    k: torch.Tensor,  # (B,Hkv,T,D)
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    q_offset: int = 0,
) -> torch.Tensor:
    """Reference scaled-dot-product attention with GQA head grouping."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, hkv, group, s, d).to(torch.float32)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.to(torch.float32))
    scores = scores * (d**-0.5)
    mask = _mask(s, t, causal=causal, window=window, q_offset=q_offset, device=q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", w, v.to(torch.float32))
    return out.reshape(b, h, s, d)


_NEG = -1e30


def _sdpa_chunked(
    q: torch.Tensor,  # (B,H,S,D)
    k: torch.Tensor,  # (B,Hkv,T,D)
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    chunk: int,
    q_offset: int = 0,
) -> torch.Tensor:
    """kv-chunked online-softmax attention, a loop over key/value chunks
    with running (max, denominator, accumulator): the scores working set
    is S×chunk.  Rounding as the JAX code: q·scale is cast back to the
    compute dtype, and each chunk's products take compute-dtype operands
    with float32 sums (operands widened to float32 first, which is exact
    for bf16 products)."""
    q = constrain_heads(q)  # heads over TP (q heads always divide)
    k = constrain_heads(k)  # kv heads shard only when they divide TP
    v = constrain_heads(v)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = h // hkv
    cd = q.dtype
    pad = -t % chunk
    if pad:
        # padded keys sit at positions >= t > any causal row — masked for
        # free by the causal comparison (train paths are always causal)
        if not causal:
            raise AssertionError("chunk padding relies on causal masking")
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        t += pad
    qg = (q.reshape(b, hkv, group, s, d).to(torch.float32) * (d**-0.5)).to(cd)
    qg = qg.to(torch.float32)
    acc = torch.zeros((b, hkv, group, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, group, s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, s), dtype=torch.float32, device=q.device)
    for c0 in range(0, t, chunk):
        ks = k[:, :, c0:c0 + chunk].to(torch.float32)
        vs = v[:, :, c0:c0 + chunk].to(torch.float32)
        scores = torch.einsum("bkgqd,bktd->bkgqt", qg, ks)  # (B,Hkv,G,S,c)
        mask = _mask(s, chunk, causal=causal, window=window,
                     q_offset=q_offset - c0, device=q.device)
        scores = scores.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(cd).to(torch.float32), vs)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, s, d)


def _attend_full(q, k, v, cfg: AttentionConfig):
    """Dispatch dense vs chunked by config and shape."""
    t = k.shape[2]
    if cfg.chunk is not None and t > cfg.chunk:
        return _sdpa_chunked(q, k, v, causal=True, window=cfg.window, chunk=cfg.chunk)
    return _sdpa(q, k, v, causal=True, window=cfg.window)


def _attend(q, k, v, cfg: AttentionConfig):
    if cfg.use_flash_kernel:
        from repro_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, window=cfg.window)
    return _attend_full(q, k, v, cfg)


def _out_proj(p: Params, cfg: AttentionConfig, out: torch.Tensor) -> torch.Tensor:
    b, h, s, d = out.shape
    merged = out.transpose(1, 2).reshape(b, s, h * d).to(cfg.compute_dtype)
    return linear(p["wo"], merged, compute_dtype=cfg.compute_dtype)


def attend_train(
    p: Params, cfg: AttentionConfig, x: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Causal self-attention over the full sequence.  Its pieces are the
    ``lm.attention.*`` spans; ``prefill`` and ``decode_step`` enter none."""
    with span("lm.attention.qkv"):
        q, k, v = _project(p, cfg, x)
    with span("lm.attention.rope"):
        q, k = _rope(cfg, q, k, positions)
    with span("lm.attention.kernel"):
        out = _attend(q, k, v.transpose(1, 2), cfg)
    with span("lm.attention.out"):
        return _out_proj(p, cfg, out)


# ------------------------------------------------------------------ serving
def init_cache(
    cfg: AttentionConfig, batch: int, max_len: int, *, dtype=torch.bfloat16, device=None
) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal pass over the prompt; writes its k/v at positions 0..S-1 of
    the cache (in place)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    s = x.shape[1]
    cache["k"][:, :, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :, :s] = v.to(cache["v"].dtype)
    return _out_proj(p, cfg, _attend(q, k, v, cfg)), cache


def _write_at(cache: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> None:
    """cache[b, :, lengths[b]] = new[b] for every b, in place, with
    REPLACE semantics (re-writing a slot position is idempotent, so
    serving can reuse slots).  A write at ``lengths[b] >= S`` is dropped,
    as the JAX one-hot (all zeros there) drops it; no host sync."""
    s_max = cache.shape[2]
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = lengths.clamp(0, s_max - 1)
    keep = (lengths < s_max)[:, None, None]
    cache[rows, :, pos] = torch.where(keep, new.to(cache.dtype), cache[rows, :, pos])


def decode_step(
    p: Params,
    cfg: AttentionConfig,
    x: torch.Tensor,        # (B, 1, d_model)
    cache: Dict[str, torch.Tensor],
    lengths: torch.Tensor,  # (B,) — tokens already in the cache
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b = x.shape[0]
    cd = cfg.compute_dtype
    positions = lengths[:, None]  # this token's position (B, 1)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    # append the new kv at each sequence's own length (ragged batch)
    _write_at(cache["k"], k_new[:, :, 0], lengths)
    _write_at(cache["v"], v_new[:, :, 0], lengths)
    k_cache, v_cache = cache["k"], cache["v"]
    new_lengths = lengths + 1
    if cfg.use_flash_kernel:
        from repro_torch.kernels.decode_attention import decode_attention

        # the kernel has no window: this branch attends to the whole
        # prefix, as the JAX kernel branch does (attention.py:271-277)
        out = decode_attention(q[:, :, 0], k_cache, v_cache, new_lengths)  # (B, H, D)
        out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    else:
        s_max = k_cache.shape[2]
        t = torch.arange(s_max, device=x.device)[None, :]
        visible = t < new_lengths[:, None]
        if cfg.window is not None:
            visible &= t > (new_lengths[:, None] - 1 - cfg.window)
        scores = torch.einsum(
            "bkgqd,bktd->bkgqt",
            q.reshape(b, cfg.n_kv_heads, -1, 1, cfg.d_head).to(torch.float32),
            k_cache.to(torch.float32),
        ) * (cfg.d_head**-0.5)
        scores = scores.masked_fill(~visible[:, None, None, None], float("-inf"))
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqt,bktd->bkgqd", w, v_cache.to(torch.float32))
        out = out.reshape(b, cfg.n_heads, 1, cfg.d_head).transpose(1, 2)
        out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    attn = linear(p["wo"], out.to(cd), compute_dtype=cd)
    return attn, cache
