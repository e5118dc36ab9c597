"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of the JAX package's ``models/xlstm.py``, function for function.

mLSTM, the parallelizable variant, runs in *chunked* form: within a chunk
the quadratic gate-matrix formulation (a few batched products); across
chunks a Python loop (JAX's ``lax.scan``) carries the (d_k x d_v) matrix
state, its normalizer and its stabilizer in float32.  That is O(S·chunk),
not O(S²).

sLSTM keeps exponential-gate scalar memories with a per-step recurrence,
a Python loop over time (JAX's ``lax.scan``).  The input's gate
projection ``x @ wx`` does not depend on the state, so
:func:`slstm_block` computes it for every step in one product before the
loop; only the recurrent ``h @ wr`` stays inside it.  Each gate value is
the same product of the same rounded operands as the JAX cell's; only the
order of each float32 dot-product sum can differ.  Decode for both blocks
is one O(1) state update, in place.

Precision, as the JAX code has it: the projections run in the compute
dtype; the chunk scan, the gates and the state updates in float32 (on the
card those are float32 products: PyTorch's default keeps TF32 off for
them, and ``chip_smoke.py`` sets it off explicitly).  ``log_i`` is the raw
projection; only ``log_f`` goes through ``log_sigmoid``.  The GELU of the
sLSTM's up-projection is the tanh approximation (``jax.nn.gelu``'s
default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (
    Params,
    device_of,
    init_linear,
    init_rmsnorm,
    linear,
    rmsnorm,
)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int
    proj_factor_m: float = 2.0
    proj_factor_s: float = 4.0 / 3.0
    chunk: int = 64
    compute_dtype: Any = torch.bfloat16

    @property
    def d_inner_m(self) -> int:
        return int(self.d_model * self.proj_factor_m)

    @property
    def d_head_m(self) -> int:
        return self.d_inner_m // self.n_heads


# ===================================================================== mLSTM
def init_mlstm(generator, cfg: XLSTMConfig, *, dtype=torch.float32) -> Params:
    """The JAX ``init_mlstm``'s shapes and scales, drawn in its key order
    (meta tensors when ``generator`` is None)."""
    d, di = cfg.d_model, cfg.d_inner_m
    return {
        "up": init_linear(generator, d, 2 * di, dtype=dtype),  # x and gate halves
        "wq": init_linear(generator, di, di, dtype=dtype),
        "wk": init_linear(generator, di, di, dtype=dtype),
        "wv": init_linear(generator, di, di, dtype=dtype),
        "wi": init_linear(generator, di, cfg.n_heads, dtype=dtype),
        "wf": init_linear(generator, di, cfg.n_heads, dtype=dtype),
        "down": init_linear(generator, di, d, dtype=dtype, scale=di**-0.5),
        "norm": init_rmsnorm(di, dtype=dtype, device=device_of(generator)),
    }


def _mlstm_chunk_scan(q, k, v, log_f, log_i):
    """Chunked linear attention with gates.

    q, k, v: (B, H, S, D) float32; log_f, log_i: (B, H, S).  Returns
    (B, H, S, D).  Stabilized with a per-chunk running max (the xLSTM
    paper's m_t).  The chunk is min(64, S) and S must be a multiple of it
    (an ``AssertionError`` otherwise, as in the JAX code)."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    c = min(64, s)
    assert s % c == 0, (s, c)
    nc = s // c
    qc = q.reshape(b, h, nc, c, dk)
    kc = k.reshape(b, h, nc, c, dk)
    vc = v.reshape(b, h, nc, c, dv)
    fc = log_f.reshape(b, h, nc, c)
    ic = log_i.reshape(b, h, nc, c)

    # cumulative forget within a chunk: L[t] = sum_{u<=t} log_f[u]
    csum_f = torch.cumsum(fc, dim=-1)  # (B,H,nc,c)
    total_f = csum_f[..., -1]  # (B,H,nc)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    scale = dk**-0.5

    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
    norm = torch.zeros((b, h, dk), dtype=torch.float32, device=q.device)
    m_prev = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    outs = []
    for j in range(nc):
        qb, kb, vb = qc[:, :, j], kc[:, :, j], vc[:, :, j]
        cfb, cib, tfb = csum_f[:, :, j], ic[:, :, j], total_f[:, :, j]
        # log weight of in-chunk key u carried to the chunk's end
        key_decay = tfb[..., None] - cfb + cib  # (B,H,c)
        # in-chunk pairs: log D[t,u] = csum_f[t] - csum_f[u] + log_i[u], u <= t
        pair = cfb[..., :, None] - cfb[..., None, :] + cib[..., None, :]
        pair = torch.where(tri, pair, float("-inf"))
        # the previous state's decay to row t
        q_decay = cfb + m_prev[..., None]  # (B,H,c)
        m_new = torch.maximum(pair.amax(dim=-1), q_decay)  # a stabilizer a row
        intra_w = torch.exp(pair - m_new[..., None])  # (B,H,c,c)
        inter_w = torch.exp(q_decay - m_new)  # (B,H,c)

        scores = torch.einsum("bhtd,bhud->bhtu", qb, kb) * scale
        weighted = scores * intra_w
        intra = torch.einsum("bhtu,bhud->bhtd", weighted, vb)
        inter = torch.einsum("bhtd,bhdv->bhtv", qb, state) * inter_w[..., None] * scale
        # the normalizer (denominator): max(|n·q|, exp(-m))
        norm_intra = weighted.sum(dim=-1)
        norm_inter = torch.einsum("bhtd,bhd->bht", qb, norm) * inter_w * scale
        denom = torch.maximum(torch.abs(norm_intra + norm_inter), torch.exp(-m_new))
        outs.append((intra + inter) / denom[..., None])

        # carry to the next chunk: the new stabilizer is the max of the
        # decayed previous one and the keys' decays to the chunk's end
        m_chunk = m_prev + tfb
        m_carry = torch.maximum(m_chunk, key_decay.amax(dim=-1))
        k_w = torch.exp(key_decay - m_carry[..., None])  # (B,H,c)
        carry = torch.exp(m_chunk - m_carry)
        state = state * carry[..., None, None] + torch.einsum(
            "bhud,bhuv->bhdv", kb * k_w[..., None], vb)
        norm = norm * carry[..., None] + torch.einsum("bhud,bhu->bhd", kb, k_w)
        m_prev = m_carry
    return torch.stack(outs, dim=2).reshape(b, h, s, dv)


def _mlstm_in(p: Params, cfg: XLSTMConfig, x: torch.Tensor):
    """The block's projections: (inner, gate) halves of ``up`` and the
    per-head q, k, v (B, S, H, dh), ``log_i`` and ``log_f`` (B, S, H),
    the gates in float32."""
    b, s, _ = x.shape
    cd = cfg.compute_dtype
    h, dh = cfg.n_heads, cfg.d_head_m
    up = linear(p["up"], x, compute_dtype=cd)
    inner, gate = torch.chunk(up, 2, dim=-1)  # (B,S,di) each
    q = linear(p["wq"], inner, compute_dtype=cd).reshape(b, s, h, dh)
    k = linear(p["wk"], inner, compute_dtype=cd).reshape(b, s, h, dh)
    v = linear(p["wv"], inner, compute_dtype=cd).reshape(b, s, h, dh)
    log_i = linear(p["wi"], inner, compute_dtype=cd).to(torch.float32)
    log_f = F.logsigmoid(linear(p["wf"], inner, compute_dtype=cd).to(torch.float32))
    return gate, q, k, v, log_i, log_f


def _mlstm_out(p: Params, cfg: XLSTMConfig, merged: torch.Tensor, gate: torch.Tensor):
    cd = cfg.compute_dtype
    merged = rmsnorm(p["norm"], merged.to(cd)) * F.silu(gate)
    return linear(p["down"], merged, compute_dtype=cd)


def mlstm_block(p: Params, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d_model) -> (B, S, d_model), the full sequence."""
    b, s, _ = x.shape
    gate, q, k, v, log_i, log_f = _mlstm_in(p, cfg, x)
    f32 = torch.float32
    out = _mlstm_chunk_scan(
        q.transpose(1, 2).to(f32), k.transpose(1, 2).to(f32), v.transpose(1, 2).to(f32),
        log_f.transpose(1, 2), log_i.transpose(1, 2),
    )  # (B,H,S,dh)
    merged = out.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head_m)
    return _mlstm_out(p, cfg, merged, gate)


def init_mlstm_state(cfg: XLSTMConfig, batch: int, *, device=None) -> Dict[str, torch.Tensor]:
    h, dh = cfg.n_heads, cfg.d_head_m
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.zeros((batch, h), dtype=torch.float32, device=device),
    }


def mlstm_decode_step(
    p: Params, cfg: XLSTMConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) one token; an O(1) recurrent update.  Returns (out,
    state), the state updated in place (JAX returns a new one)."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.d_head_m
    gate, q, k, v, log_i, log_f = _mlstm_in(p, cfg, x)
    f32 = torch.float32
    q, k, v = (t.reshape(b, h, dh).to(f32) for t in (q, k, v))
    log_i, log_f = log_i.reshape(b, h), log_f.reshape(b, h)
    m_prev = state["m"]
    m_new = torch.maximum(m_prev + log_f, log_i)
    f_w = torch.exp(m_prev + log_f - m_new)
    i_w = torch.exp(log_i - m_new)
    C = state["C"] * f_w[..., None, None] + torch.einsum(
        "bhd,bhv->bhdv", k * i_w[..., None], v)
    nvec = state["n"] * f_w[..., None] + k * i_w[..., None]
    num = torch.einsum("bhd,bhdv->bhv", q, C) * (dh**-0.5)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, nvec)) * (dh**-0.5),
                        torch.exp(-m_new))
    out = (num / den[..., None]).reshape(b, 1, h * dh)
    state["C"].copy_(C)
    state["n"].copy_(nvec)
    state["m"].copy_(m_new)
    return _mlstm_out(p, cfg, out, gate), state


# ===================================================================== sLSTM
def init_slstm(generator, cfg: XLSTMConfig, *, dtype=torch.float32) -> Params:
    """The JAX ``init_slstm``'s shapes and scales, drawn in its key order:
    the i, f, z, o gates from the input (``wx``) and from the state
    (``wr``, per-head recurrence simplified to dense), then a 4/3 GLU."""
    d = cfg.d_model
    dg = int(d * cfg.proj_factor_s)
    wx = init_linear(generator, d, 4 * d, dtype=dtype)
    wr = init_linear(generator, d, 4 * d, dtype=dtype, scale=d**-0.5)
    norm = init_rmsnorm(d, dtype=dtype, device=device_of(generator))
    return {
        "wx": wx,
        "wr": wr,
        "norm": norm,
        "up_gate": init_linear(generator, d, dg, dtype=dtype),
        "up": init_linear(generator, d, dg, dtype=dtype),
        "down": init_linear(generator, dg, d, dtype=dtype, scale=dg**-0.5),
    }


def init_slstm_state(cfg: XLSTMConfig, batch: int, *, device=None) -> Dict[str, torch.Tensor]:
    return {name: torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}


def _slstm_gates(p: Params, cfg: XLSTMConfig, xt: torch.Tensor) -> torch.Tensor:
    """The input's share of the four gates, float32: xt (..., d) is
    rounded to the compute dtype first, as the JAX cell rounds it."""
    cd = cfg.compute_dtype
    return linear(p["wx"], xt.to(cd), compute_dtype=cd).to(torch.float32)


def _slstm_cell(p, cfg, state, xt, gates_x=None):
    """One sLSTM step. xt: (B, d) float32, or ``gates_x`` (B, 4d), its
    :func:`_slstm_gates` computed already.  Returns the new state (new
    tensors; the caller decides where they go)."""
    cd = cfg.compute_dtype
    if gates_x is None:
        gates_x = _slstm_gates(p, cfg, xt)
    gates_r = linear(p["wr"], state["h"].to(cd), compute_dtype=cd).to(torch.float32)
    gi, gf, gz, go = torch.chunk(gates_x + gates_r, 4, dim=-1)
    log_i = gi  # the exponential input gate, in log space
    log_f = F.logsigmoid(gf)
    m_new = torch.maximum(state["m"] + log_f, log_i)
    i_w = torch.exp(log_i - m_new)
    f_w = torch.exp(state["m"] + log_f - m_new)
    z = torch.tanh(gz)
    o = torch.sigmoid(go)
    c = f_w * state["c"] + i_w * z
    n = f_w * state["n"] + i_w
    h = o * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p: Params, cfg: XLSTMConfig, h: torch.Tensor) -> torch.Tensor:
    """The GLU after the mixing: h (..., d) in the compute dtype."""
    cd = cfg.compute_dtype
    h = rmsnorm(p["norm"], h)
    u = linear(p["up"], h, compute_dtype=cd)
    g = linear(p["up_gate"], h, compute_dtype=cd)
    # jax.nn.gelu defaults to the tanh approximation
    return linear(p["down"], u * F.gelu(g, approximate="tanh"), compute_dtype=cd)


def slstm_block(p: Params, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    """The sequential recurrence over time: (B, S, d) -> (B, S, d).  The
    input's gates for all S steps come from one product before the loop."""
    b, s, _ = x.shape
    gates_x = _slstm_gates(p, cfg, x.to(torch.float32))  # (B, S, 4d)
    state = init_slstm_state(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, state, None, gates_x[:, t])
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).to(cfg.compute_dtype)  # (B,S,d)
    return _slstm_out(p, cfg, h)


def slstm_decode_step(
    p: Params, cfg: XLSTMConfig, x: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) one token.  Returns (out, state), the state updated in
    place."""
    new = _slstm_cell(p, cfg, state, x[:, 0].to(torch.float32))
    for name, value in new.items():
        state[name].copy_(value)
    return _slstm_out(p, cfg, new["h"][:, None].to(cfg.compute_dtype)), state
