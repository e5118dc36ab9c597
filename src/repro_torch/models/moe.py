"""Mixture-of-Experts: shared + routed top-k, capacity-limited dispatch.

The port of the JAX package's ``models/moe.py``, step for step:

1. routing is computed per *group* (= one sequence), with a per-group
   expert capacity ``C = S·k/E·factor`` — GShard-style locality dropping;
2. slot assignment uses a sort-based position-in-expert (no one-hot
   cumsum blowup);
3. the dispatch scatters int32 token indices only into the
   ``(groups, E, C)`` routing table, then gathers the expert inputs in
   one batched gather;
4. the expert FFN is one batched product over (groups, E, C, d) ×
   (E, d, f) (``torch.einsum``, as the JAX package computes it outside
   any Pallas kernel);
5. the combine sums each token's kept contributions, weighted by the
   router probs; dropped assignments contribute zero.

Aux losses: switch-style load balance + router z-loss.

Where the two frameworks could part, the port follows the JAX code's
semantics exactly: the expert sort is stable (``jnp.argsort``), the top-k
puts the lower expert index first on a tie (``lax.top_k``; ``torch.topk``
promises no order), and the combine adds a token's contributions in the
order XLA's CPU scatter-add applies them (expert-major, then slot),
rounding to ``compute_dtype`` after each add, so its bits equal the JAX
package's on the CPU and are the same from run to run on the card (an
atomic ``index_add_`` would sum in another order each run).  The JAX
code pins the buffers to the expert-parallel mesh axis
(``constrain_moe_buffer``, ``constrain_batch``); without a mesh that does
nothing, so on one device the port drops it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import Params, init_linear, init_swiglu, linear, swiglu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden width
    num_experts: int
    top_k: int
    num_shared: int = 0        # shared experts (always-on), same d_ff each
    capacity_factor: float = 1.25
    balance_loss_weight: float = 0.01
    z_loss_weight: float = 1e-3
    #: normalize the top-k router probs to sum to 1 (deepseek/qwen style)
    norm_topk: bool = True
    compute_dtype: Any = torch.bfloat16


def init_moe(generator, cfg: MoEConfig, *, dtype=torch.float32) -> Params:
    """The JAX tree's shapes and scales: ``router/w`` (d, E),
    ``experts/{gate,up}`` (E, d, f), ``experts/down`` (E, f, d), and
    ``shared`` (a SwiGLU of width f · num_shared) when there are shared
    experts; drawn from ``generator`` in that order (meta tensors when it
    is None)."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    scale_in, scale_out = d**-0.5, f**-0.5
    p: Params = {
        "router": init_linear(generator, d, e, dtype=dtype, scale=scale_in),
        "experts": {
            "gate": common._normal(generator, (e, d, f), scale_in, dtype),
            "up": common._normal(generator, (e, d, f), scale_in, dtype),
            "down": common._normal(generator, (e, f, d), scale_out, dtype),
        },
    }
    if cfg.num_shared:
        p["shared"] = init_swiglu(generator, d, f * cfg.num_shared, dtype=dtype)
    return p


def capacity(cfg: MoEConfig, s: int) -> int:
    """Slots per expert in a group of ``s`` tokens."""
    return max(int(s * cfg.top_k / cfg.num_experts * cfg.capacity_factor), 4)


def _positions_in_expert(e_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Slot index of each assignment within its expert, per group:
    ``e_flat`` is (..., N) expert ids, one group a row.

    Sort-based: after a stable sort of the assignments by expert id, an
    assignment's slot is its rank minus its expert segment's first rank,
    so an expert's slots go to its assignments in their order in the row.
    O(N log N), no (N, E) one-hot."""
    n = e_flat.shape[-1]
    order = torch.argsort(e_flat, dim=-1, stable=True)
    sorted_ids = torch.gather(e_flat, -1, order)
    experts = torch.arange(num_experts, dtype=e_flat.dtype, device=e_flat.device)
    seg_start = torch.searchsorted(sorted_ids,
                                   experts.expand(*e_flat.shape[:-1], -1).contiguous())
    ranks = torch.arange(n, device=e_flat.device).expand_as(e_flat)
    pos_sorted = ranks - torch.gather(seg_start, -1, sorted_ids)
    out = torch.empty(e_flat.shape, dtype=torch.int32, device=e_flat.device)
    return out.scatter_(-1, order, pos_sorted.to(torch.int32))


def route(p: Params, cfg: MoEConfig, x: torch.Tensor):
    """The router on x (B, S, d): float32 logits and probs (B, S, E), and
    the top-k probs and expert ids (B, S, k), highest first and the lower
    id first on a tie (``lax.top_k``'s order; a stable descending sort
    gives it), the probs renormalised when ``norm_topk``."""
    logits = linear(p["router"], x, compute_dtype=cfg.compute_dtype).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :cfg.top_k], top_e[..., :cfg.top_k]
    if cfg.norm_topk:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def dispatch_plan(top_e: torch.Tensor, num_experts: int, cap: int):
    """Per group (a row of the batch), whether each assignment fits under
    capacity ``cap`` in its expert, and its row in the group's
    (E · cap + 1)-row buffer (the last row takes every dropped
    assignment).  top_e (B, S, k) → two (B, S·k) tensors."""
    b = top_e.shape[0]
    e_flat = top_e.reshape(b, -1)
    slot = _positions_in_expert(e_flat, num_experts)
    keep = slot < cap
    buf_pos = torch.where(keep, e_flat * cap + slot, num_experts * cap)
    return keep, buf_pos


def _combine(weighted: torch.Tensor, buf_pos: torch.Tensor, top_e: torch.Tensor) -> torch.Tensor:
    """Each token's sum of its kept, weighted expert outputs.

    weighted (B, E, C, d); buf_pos (B, S·k) as ``dispatch_plan`` gives
    it; top_e (B, S, k).  The JAX code scatter-adds the (E·C) buffer rows
    into a zero (S, d) array; XLA's CPU scatter applies the rows in order
    and rounds to the compute dtype after each add.  Here a token gathers
    its ≤ k rows (a dropped one reads a zero row), orders them by expert
    id (its experts are distinct, so that is the buffer's order) and adds
    them to zero one at a time: the same sums in the same order."""
    b, e, c, d = weighted.shape
    s, k = top_e.shape[1], top_e.shape[2]
    rows = torch.cat([weighted.reshape(b, e * c, d), weighted.new_zeros((b, 1, d))], dim=1)
    order = torch.argsort(top_e, dim=-1)
    pos = torch.gather(buf_pos.reshape(b, s, k), -1, order).reshape(b, s * k, 1)
    contrib = torch.gather(rows, 1, pos.expand(-1, -1, d)).reshape(b, s, k, d)
    out = weighted.new_zeros((b, s, d))
    for j in range(k):
        out = out + contrib[:, :, j]
    return out


def moe_apply(
    p: Params, cfg: MoEConfig, x: torch.Tensor, *, losses: bool = True
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) → (B, S, d), plus the aux-loss dict (empty when
    ``losses`` is False: serving reads no loss, and XLA drops the unused
    ones from the JAX package's jitted serving path). Groups = sequences.

    Decode special case (S == 1): per-sequence groups would give every
    group capacity max(k/E·f, 4) ≈ 4 slots × E — 100×+ padding for 1-token
    groups.  Fold the whole batch into ONE dispatch group instead
    (capacity scales with B·k/E), as the JAX code does; a serving engine's
    idle slots take part in that routing in both packages."""
    if x.shape[1] == 1 and x.shape[0] > 1:
        out, aux = moe_apply(p, cfg, x.reshape(1, x.shape[0], x.shape[2]), losses=losses)
        return out.reshape(x.shape), aux
    b, s, d = x.shape
    k, e, cd = cfg.top_k, cfg.num_experts, cfg.compute_dtype
    cap = capacity(cfg, s)

    # ---- routing (f32 numerics)
    logits, probs, top_p, top_e = route(p, cfg, x)

    # ---- aux losses (scatter-count density, no blowup)
    aux: Dict[str, torch.Tensor] = {}
    if losses:
        counts = torch.zeros((b, e), dtype=torch.float32, device=x.device)
        counts.scatter_add_(1, top_e.reshape(b, s * k),
                            torch.ones((b, s * k), dtype=torch.float32, device=x.device))
        density = counts.mean(dim=0) / s
        mean_prob = probs.mean(dim=(0, 1))
        aux["balance_loss"] = e * torch.sum(density * mean_prob) * cfg.balance_loss_weight
        z = torch.logsumexp(logits, dim=-1)
        aux["z_loss"] = torch.mean(z * z) * cfg.z_loss_weight

    # ---- per-group slotting and the dispatch of token indices and weights
    _, buf_pos = dispatch_plan(top_e, e, cap)
    tok_idx = torch.arange(s, dtype=torch.int64, device=x.device).repeat_interleave(k)
    table = torch.full((b, e * cap + 1), s, dtype=torch.int64, device=x.device)
    table = table.scatter(1, buf_pos, tok_idx.expand(b, -1))
    w_table = torch.zeros((b, e * cap + 1), dtype=cd, device=x.device)
    w_table = w_table.scatter(1, buf_pos, top_p.reshape(b, s * k).to(cd))
    routing = table[:, :-1].reshape(b, e, cap)
    w_slot = w_table[:, :-1].reshape(b, e, cap)

    # ---- expert inputs: one batched gather (row s is the zero pad)
    x_pad = torch.cat([x.to(cd), torch.zeros((b, 1, d), dtype=cd, device=x.device)], dim=1)
    grouped = torch.gather(x_pad, 1, routing.reshape(b, e * cap, 1).expand(-1, -1, d))
    grouped = grouped.reshape(b, e, cap, d)

    # ---- expert FFN
    we = p["experts"]
    g = torch.einsum("becd,edf->becf", grouped, we["gate"].to(cd))
    u = torch.einsum("becd,edf->becf", grouped, we["up"].to(cd))
    h = F.silu(g) * u
    out_e = torch.einsum("becf,efd->becd", h, we["down"].to(cd))

    # ---- combine
    weighted = out_e * w_slot[..., None]
    combined = _combine(weighted, buf_pos, top_e)
    if cfg.num_shared:
        combined = combined + swiglu(p["shared"], x, compute_dtype=cd)
    return combined, aux
