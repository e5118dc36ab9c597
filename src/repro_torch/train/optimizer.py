"""Optimizers, built from scratch: AdamW and a low-memory Adafactor.

The state keeps the JAX package's layout, leaf for leaf: ``{"m", "v",
"count"}`` with each moment shaped as its parameter (Adafactor: ``m`` in
bfloat16, ``v`` as ``{"row", "col"}`` for rank >= 2 leaves — a stacked
leaf's rows and columns carry its layer axis — and ``{"full"}`` below),
so a checkpoint of either package restores in the other.

The arithmetic is the JAX package's, in float32 and in its order: the
step's ``lr``, ``b1 ** count`` and the bias corrections are float32
tensors, constants round to float32 where they meet one.  Weight decay
applies to every leaf, norm scales included.  The updates are in place
(the parameters, moments and count are overwritten, as JAX's donated
buffers are) and return the same trees.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.utils.tree import flatten_up_to, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    #: moment dtypes — bf16 moments halve optimizer memory
    m_dtype: Any = torch.float32
    v_dtype: Any = torch.float32


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _count(params: Any) -> torch.Tensor:
    return _zeros((), torch.int32, tree_leaves(params)[0])


# -------------------------------------------------------------------- AdamW
def adamw_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    return {
        "m": tree_map(lambda p: _zeros(p.shape, cfg.m_dtype, p), params),
        "v": tree_map(lambda p: _zeros(p.shape, cfg.v_dtype, p), params),
        "count": _count(params),
    }


@torch.no_grad()
def adamw_update(
    params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig, lr: torch.Tensor
) -> Tuple[Any, Dict[str, Any]]:
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1**c
    bc2 = 1.0 - cfg.b2**c
    for p, g, m, v in zip(tree_leaves(params), flatten_up_to(params, grads),
                          flatten_up_to(params, state["m"]), flatten_up_to(params, state["v"])):
        g32 = g.to(torch.float32)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * (g32 * g32)
        step = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        m.copy_(m_new)
        v.copy_(v_new)
    state["count"].copy_(count)
    return params, state


# ---------------------------------------------------------------- Adafactor
def adafactor_init(params: Any, cfg: AdamWConfig) -> Dict[str, Any]:
    """Factored v for rank>=2 leaves (rows+cols vectors), bf16 m."""

    def v_like(p):
        if p.ndim >= 2:
            return {
                "row": _zeros(p.shape[:-1], torch.float32, p),
                "col": _zeros(p.shape[:-2] + p.shape[-1:], torch.float32, p),
            }
        return {"full": _zeros(p.shape, torch.float32, p)}

    return {
        "m": tree_map(lambda p: _zeros(p.shape, torch.bfloat16, p), params),
        "v": tree_map(v_like, params),
        "count": _count(params),
    }


@torch.no_grad()
def adafactor_update(
    params: Any, grads: Any, state: Dict[str, Any], cfg: AdamWConfig, lr: torch.Tensor
) -> Tuple[Any, Dict[str, Any]]:
    for p, g, m, v in zip(tree_leaves(params), flatten_up_to(params, grads),
                          flatten_up_to(params, state["m"]), flatten_up_to(params, state["v"])):
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + 1e-30
        if p.ndim >= 2:
            row = cfg.b2 * v["row"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
            col = cfg.b2 * v["col"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
            denom_r = row / torch.clamp(torch.mean(row, dim=-1, keepdim=True), min=1e-30)
            vhat = denom_r[..., None] * col[..., None, :]
            v["row"].copy_(row)
            v["col"].copy_(col)
        else:
            vhat = cfg.b2 * v["full"] + (1 - cfg.b2) * g2
            v["full"].copy_(vhat)
        update = g32 / torch.sqrt(vhat + cfg.eps)
        m_new = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * update
        step = m_new + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
        m.copy_(m_new)  # rounds to m's bfloat16
    state["count"].add_(1)
    return params, state


OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
}
