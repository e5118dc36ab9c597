"""Plain PyTorch version of the fused filter + grouped aggregation.

Same semantics as the CUDA kernel (and the JAX package's Pallas kernel):
the predicate compares in float32 with the threshold cast to float32,
values are summed in float32, and keys outside ``[0, num_groups)`` — -1
included — contribute nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch

_OPS = ("ge", "gt", "le", "lt", "eq", "ne")


def _mask(filter_vals: torch.Tensor, op: str, threshold: float) -> torch.Tensor:
    f = filter_vals.to(torch.float32)
    t = torch.tensor(threshold, dtype=torch.float32, device=f.device)
    if op == "ge":
        return f >= t
    if op == "gt":
        return f > t
    if op == "le":
        return f <= t
    if op == "lt":
        return f < t
    if op == "eq":
        return f == t
    if op == "ne":
        return f != t
    raise ValueError(f"op must be one of {_OPS}, got {op!r}")


def fused_filter_agg_ref(
    keys: torch.Tensor,         # int32[n] group ids; others are dropped
    values: torch.Tensor,       # int32|float32[n]
    filter_vals: torch.Tensor,  # int32|float32[n] — predicate column
    *,
    op: str,
    threshold: float,
    num_groups: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sums f32[num_groups], counts f32[num_groups]) over rows
    passing ``filter_vals <op> threshold`` whose key is a group id."""
    keep = _mask(filter_vals, op, threshold) & (keys >= 0) & (keys < num_groups)
    idx = keys[keep].long()
    dev = keys.device
    sums = torch.zeros((num_groups,), dtype=torch.float32, device=dev)
    counts = torch.zeros((num_groups,), dtype=torch.float32, device=dev)
    sums.index_add_(0, idx, values[keep].to(torch.float32))
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    return sums, counts
