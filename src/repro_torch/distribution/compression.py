"""Int8 gradient compression with error feedback.

On a multi-node deployment the data-parallel gradient all-reduce crosses
the slow links between hosts; quantizing to int8 cuts those bytes 4x.
The error-feedback accumulator keeps the quantization *unbiased over
time* (residuals are re-added next step), which is what makes compressed
SGD converge like exact SGD.

On one device the transform is expressed at the value level (quantize →
dequantize where the reduction would be); the saving in bytes belongs to
the collective.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so both packages quantize alike.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.utils.tree import flatten_with_paths, tree_map, unflatten_like

CompressionState = Any  # tree of float32 residuals, the structure of the grads


def init_compression(grads_like: Any) -> CompressionState:
    return tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like
    )


def _quantize_leaf(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g32 = g.to(torch.float32) + err  # error feedback
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    new_err = g32 - deq  # residual carried to the next step
    return deq.to(g.dtype), new_err


def compress_decompress(grads: Any, state: CompressionState) -> Tuple[Any, CompressionState]:
    """Apply int8+EF quantization leaf-wise. Returns (grads', new_state)."""
    residuals = flatten_with_paths(state)
    out = {k: _quantize_leaf(g, residuals[k]) for k, g in flatten_with_paths(grads).items()}
    return (unflatten_like(grads, {k: v[0] for k, v in out.items()}),
            unflatten_like(grads, {k: v[1] for k, v in out.items()}))
