"""The work a scoring batch asks of the card, counted from shapes, and the
card's peaks.

The arithmetic is copied from two places in the repository, so that the
yardstick does not move when they do: ``chip_smoke.py``'s flash bound (the
products over the visible (query, key) pairs, 4 * H * D a pair, at the
bf16 tensor-core peak; the bytes of q, k, v and the output at HBM's rate)
and ``repro_torch/launch/roofline.py``'s model FLOPs (2 * N_active a
token for a forward).  Every count here is of what the inputs need, not of
what a kernel happens to compute: the masked half of a causal tile is not
work.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: dense bf16 tensor-core FLOP/s of one H100 SXM at its 700 W limit
#: (NVIDIA's data sheet, without sparsity)
PEAK_BF16_FLOPS = 989e12
#: HBM3 bytes/s of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Shape:
    """The widths of a dense decoder that the counts need."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    window: Optional[int] = None


def matmul_params(shape: Shape) -> int:
    """Weights that multiply activations in a forward: each layer's q, k,
    v and output projections and its SwiGLU (gate, up, down), and the
    untied head.  The embedding is a gather, not a product."""
    qo = 2 * shape.d_model * shape.n_heads * shape.d_head
    kv = 2 * shape.d_model * shape.n_kv_heads * shape.d_head
    mlp = 3 * shape.d_model * shape.d_ff
    return shape.n_layers * (qo + kv + mlp) + shape.d_model * shape.vocab


def matmul_flops_per_token(shape: Shape) -> int:
    """2 * N a token (``launch/roofline.py``'s MODEL_FLOPS for a forward)."""
    return 2 * matmul_params(shape)


def visible_pairs(seq_len: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal row of ``seq_len`` tokens attends to;
    with a window, query i sees min(i + 1, window) keys."""
    if window is None or window >= seq_len:
        return seq_len * (seq_len + 1) // 2
    return sum(min(i + 1, window) for i in range(seq_len))


def attention_flops(shape: Shape, batch: int, seq_len: int) -> int:
    """q.k and p.v over the visible pairs, 4 * H * D a pair, every layer."""
    pairs = batch * visible_pairs(seq_len, shape.window)
    return 4 * shape.n_heads * shape.d_head * pairs * shape.n_layers


def batch_flops(shape: Shape, batch: int, seq_len: int) -> int:
    """The model FLOPs of one forward over a batch (B, S)."""
    return (matmul_flops_per_token(shape) * batch * seq_len
            + attention_flops(shape, batch, seq_len))


def flash_launch_flops(shape: Shape, batch: int, seq_len: int) -> int:
    """One flash launch: one layer's attention over the whole batch."""
    return 4 * shape.n_heads * shape.d_head * batch * visible_pairs(seq_len, shape.window)


def flash_launch_bytes(shape: Shape, batch: int, seq_len: int, itemsize: int = 2) -> int:
    """q, k, v read once and the output written once."""
    q_and_out = 2 * batch * shape.n_heads * seq_len * shape.d_head
    k_and_v = 2 * batch * shape.n_kv_heads * seq_len * shape.d_head
    return (q_and_out + k_and_v) * itemsize


def flash_launch_bound_s(shape: Shape, batch: int, seq_len: int) -> float:
    """The least time one bf16 flash launch can take on the card: the
    larger of its products at the tensor-core peak and its bytes at HBM's
    rate."""
    return max(flash_launch_flops(shape, batch, seq_len) / PEAK_BF16_FLOPS,
               flash_launch_bytes(shape, batch, seq_len) / HBM_BYTES_PER_S)
