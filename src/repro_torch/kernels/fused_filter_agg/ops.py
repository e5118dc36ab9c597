"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.fused_filter_agg.ref import _OPS, fused_filter_agg_ref

SOURCE = Path(__file__).parent / "csrc" / "fused_filter_agg.cu"

#: one thread of a block owns each group, so a launch takes at most a
#: block's 1024 threads' worth of groups (engine/route.py caps at this)
MAX_GROUPS = 1024

#: rows a pass-1 block covers, before the cap on the number of blocks
ROWS_PER_BLOCK = 8192
MAX_BLOCKS = 4096

#: kernel launches made through this wrapper (CUDA tensors only)
LAUNCHES = 0

_VALUE_DTYPES = (torch.int32, torch.float32)
_lib = None


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_filter_agg_launch.argtypes = [
            i32, vp, vp, i32, vp, i32, i64, i32, ctypes.c_float,
            i32, i32, i64, vp, vp, vp, vp, vp,
        ]
        lib.fused_filter_agg_launch.restype = i32
        lib.fused_filter_agg_error_string.argtypes = [i32]
        lib.fused_filter_agg_error_string.restype = ctypes.c_char_p
        lib.fused_filter_agg_tile_rows.restype = i32
        _lib = lib
    return _lib


def grid(n: int, tile_rows: int) -> Tuple[int, int]:
    """``(blocks, rows_per_block)`` for ``n`` rows: a function of ``n``
    alone, so float sums are the same on every run and every card."""
    blocks = max(1, min(MAX_BLOCKS, -(-n // ROWS_PER_BLOCK)))
    rows = -(-max(n, 1) // blocks)
    rows = -(-rows // tile_rows) * tile_rows
    return max(1, -(-n // rows)), rows


def _check(keys, values, filter_vals, op: str, num_groups: int) -> None:
    tensors = (("keys", keys), ("values", values), ("filter_vals", filter_vals))
    for name, t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != keys.device:
            raise ValueError(f"{name} is on {t.device}, keys on {keys.device}")
        if t.shape[0] != keys.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} rows, keys {keys.shape[0]}")
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    for name, t in tensors[1:]:
        if t.dtype not in _VALUE_DTYPES:
            raise TypeError(f"{name} must be int32 or float32, got {t.dtype}")
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    if num_groups < 1:
        raise ValueError(f"num_groups must be positive, got {num_groups}")


def fused_filter_agg(
    keys: torch.Tensor,         # int32[n]
    values: torch.Tensor,       # int32|float32[n]
    filter_vals: torch.Tensor,  # int32|float32[n]
    *,
    op: str = "ge",
    threshold: float = 0.0,
    num_groups: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped (sum, count) over rows passing the predicate — one pass.

    Returns ``(sums f32[num_groups], counts f32[num_groups])``.  Rows whose
    key lies outside ``[0, num_groups)`` contribute nothing.  CUDA tensors
    launch the kernel on the current stream without synchronising; CPU
    tensors take the plain version.
    """
    global LAUNCHES
    _check(keys, values, filter_vals, op, num_groups)
    if keys.device.type == "cpu":
        return fused_filter_agg_ref(
            keys, values, filter_vals,
            op=op, threshold=threshold, num_groups=num_groups,
        )
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if num_groups > MAX_GROUPS:
        raise ValueError(
            f"num_groups={num_groups} exceeds the kernel's {MAX_GROUPS}"
        )
    lib = load()
    n = keys.shape[0]
    blocks, rows_per_block = grid(n, lib.fused_filter_agg_tile_rows())
    dev = keys.device
    part_sums = torch.empty(blocks * num_groups, dtype=torch.float32, device=dev)
    part_counts = torch.empty(blocks * num_groups, dtype=torch.int32, device=dev)
    sums = torch.empty(num_groups, dtype=torch.float32, device=dev)
    counts = torch.empty(num_groups, dtype=torch.float32, device=dev)
    code = lib.fused_filter_agg_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        keys.data_ptr(), values.data_ptr(), int(values.dtype == torch.int32),
        filter_vals.data_ptr(), int(filter_vals.dtype == torch.int32),
        n, _OPS.index(op), float(threshold), num_groups, blocks,
        rows_per_block, part_sums.data_ptr(), part_counts.data_ptr(),
        sums.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        msg = lib.fused_filter_agg_error_string(code).decode()
        raise RuntimeError(f"fused_filter_agg launch failed: {msg} ({code})")
    LAUNCHES += 1
    return sums, counts
