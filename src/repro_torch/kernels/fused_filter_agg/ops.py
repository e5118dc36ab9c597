"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels.build import device_and_stream, load_library
from repro_torch.kernels.fused_filter_agg.ref import _OPS, fused_filter_agg_ref

SOURCE = Path(__file__).parent / "csrc" / "fused_filter_agg.cu"

#: each of a block's 8 warps keeps a (sum, count) bin a group in shared
#: memory, 64 KB at 1024 groups; up to this many groups the kernel is one
#: launch whose last block merges (engine/route.py's default cap)
MAX_GROUPS = 1024

#: the groups are cut into windows of at most this many, one block per
#: (row block, window) (the kernel's kWindow); above MAX_GROUPS a second
#: launch merges the blocks' partials
WINDOW = 3072

#: rows a block covers, before the caps on the number of blocks; the caps
#: bound the partials that are merged (P x G)
ROWS_PER_BLOCK = 8192
MAX_BLOCKS = 1024
#: most partial entries (P x G) a launch writes: 32 MB of sums and counts
MAX_PARTIALS = 1 << 22

#: kernel launches made through this wrapper (CUDA tensors only), counted
#: under ``_lock``: pipeline stages launch from executor threads
LAUNCHES = 0

_VALUE_DTYPES = (torch.int32, torch.float32)
_lib = None
#: the completion counter of each (device, stream): 0 between calls, since
#: the kernel's last block puts it back; made once, with one memset
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}
#: guards the making of a ticket and the launch count
_lock = threading.Lock()


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fused_filter_agg_launch.argtypes = [
            i32, vp, vp, i32, vp, i32, i64, i32, ctypes.c_float,
            i32, i32, i64, i32, vp, vp, vp, vp, vp, vp,
        ]
        lib.fused_filter_agg_launch.restype = i32
        lib.fused_filter_agg_error_string.argtypes = [i32]
        lib.fused_filter_agg_error_string.restype = ctypes.c_char_p
        lib.fused_filter_agg_tile_rows.restype = i32
        _lib = lib
    return _lib


def grid(n: int, tile_rows: int, num_groups: int = 1) -> Tuple[int, int]:
    """``(blocks, rows_per_block)`` for ``n`` rows and ``num_groups``: a
    function of ``(n, G)`` alone, and of ``n`` alone up to 4096 groups,
    so float sums are the same on every run and every card; rows a
    multiple of the kernel's tile, so every block starts on a 16-byte
    boundary of an aligned column.  Blocks are at most MAX_PARTIALS / G."""
    cap = min(MAX_BLOCKS, max(1, MAX_PARTIALS // max(num_groups, 1)))
    blocks = max(1, min(cap, -(-n // ROWS_PER_BLOCK)))
    rows = -(-max(n, 1) // blocks)
    rows = -(-rows // tile_rows) * tile_rows
    return max(1, -(-n // rows)), rows


def windows(num_groups: int) -> Tuple[int, int]:
    """``(windows, widest)``: the group windows of a launch (the fewest
    of at most WINDOW groups, as even as they go) and the most groups one
    window holds."""
    n = -(-num_groups // WINDOW)
    return n, -(-num_groups // n)


def smem_bytes(num_groups: int) -> int:
    """Shared memory a block of the kernel takes: dynamic, 8 warps' bins
    (a float32 sum and an int32 count a group of its window) and 32 lane
    values each; static, the last block's 256 float32 and 256 int64 slice
    totals and a flag."""
    return 8 * windows(num_groups)[1] * 8 + 8 * 32 * 4 + 256 * (4 + 8) + 1


def _ticket(index: int, stream: int, device: torch.device) -> torch.Tensor:
    ticket = _tickets.get((index, stream))
    if ticket is None:
        # threads that share a stream (the default stream is every
        # thread's) must share its ticket: one is made, under the lock
        with _lock:
            ticket = _tickets.setdefault(
                (index, stream), torch.zeros(1, dtype=torch.int32, device=device)
            )
    return ticket


def _count_launch() -> None:
    global LAUNCHES
    with _lock:
        LAUNCHES += 1


def _aligned(*tensors: torch.Tensor) -> int:
    """Bit i set: tensor i starts on a 16-byte boundary (the kernel's
    16-byte loads); others are read 4 bytes at a time."""
    return sum(1 << i for i, t in enumerate(tensors) if t.data_ptr() % 16 == 0)


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


def _launch(lib, keys, values, filter_vals, op, threshold, num_groups, *, index, stream):
    """Allocate the blocks' partials and the outputs, and launch on
    ``stream`` (once; above MAX_GROUPS groups the library adds the merge
    launch).  The tensors go to the kernel as they are."""
    n = keys.shape[0]
    blocks, rows_per_block = grid(n, lib.fused_filter_agg_tile_rows(), num_groups)
    dev = keys.device
    # the blocks' float32 sums, then their int32 counts; then the outputs
    parts = torch.empty(2 * blocks * num_groups, dtype=torch.int32, device=dev)
    out = torch.empty((2, num_groups), dtype=torch.float32, device=dev)
    code = lib.fused_filter_agg_launch(
        index, keys.data_ptr(), values.data_ptr(), int(values.dtype == torch.int32),
        filter_vals.data_ptr(), int(filter_vals.dtype == torch.int32),
        n, _OPS.index(op), float(threshold), num_groups, blocks, rows_per_block,
        _aligned(keys, values, filter_vals), parts.data_ptr(),
        parts.data_ptr() + blocks * num_groups * 4, _ticket(index, stream, dev).data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), stream,
    )
    if code != 0:
        msg = lib.fused_filter_agg_error_string(code).decode()
        raise RuntimeError(f"fused_filter_agg launch failed: {msg} ({code})")
    return out[0], out[1]


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
    launch the kernel on the current stream without synchronising (views
    that do not start on a 16-byte boundary included; above MAX_GROUPS
    groups a second launch merges the windows' partials); CPU tensors take
    the plain version.
    """
    _check(keys, values, filter_vals, op, num_groups)
    if keys.device.type == "cpu":
        return fused_filter_agg_ref(
            keys, values, filter_vals,
            op=op, threshold=threshold, num_groups=num_groups,
        )
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    index, stream = device_and_stream(keys)
    out = _launch(load(), keys, values, filter_vals, op, threshold, num_groups,
                  index=index, stream=stream)
    _count_launch()
    return out
