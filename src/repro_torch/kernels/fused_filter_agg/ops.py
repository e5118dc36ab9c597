"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

import torch

from repro_torch.kernels.build import device_and_stream, load_library
from repro_torch.kernels.fused_filter_agg.ref import _OPS, fused_filter_agg_ref

SOURCE = Path(__file__).parent / "csrc" / "fused_filter_agg.cu"

#: each of a block's 8 warps keeps a (sum, count) bin a group in shared
#: memory, 64 KB at 1024 groups; up to this many groups the kernel is one
#: launch whose last block merges (engine/route.py's default cap)
MAX_GROUPS = 1024

#: rows a block of the one-launch kernel covers, before the cap on the
#: number of blocks; the cap bounds the partials the last block adds (P x G)
ROWS_PER_BLOCK = 8192
MAX_BLOCKS = 1024

#: above MAX_GROUPS (three launches, ``many_plan``): a bin block holds a
#: window of at most this many groups (the kernel's kWindow); a partition
#: block stages this many rows (kPartRows); a partition block counts at
#: most this many buckets (kMaxBuckets: a bucket is one window, or
#: neighbouring windows above WINDOW x MAX_BUCKETS groups); and the bin
#: launch aims at this many blocks (a constant, never the SM count, so the
#: float sums depend on (n, G) alone)
WINDOW = 1024
PART_ROWS = 2048
MAX_BUCKETS = 1024
BIN_BLOCKS = 396
#: a bin block stages this many row blocks' segment offsets at a time, and
#: its warps take units of 32 consecutive pairs of the batch in turn
#: (kSegBatch)
SEG_BATCH = 512

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
        lib.fused_filter_agg_many_launch.argtypes = [
            i32, vp, vp, i32, vp, i32, i64, i32, ctypes.c_float,
            i32, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.fused_filter_agg_many_launch.restype = i32
        lib.fused_filter_agg_error_string.argtypes = [i32]
        lib.fused_filter_agg_error_string.restype = ctypes.c_char_p
        lib.fused_filter_agg_tile_rows.restype = i32
        _lib = lib
    return _lib


def grid(n: int, tile_rows: int) -> Tuple[int, int]:
    """``(blocks, rows_per_block)`` of the one-launch kernel for ``n``
    rows: a function of ``n`` alone, so float sums are the same on every
    run and every card; rows a multiple of the kernel's tile, so every
    block starts on a 16-byte boundary of an aligned column."""
    blocks = max(1, min(MAX_BLOCKS, -(-n // ROWS_PER_BLOCK)))
    rows = -(-max(n, 1) // blocks)
    rows = -(-rows // tile_rows) * tile_rows
    return max(1, -(-n // rows)), rows


def windows(num_groups: int) -> Tuple[int, int]:
    """``(windows, width)``: the groups cut into windows of ``width``
    groups (the last may have fewer), the fewest of at most WINDOW groups,
    as even as whole widths go; window w holds groups [w width, (w + 1)
    width)."""
    width = -(-num_groups // -(-num_groups // WINDOW))
    return -(-num_groups // width), width


class ManyPlan(NamedTuple):
    """The launches above MAX_GROUPS groups (fused_filter_agg.cu's header):
    ``row_blocks`` partition blocks of PART_ROWS rows; ``windows`` windows
    of ``width`` groups; ``buckets`` buckets of ``per_bucket`` windows
    (one window a bucket up to WINDOW x MAX_BUCKETS groups); and the bin
    launch's ``chunks`` of row blocks, a bin block per (window, chunk)."""
    row_blocks: int
    windows: int
    width: int
    buckets: int
    per_bucket: int
    chunks: int


def many_plan(n: int, num_groups: int) -> ManyPlan:
    """The plan of a call over ``n`` rows above MAX_GROUPS groups, from
    (n, G) alone."""
    w, width = windows(num_groups)
    per = -(-w // MAX_BUCKETS)
    row_blocks = max(1, -(-n // PART_ROWS))
    chunks = max(1, min(row_blocks, -(-BIN_BLOCKS // w)))
    return ManyPlan(row_blocks, w, width, -(-w // per), per, chunks)


def scratch_bytes(n: int, num_groups: int) -> Dict[str, int]:
    """The device scratch a call above MAX_GROUPS groups allocates: the
    pair buffer (8 B a row: the passing rows' key and float32 value, by
    bucket), the row blocks' bucket offsets, and the bin blocks' float32
    sum and int32 count partials (a chunk x G each)."""
    p = many_plan(n, num_groups)
    return {"pairs": 8 * n, "offsets": 4 * p.row_blocks * (p.buckets + 1),
            "partials": 8 * p.chunks * num_groups}


def launch_sequence(n: int, num_groups: int) -> List[Tuple[str, int]]:
    """The kernels a call launches, in order, with their blocks: the
    one-launch kernel up to MAX_GROUPS groups; above, partition_rows,
    bin_buckets (a block per window and chunk) and merge_partials (a
    thread a group)."""
    if num_groups <= MAX_GROUPS:
        return [("fused_filter_agg_kernel", grid(n, 2048)[0])]
    p = many_plan(n, num_groups)
    return [("partition_rows", p.row_blocks), ("bin_buckets", p.windows * p.chunks),
            ("merge_partials", -(-num_groups // 32))]


def smem_bytes(num_groups: int) -> int:
    """Shared memory a block takes, the most of a call's kernels: up to
    MAX_GROUPS groups the one-launch kernel's (dynamic, 8 warps' bins, a
    float32 sum and an int32 count a group, and 32 lane values each;
    static, the last block's 256 float32 and 256 int64 slice totals and a
    flag); above, partition_rows' (PART_ROWS staged pairs, (bucket, rank)
    entries and places, 8 warps' counts a bucket and the bucket offsets)
    or bin_buckets' (the bins of one window, 32 lane values a warp, and
    SEG_BATCH row blocks' segment offsets and first pairs)."""
    if num_groups <= MAX_GROUPS:
        return 8 * num_groups * 8 + 8 * 32 * 4 + 256 * (4 + 8) + 1
    p = many_plan(0, num_groups)
    partition = PART_ROWS * 16 + 8 * p.buckets * 4 + (p.buckets + 1) * 4 + 8 * 4
    return max(partition, 8 * p.width * 8 + 8 * 32 * 4 + (2 * SEG_BATCH + 1 + 8) * 4)


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
    """Allocate the partials (and above MAX_GROUPS groups the rest of the
    scratch) and the outputs, and launch on ``stream``: once up to
    MAX_GROUPS groups, else the three launches of ``many_plan``.  The
    tensors go to the kernels as they are."""
    n = keys.shape[0]
    dev = keys.device
    out = torch.empty((2, num_groups), dtype=torch.float32, device=dev)
    common = (keys.data_ptr(), values.data_ptr(), int(values.dtype == torch.int32),
              filter_vals.data_ptr(), int(filter_vals.dtype == torch.int32),
              n, _OPS.index(op), float(threshold), num_groups)
    aligned = _aligned(keys, values, filter_vals)
    if num_groups <= MAX_GROUPS:
        blocks, rows_per_block = grid(n, lib.fused_filter_agg_tile_rows())
        # the blocks' float32 sums, then their int32 counts
        parts = torch.empty(2 * blocks * num_groups, dtype=torch.int32, device=dev)
        code = lib.fused_filter_agg_launch(
            index, *common, blocks, rows_per_block, aligned, parts.data_ptr(),
            parts.data_ptr() + blocks * num_groups * 4,
            _ticket(index, stream, dev).data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            stream,
        )
    else:
        p = many_plan(n, num_groups)
        pairs = torch.empty(2 * n, dtype=torch.int32, device=dev)
        offsets = torch.empty(p.row_blocks * (p.buckets + 1), dtype=torch.int32, device=dev)
        parts = torch.empty(2 * p.chunks * num_groups, dtype=torch.int32, device=dev)
        code = lib.fused_filter_agg_many_launch(
            index, *common, p.row_blocks, p.windows, p.width, p.buckets, p.per_bucket,
            p.chunks, aligned, pairs.data_ptr(), offsets.data_ptr(), parts.data_ptr(),
            parts.data_ptr() + p.chunks * num_groups * 4, out[0].data_ptr(),
            out[1].data_ptr(), stream,
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
    groups three launches: the rows partitioned by group window, each
    window binned, the partials merged); CPU tensors take the plain
    version.
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
