"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import device_and_stream, load_library
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "decode_attention.cu"

#: the JAX wrapper's cache block; it fixes the ``S % block`` contract only,
#: since the CUDA kernel splits the cache by its own plan (``split_plan``)
DEFAULT_BLOCK_S = 1024

#: head widths the kernels are compiled for, cache rows of exactly that
#: many elements: the ported configs' (yi-6b and granite-34b 128, qwen3-32b
#: 80, h2o-danube-3-4b 120, musicgen-medium 64, recurrentgemma-9b 256), and 32
HEAD_DIMS = (32, 64, 80, 120, 128, 256)

#: widths of the ``_any`` kernels, which read rows of any length up to the
#: width as they are (never a copy): a head dim that is none of HEAD_DIMS
#: runs the smallest of them at or above it (``width``)
ANY_WIDTHS = (32, 64, 128, 256)

#: head dims above this run ``decode_wide``: a block a batch of at most
#: WIDE_HEADS q heads (the n8 of its products) and a chunk of at most
#: WIDE_CHUNK cache rows, streamed through a ring of WIDE_STAGES cp.async
#: stages of WIDE_TILE-byte tiles: k tiles of WIDE_PIECE columns (q.k summed
#: over the pieces), then v tiles of WIDE_SLICE_BYTES a row (p.v's output
#: slices, ``wide_slice``); each k stage also holds the batch's q piece
#: (WIDE_Q_BYTES)
WIDE_ABOVE = 256
WIDE_HEADS = 8
WIDE_CHUNK = 512
WIDE_PIECE = 64
WIDE_SLICE_BYTES = 512
WIDE_TILE = 16384
WIDE_Q_BYTES = 2048
WIDE_STAGES = 4

#: cache rows a chunk is a multiple of (the kernel's bf16 tile)
CHUNK_ALIGN = 64

#: most q heads per kv head a block serves (the kernel's kMaxGroup); wider
#: groups are cut into slices of at most this many (``group_slices``), a
#: block each
MAX_GROUP = 64

#: bf16 and float16 groups above this run decode_group, every head of a
#: slice in the rows of one product (the kernel's kNarrowGroup); narrower
#: groups, and float32, run decode_split
NARROW_GROUP = 8

#: cache rows a decode_group step (kGroupRows); its chunks are multiples
GROUP_ROWS = 64

#: kernel calls made through this wrapper (CUDA tensors only); one a call,
#: though a call with more than one chunk launches a combine kernel too
LAUNCHES = 0

#: the library's dtype codes; it refuses any other
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
_lib = None
#: guards the launch count: launches may come from several threads
_lock = threading.Lock()


def _count_launch() -> None:
    global LAUNCHES
    with _lock:
        LAUNCHES += 1


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, vp,
        ]
        lib.decode_attention_launch.restype = i32
        lib.decode_attention_error_string.argtypes = [i32]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def width(head_dim: int) -> int:
    """The compiled width a call at ``head_dim`` runs: ``head_dim`` where
    it is one of HEAD_DIMS or above WIDE_ABOVE (``decode_wide`` takes any),
    else the smallest of ANY_WIDTHS at or above it (an ``_any`` kernel)."""
    if head_dim in HEAD_DIMS or head_dim > WIDE_ABOVE:
        return head_dim
    return next(w for w in ANY_WIDTHS if w >= head_dim)


def group_slices(group: int) -> Tuple[int, int]:
    """``(n_slices, slice)``: a group of q heads cut into the fewest slices
    of at most MAX_GROUP heads, ``slice`` = ceil(group / n_slices) each
    (the last may have fewer), one block a slice."""
    n = -(-group // MAX_GROUP)
    return n, -(-group // n)


def decode_kernel(dtype: torch.dtype, group: int, head_dim: int) -> str:
    """The kernel a call launches, named as ptxas's report names it:
    ``decode_group<T, D, MT>`` (bf16 and float16 groups above NARROW_GROUP,
    MT m-tiles of 16 heads of a slice), else ``decode_split<T, D>``; D is
    the compiled width (``width``), and a head dim that is not one of
    HEAD_DIMS runs the ``_any`` kernel (``decode_split_any<T, D>``); a head
    dim above WIDE_ABOVE runs ``decode_wide<T>``, or ``decode_wide_narrow<T>``
    where a row's bytes are not a multiple of 16."""
    if head_dim > WIDE_ABOVE:
        narrow = "_narrow" if head_dim * dtype.itemsize % 16 else ""
        return f"decode_wide{narrow}<{_SHORT[dtype]}>"
    w = width(head_dim)
    any_ = "" if head_dim in HEAD_DIMS else "_any"
    if dtype != torch.float32 and group > NARROW_GROUP:
        mt = -(-group_slices(group)[1] // 16)
        return f"decode_group{any_}<{_SHORT[dtype]}, {w}, {mt}>"
    return f"decode_split{any_}<{_SHORT[dtype]}, {w}>"


def split_plan(s: int, n_blocks: int, sms: int, group: int = 1, head_dim: int = 128,
               dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """``(n_splits, chunk)`` for a cache of ``s`` rows read by ``n_blocks``
    = B * Hkv (sequence, kv head) pairs, ``group`` q heads each, on a card
    of ``sms`` SMs, in ``dtype``.  From shapes only: the lengths stay on
    the card.  No chunk is empty at full length.  A group above MAX_GROUP
    has a block per slice (``group_slices``), so n_blocks counts slices.

    decode_split: about two blocks an SM, chunks a multiple of CHUNK_ALIGN
    rows.  decode_group: one block an SM at most (its shared memory allows
    no second), chunks a multiple of GROUP_ROWS rows, and the float32
    partials of all heads, written and read, at most the cache's bytes.
    decode_wide (head dims above WIDE_ABOVE): a block a batch of
    WIDE_HEADS q heads, about two blocks an SM (its shared memory,
    ``wide_smem_bytes``, allows two), chunks a multiple of CHUNK_ALIGN rows
    and at most WIDE_CHUNK (the chunk's scores and p stay in shared
    memory)."""
    if head_dim > WIDE_ABOVE:
        n_blocks *= -(-group // WIDE_HEADS)
        want = min(max(1, -(-2 * sms // n_blocks)), -(-s // CHUNK_ALIGN))
        chunk = -(-(-(-s // want)) // CHUNK_ALIGN) * CHUNK_ALIGN
        chunk = min(chunk, WIDE_CHUNK)
        return -(-s // chunk), chunk
    n_blocks *= group_slices(group)[0]
    if decode_kernel(dtype, group, head_dim).startswith("decode_group"):
        cache = s * head_dim * 2 * 2  # k and v of one (sequence, kv head), 2 bytes each
        per_split = group * (head_dim + 2) * 4 * 2  # its partials, written and read
        want = min(max(1, sms // n_blocks), max(1, cache // per_split), -(-s // GROUP_ROWS))
        align = GROUP_ROWS
    else:
        want = min(max(1, -(-2 * sms // n_blocks)), -(-s // CHUNK_ALIGN))
        align = CHUNK_ALIGN
    chunk = -(-s // want)
    chunk = -(-chunk // align) * align
    return -(-s // chunk), chunk


def partial_bytes(b: int, h: int, head_dim: int, n_splits: int) -> int:
    """Bytes of the float32 partials of a split call: acc and (m, l) of
    every q head and chunk; none with one chunk."""
    return b * h * n_splits * (head_dim + 2) * 4 if n_splits > 1 else 0


def wide_slice(dtype: torch.dtype) -> int:
    """The output columns of a ``decode_wide`` p.v slice in ``dtype``, a v
    tile's width: WIDE_SLICE_BYTES of a row (bf16 and float16 256, float32
    128)."""
    return WIDE_SLICE_BYTES // dtype.itemsize


def wide_tile_rows(dtype: torch.dtype) -> Tuple[int, int]:
    """The cache rows of a ``decode_wide`` k tile and of a v tile in
    ``dtype``: WIDE_TILE bytes of WIDE_PIECE columns and of
    WIDE_SLICE_BYTES (bf16 and float16 128 and 32, float32 64 and 32)."""
    return WIDE_TILE // (WIDE_PIECE * dtype.itemsize), WIDE_TILE // WIDE_SLICE_BYTES


def wide_smem_bytes(dtype: torch.dtype) -> int:
    """The dynamic shared memory of a ``decode_wide`` block in ``dtype``,
    at every head dim: the ring (WIDE_STAGES stages of a tile and a q
    piece), the chunk's float32 scores (WIDE_CHUNK rows x WIDE_HEADS; in
    float32 p overwrites them), in bf16 and float16 p's hi and lo halves
    (WIDE_HEADS rows of WIDE_CHUNK + 8 elements each), and each head's
    (m, l)."""
    ring = WIDE_STAGES * (WIDE_TILE + WIDE_Q_BYTES)
    p = 2 * WIDE_HEADS * (WIDE_CHUNK + 8) * 2 if dtype != torch.float32 else 0
    return ring + WIDE_CHUNK * WIDE_HEADS * 4 + p + 2 * WIDE_HEADS * 4


def _check_cuda(q, k_cache, v_cache, lengths) -> None:
    dev, dt = q.device, q.dtype
    if k_cache.device != dev or v_cache.device != dev or lengths.device != dev:
        raise ValueError(f"q on {dev}, caches on {k_cache.device} and {v_cache.device}, "
                         f"lengths on {lengths.device}")
    if k_cache.dtype != dt or v_cache.dtype != dt:
        raise TypeError(f"q is {dt}, caches {k_cache.dtype} and {v_cache.dtype}")
    if dt not in _DTYPES:
        raise TypeError(f"the kernel takes float32, bfloat16 or float16, got {dt}")
    b, _, d = q.shape
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if d < 1:
        raise ValueError(f"head dim must be at least 1, got {d}")


def _launch(lib, q, k_cache, v_cache, lengths, scale, *, device, stream, sms):
    """Allocate the output and the float32 partials, and launch.  ``q``,
    the caches and ``lengths`` go to the kernel as they are."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    n_splits, chunk = split_plan(s, b * hkv, sms, h // hkv, d, q.dtype)
    # per q head and chunk: acc (D floats), then (m, l); none for one chunk
    rows = b * h * n_splits if n_splits > 1 else 0
    parts = torch.empty(partial_bytes(b, h, d, n_splits) // 4, dtype=torch.float32,
                        device=q.device)
    acc = parts.data_ptr()
    out = torch.empty_like(q)
    code = lib.decode_attention_launch(
        device, _DTYPES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), out.data_ptr(), acc, acc + rows * d * 4,
        b, hkv, h // hkv, s, n_splits, chunk, scale, stream,
    )
    if code != 0:
        msg = lib.decode_attention_error_string(code).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({code})")
    return out


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) integer
    *,
    scale: Optional[float] = None,
    block_s: int = DEFAULT_BLOCK_S,
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` cache
    rows; (B, H, D) in q's dtype, float32, bfloat16 or float16, any D from
    1 up (``decode_wide`` above 256) and any group.  CUDA tensors launch
    the kernels on the current stream without synchronising (the split
    kernel, and a combine when the cache is split), reading the caches as
    they are; CPU tensors take the plain version."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if h % hkv:
        raise AssertionError(f"GQA needs H({h}) % Hkv({hkv}) == 0")
    bs = min(block_s, s)
    if s % bs:
        raise AssertionError((s, bs))
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k_cache, v_cache, lengths)
    lib = load()
    qf, kf, vf = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    if (qf.data_ptr() | kf.data_ptr() | vf.data_ptr()) % 16:
        raise ValueError("q and the caches must start on a 16-byte boundary")
    dev, stream = device_and_stream(q)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # int32 and contiguous (B,) lengths pass as they are; others are copied
    lens = lengths.to(torch.int32).contiguous()
    out = _launch(lib, qf, kf, vf, lens, float(scale), device=dev, stream=stream, sms=sms)
    _count_launch()
    return out
