"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.build import device_and_stream, load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"

#: the JAX wrapper's block sizes; they fix the ``S % block`` contract only,
#: since the CUDA kernels tile by their own (bf16 on ``flash_wgmma``: 128 x
#: 128 at head dims 32, 64, 80, 120 and 128, 128 x 64 at 256;
#: ``flash_tf32``: 128 x 64, and 64 x 32 at 256; the result does not depend
#: on the block: masked keys contribute exactly 0)
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512

#: head widths the kernels are compiled for, rows of exactly that many
#: elements: the ported configs' (yi-6b and granite-34b 128, qwen3-32b 80,
#: h2o-danube-3-4b 120, musicgen-medium 64, recurrentgemma-9b 256), and 32
HEAD_DIMS = (32, 64, 80, 120, 128, 256)

#: widths of the ``_any`` kernels, which take rows of any length up to the
#: width (the columns past it zeros): a row that is none of HEAD_DIMS runs
#: the smallest of them at or above it (``width``).  bfloat16 and float16
#: rows run ``flash_wgmma_any`` at every multiple of 32, so that a row does
#: its own width of work rounded up to 32 columns; float32 rows run
#: ``flash_tf32_any`` at TF32_ANY_WIDTHS
ANY_WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)
TF32_ANY_WIDTHS = (32, 64, 128, 256)

#: rows wider than this (head dims above 256) run the wide kernels:
#: ``flash_wgmma_wide`` in bfloat16 and float16, ``flash_tf32_wide`` in
#: float32.  Both take a block of WIDE_ROWS q rows and WIDE_GROUP output
#: columns (a column group, ``wide_groups``: two halves of 256, one a
#: warpgroup or a set of 4 warps, so the scores of a key tile are computed
#: once a group), and q.k as a sum over pieces of WIDE_PIECE columns, the
#: two halves of the block taking alternate pieces; key tiles of
#: ``wide_keys`` keys
WIDE_ABOVE = 256
WIDE_PIECE = 64
WIDE_GROUP = 512
WIDE_ROWS = 64

#: bfloat16 and float16 compiled widths that run ``flash_wgmma`` (wgmma +
#: TMA; at 32 rows of 64 bytes in the 64-byte swizzle, 64-key tiles, two
#: blocks an SM and p.v with p as a hi + lo pair, at 64 the softmax
#: overlaps the tensor cores, at 256 the key tiles are 64 rows;
#: every 16-bit width runs it, off these widths as ``flash_wgmma_any``);
#: float32 at every width runs ``flash_tf32`` (mma.sync on TF32 tensor
#: cores, float32 operands split into hi + lo).  ``launch_f32`` and
#: ``launch_16bit`` in the source dispatch the same way.
WGMMA_HEAD_DIMS = (32, 64, 80, 120, 128, 256)

#: bf16 and float16 widths whose kernel takes its softmax maxima over the
#: unscaled scores, so computes only scale > 0 (the wrapper rewrites the
#: others, ``positive_scale``): flash_wgmma and flash_wgmma_any at 32, 64,
#: 96 and above 128, and flash_wgmma_wide at every row above WIDE_ABOVE
#: (``positive_only``)
POSITIVE_SCALE_DIMS = (32, 64, 96, 160, 192, 224, 256)

#: flash_wgmma at width 32 (the source's k32Keys, k32Ring): 128 q rows a
#: block, key tiles of K32_KEYS keys in a ring of K32_RING stages, rows of
#: 64 bytes, two blocks an SM (``smem32_bytes``)
K32_KEYS = 64
K32_RING = 4

#: the widest bf16 and float16 row the narrow loader reads as it is
#: (``narrow_row``); wider rows whose bytes are not a multiple of 16 are
#: padded: beside the 224- and 256-column layouts one staging buffer fits,
#: each refill waits for its copy, and that was slower than the padded copy
NARROW_MOST = 192

#: kernel launches made through this wrapper (CUDA tensors only)
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
        lib.flash_attention_launch.argtypes = [
            i32, i32, i32, vp, vp, vp, vp, i32, i32, i32, i32,
            ctypes.c_float, i32, vp,
        ]
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def narrow_row(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether ``flash_wgmma_any`` takes rows of ``head_dim`` as they are
    though their bytes are not a multiple of 16 (its narrow loader): bf16
    and float16 rows of 33 to NARROW_MOST elements."""
    return dtype != torch.float32 and 32 < head_dim <= NARROW_MOST


def row_elems(dtype: torch.dtype, head_dim: int) -> int:
    """The row the kernel reads at ``head_dim``: ``head_dim`` itself where
    its bytes are a whole number of 16-byte pieces (TMA and the 16-byte
    copies) or the row is narrow (``narrow_row``), else ``head_dim`` padded
    with zero columns."""
    if narrow_row(dtype, head_dim):
        return head_dim
    per = 16 // dtype.itemsize
    return -(-head_dim // per) * per


def width(dtype: torch.dtype, head_dim: int) -> int:
    """The compiled width a call at ``head_dim`` runs: its row
    (``row_elems``) where that is one of HEAD_DIMS, else the smallest of
    ANY_WIDTHS (TF32_ANY_WIDTHS on ``flash_tf32_any``) at or above it; a
    row wider than WIDE_ABOVE is its own width (the wide kernels take
    any)."""
    ld = row_elems(dtype, head_dim)
    if ld in HEAD_DIMS or ld > WIDE_ABOVE:
        return ld
    widths = TF32_ANY_WIDTHS if dtype == torch.float32 else ANY_WIDTHS
    return next(w for w in widths if w >= ld)


def kernel_name(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel a launch at ``dtype`` and ``head_dim`` runs."""
    if row_elems(dtype, head_dim) > WIDE_ABOVE:
        return "flash_tf32_wide" if dtype == torch.float32 else "flash_wgmma_wide"
    return "flash_tf32" if dtype == torch.float32 else "flash_wgmma"


def kernel_label(dtype: torch.dtype, head_dim: int) -> str:
    """The instantiation a launch runs, named as ptxas's report names it
    (``flash_wgmma<bf16, 128>``, ``flash_tf32<f32, 32>``,
    ``flash_wgmma_any<bf16, 128>`` at head dim 96, ``flash_wgmma_wide<bf16>``
    and ``flash_tf32_wide<f32>`` above 256)."""
    name = kernel_name(dtype, head_dim)
    if name.endswith("_wide"):
        return f"{name}<{_SHORT[dtype]}>"
    any_ = "" if row_elems(dtype, head_dim) in HEAD_DIMS else "_any"
    return f"{name}{any_}<{_SHORT[dtype]}, {width(dtype, head_dim)}>"


def positive_only(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the kernel at ``dtype`` and ``head_dim`` takes only scale >
    0 (its softmax takes maxima over the unscaled scores), so the wrapper
    rewrites the scale (``positive_scale``): flash_wgmma at
    POSITIVE_SCALE_DIMS and flash_wgmma_wide."""
    name = kernel_name(dtype, head_dim)
    return name == "flash_wgmma_wide" or (
        name == "flash_wgmma" and width(dtype, head_dim) in POSITIVE_SCALE_DIMS)


def wide_keys(dtype: torch.dtype) -> int:
    """Keys a k/v tile of the wide kernels: 64 on wgmma (m64n64 scores),
    32 in float32."""
    return 32 if dtype == torch.float32 else 64


def wide_groups(dtype: torch.dtype, head_dim: int) -> List[Tuple[int, int]]:
    """``(first column, columns)`` of the output column group of each
    block of the wide kernels (the grid's third dimension) at
    ``head_dim``: the row cut into WIDE_GROUP columns, the last the rest.
    Each block computes the whole row's scores once and p.v for its group,
    its first 256 columns in one half of the block and the rest in the
    other (a half past the row stores nothing)."""
    ld = row_elems(dtype, head_dim)
    return [(c, min(WIDE_GROUP, ld - c)) for c in range(0, ld, WIDE_GROUP)]


def wide_smem_bytes(dtype: torch.dtype) -> int:
    """The dynamic shared memory of a wide block, the same at every head
    dim.  flash_wgmma_wide (the kernel's kGSmem): 1 KB of alignment slack,
    a ring of 4 stages of a q and a k piece (64 x 64, 8 KB each) for each
    warpgroup, v's tile of 64 keys x WIDE_GROUP columns, the 16 KB score
    exchange and 10 mbarriers.  flash_tf32_wide (its XGeo): two stages, each
    both sets' q piece (64 rows) and k piece (32 keys) of WIDE_PIECE columns
    or v's tile of 32 keys x WIDE_GROUP columns (the larger), the lo halves
    of a stage's k pieces or v, and the exchange (two sets of 128 threads x
    16 floats); rows padded so that fragment loads are bank-free (8 floats a
    piece row, 4 a v row)."""
    keys = wide_keys(dtype)
    if dtype == torch.float32:
        piece_row, v_row = WIDE_PIECE + 8, WIDE_GROUP + 4
        stage = max(2 * (WIDE_ROWS + keys) * piece_row, keys * v_row)
        return (2 * stage + keys * v_row + 2 * 128 * 16) * 4
    span = keys * WIDE_PIECE * 2
    return (1024 + 2 * 4 * 2 * span + (WIDE_GROUP // WIDE_PIECE) * span
            + WIDE_ROWS * keys * 4 + 8 * 2 * 5)


def smem32_bytes() -> int:
    """The dynamic shared memory of a flash_wgmma<T, 32> block (its WGeo<32>):
    1 KB of alignment slack, q (128 rows of 64 bytes), the ring of K32_RING
    stages of a k and a v tile (K32_KEYS rows of 64 bytes each), the tile of
    ones p.v's row sums read, the mbarriers (q; k landed, v landed, read a
    stage) and a refill counter a stage."""
    tile = K32_KEYS * 64
    return (1024 + 128 * 64 + 2 * K32_RING * tile + tile + 8 * (1 + 3 * K32_RING)
            + 4 * K32_RING)


def positive_scale(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """``(q', scale')`` with ``scale' > 0`` whose scaled scores ``q' . k *
    scale'`` equal ``q . k * scale`` for every k, for the kernels whose
    softmax takes its maxima over the unscaled scores (``positive_only``):
    a negative scale as ``-q`` and ``|scale|`` (negation is exact in bf16
    and float16), scale 0 as a zero q and scale 1 (every score exactly 0,
    as the reference's ``(q * 0) . k``).  NaN is refused."""
    if math.isnan(scale):
        raise ValueError(f"bfloat16 and float16 at widths {POSITIVE_SCALE_DIMS} and above "
                         f"{WIDE_ABOVE} take a finite scale, got {scale}")
    if scale > 0:
        return q, scale
    if scale < 0:
        return -q, -scale
    return torch.zeros_like(q), 1.0


def _check_cuda(q, k, v, window) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32, bfloat16 or float16, got {q.dtype}")
    if q.shape[-1] < 1:
        raise ValueError(f"head dim must be at least 1, got {q.shape[-1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """Causal, non-causal or sliding-window GQA attention; (B, H, S, D)
    in q's dtype, float32, bfloat16 or float16, any D from 1 up
    (``flash_wgmma_wide``, ``flash_tf32_wide`` above 256).  CUDA tensors
    launch the kernel on the current stream without synchronising (rows
    whose bytes are not a multiple of 16 are padded with zero columns
    first, except bf16 and float16 rows of 33 to 192, ``row_elems``); CPU
    tensors take the plain version.  ``scale`` defaults to ``1 / sqrt(D)``
    of the unpadded D."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise AssertionError(f"GQA needs H({h}) % Hkv({hkv}) == 0")
    bq, bk = min(block_q, s), min(block_k, s)
    if s % bq or s % bk:
        raise AssertionError((s, bq, bk))
    scale = scale if scale is not None else 1.0 / (d**0.5)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, window)
    if positive_only(q.dtype, d):
        q, scale = positive_scale(q, float(scale))
    dev, stream = device_and_stream(q)
    out = _launch(load(), q, k, v, causal=causal, scale=float(scale), window=window,
                  device=dev, stream=stream)
    _count_launch()
    return out


def _launch(lib, q, k, v, *, causal, scale, window, device, stream):
    """Pad rows to ``row_elems`` where needed, allocate the output and
    launch on ``stream``; the output is (B, H, S, D), its padding cut off.
    Narrow rows (``narrow_row``) go as they are, from any element address:
    the kernel copies them by 16-byte-aligned windows."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    ld = row_elems(q.dtype, d)
    qf = q.reshape(b * h, s, d)
    kf = k.reshape(b * hkv, s, d)
    vf = v.reshape(b * hkv, s, d)
    if ld != d:  # zero columns add exact zeros to q.k and are cut from out
        qf, kf, vf = (torch.nn.functional.pad(t, (0, ld - d)) for t in (qf, kf, vf))
    qf, kf, vf = qf.contiguous(), kf.contiguous(), vf.contiguous()
    tma = (ld * q.dtype.itemsize) % 16 == 0
    if tma and (qf.data_ptr() | kf.data_ptr() | vf.data_ptr()) % 16:
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(qf)
    code = lib.flash_attention_launch(
        device, _DTYPES[q.dtype], ld, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        out.data_ptr(), b * h, s, h // hkv, int(causal), scale, window or 0, stream,
    )
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({code})")
    out = out.reshape(b, h, s, ld)
    return out if ld == d else out[..., :d].contiguous()
