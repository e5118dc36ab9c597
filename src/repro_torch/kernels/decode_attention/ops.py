"""Public wrapper: checks, allocation and launch around the CUDA kernel."""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).parent / "csrc" / "decode_attention.cu"

#: the JAX wrapper's cache block; it fixes the ``S % block`` contract only,
#: since the CUDA kernel walks the cache in its own 64-row tiles
DEFAULT_BLOCK_S = 1024

#: head widths the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

#: kernel launches made through this wrapper (CUDA tensors only)
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def load() -> ctypes.CDLL:
    """Build (at first use) and bind the kernel library."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_launch.argtypes = [
            i32, i32, i32, vp, vp, vp, vp, vp, i32, i32, i32, i32,
            ctypes.c_float, vp,
        ]
        lib.decode_attention_launch.restype = i32
        lib.decode_attention_max_group.argtypes = [i32]
        lib.decode_attention_max_group.restype = i32
        lib.decode_attention_error_string.argtypes = [i32]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda(q, k_cache, v_cache, lengths) -> None:
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if k_cache.shape != v_cache.shape or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be ({q.shape[0]},), got {tuple(lengths.shape)}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {HEAD_DIMS}")


def decode_attention(
    q: torch.Tensor,        # (B, H, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) int
    *,
    scale: Optional[float] = None,
    block_s: int = DEFAULT_BLOCK_S,
) -> torch.Tensor:
    """One query token per sequence over its first ``lengths[b]`` cache
    rows; (B, H, D) in q's dtype.  CUDA tensors launch the kernel on the
    current stream without synchronising, with ``lengths`` broadcast to
    every q head as the Pallas wrapper does and a float32 output cast to
    q's dtype; CPU tensors take the plain version."""
    global LAUNCHES
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
    group = h // hkv
    if group > lib.decode_attention_max_group(d):
        raise ValueError(f"{group} q heads per kv head exceed the kernel's "
                         f"{lib.decode_attention_max_group(d)} at head dim {d}")
    qf = q.contiguous()
    kf, vf = k_cache.contiguous(), v_cache.contiguous()
    # (B*H,): one per q head, as the Pallas wrapper passes them
    lens = lengths.to(torch.int32)[:, None].expand(b, h).contiguous().view(b * h)
    if any(t.data_ptr() % 16 for t in (qf, kf, vf)):
        raise ValueError("q and the caches must start on a 16-byte boundary")
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    dev = q.device
    code = lib.decode_attention_launch(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPES[q.dtype], d, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(),
        lens.data_ptr(), out.data_ptr(), b, hkv, group, s, float(scale),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if code != 0:
        msg = lib.decode_attention_error_string(code).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} ({code})")
    LAUNCHES += 1
    return out.to(q.dtype)
