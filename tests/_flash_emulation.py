"""The arithmetic of ``flash_wgmma<T, 32>`` and ``flash_wgmma_any<T, 32>``
(bf16 and float16 flash at head dims up to 32) emulated on the CPU in
torch, for the tests that hold it to the JAX package's Pallas kernel
(``tests/test_torch_head_dim32.py``, ``tests/test_torch_flash_tf32.py``).
"""
import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

LOG2E = np.float32(1.4426950408889634)


def fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def split(p: torch.Tensor, dtype) -> tuple:
    """p (float32) as the kernel's pair (hi, lo) in ``dtype``, as float32:
    hi truncated to bf16 (the top half of p's bits) or rounded to float16,
    lo = p - hi (exact in float32) rounded to ``dtype``."""
    if dtype == torch.float16:
        hi = p.to(dtype).to(torch.float32)
    else:
        hi = (p.view(torch.int32) & -0x10000).view(torch.float32)
    return hi, (p - hi).to(dtype).to(torch.float32)


def emulate32(q, k, v, *, causal, window, scale=None, split_p=True):
    """flash_wgmma<T, 32>'s plan and arithmetic on the CPU: (B, H, S, D) in,
    q's dtype out.  ``split_p=False``: p rounded once to q's dtype (the
    negative control)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    ld = flash_ops.row_elems(q.dtype, d)
    assert flash_ops.width(q.dtype, d) == 32 and ld <= 32
    kb = flash_ops.K32_KEYS
    half = q.dtype == torch.float16
    scale = 1.0 / d ** 0.5 if scale is None else scale
    qf = q.to(torch.float32)
    if scale <= 0:  # the wrapper's rewrite (ops.positive_scale)
        qf, scale = (-qf, -scale) if scale < 0 else (torch.zeros_like(qf), 1.0)
    c = torch.tensor(np.float32(scale) * LOG2E)

    def pad(x):  # columns past the row: TMA's zero fill
        return torch.nn.functional.pad(x, (0, 32 - d)).reshape(-1, x.shape[2], 32)

    qs = pad(qf)
    kf = pad(k.to(torch.float32).repeat_interleave(group, dim=1))
    vf = pad(v.to(torch.float32).repeat_interleave(group, dim=1))
    bh = b * h
    out = torch.zeros(bh, s, 32)
    n_kt = -(-s // kb)
    for q0 in range(0, s, 128):
        hi = min((q0 + 127) // kb + 1, n_kt) if causal else n_kt
        lo = max(int((q0 - window + 1) / kb), 0) if window else 0
        for wrow in (q0, q0 + 64):  # the two consumer warpgroups
            rows = torch.arange(wrow, wrow + 64)
            qw = torch.zeros(bh, 64, 32)
            qw[:, :max(0, min(64, s - wrow))] = qs[:, wrow:wrow + 64]
            m = torch.full((bh, 64, 1), -1e30)
            l = torch.zeros(bh, 64, 1)
            o = torch.zeros(bh, 64, 32)
            for j in range(lo, hi):
                cols = torch.arange(j * kb, (j + 1) * kb)
                kt = torch.zeros(bh, kb, 32)
                vt = torch.zeros(bh, kb, 32)
                valid = min(kb, s - j * kb)
                kt[:, :valid] = kf[:, j * kb:j * kb + valid]
                vt[:, :valid] = vf[:, j * kb:j * kb + valid]
                sc = qw @ kt.transpose(1, 2)
                keep = (cols[None, :] < s).expand(64, kb)
                if causal:
                    keep = keep & (cols[None, :] <= rows[:, None])
                if window:
                    keep = keep & (cols[None, :] > rows[:, None] - window)
                sc = torch.where(keep, sc, torch.tensor(-torch.inf))
                mn = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                mn = torch.where((mn - m) * c <= 8.0, m, mn)  # the lazy maximum
                corr = torch.exp2((m - mn) * c)
                if half:  # p and l scaled by 2^7: 7 added in the exponent's FMA
                    x = fma(sc - mn, c.expand_as(sc), torch.tensor(7.0))
                else:
                    x = fma(sc, c.expand_as(sc), -mn * c)
                p = torch.exp2(x)
                pair = split(p, q.dtype) if split_p else (p.to(q.dtype).to(torch.float32),)
                # [o | l] = [o | l] * corr + pair . [v | ones]
                o = o * corr + sum(part @ vt for part in pair)
                l = l * corr + sum(part.sum(dim=-1, keepdim=True) for part in pair)
                m = mn
            n = max(0, min(64, s - wrow))
            out[:, wrow:wrow + n] = (o / l.clamp_min(1e-30))[:, :n]
    return out[..., :d].reshape(b, h, s, d).to(q.dtype)
