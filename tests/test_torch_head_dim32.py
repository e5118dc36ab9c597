"""bfloat16 and float16 flash at head dims up to 32, checked on the CPU.

``flash_wgmma<T, 32>`` (rows of 32) and ``flash_wgmma_any<T, 32>`` (rows
of 1 to 31, padded by the wrapper to whole 16-byte pieces) run only on the
card; ``chip_smoke.py`` phase 5 holds them to their plain version there.
Here an emulation of the kernel's arithmetic is held to the JAX package's
Pallas kernel in interpret mode, under phase 5's rule for them (one 16-bit
ulp + 1e-5, ``chip_smoke.close_enough``):

* q.k of q and k as they are (exact products, float32 sums), the scale
  applied to the float32 scores after;
* q tiles of 128 rows in two warpgroups of 64, key tiles of
  ``ops.K32_KEYS`` keys over the q tile's [lo, hi), keys outside the masks
  -inf, the online softmax with its maxima over the unscaled scores and the
  lazy maximum (it moves only past 2^8), each exponent one FMA (bf16) or
  (s - m) * scale_log2 + 7 (float16: p and l carry 2^7);
* p.v with p as a pair hi + lo = round(p - hi) in q's dtype, hi = p
  truncated to bf16 (its bits' top half) or rounded to float16, and l the
  sum of the same pair (the kernel's p.v against v and a tile of ones),
  float32 sums, o and l rescaled when a row's maximum moves;

at head dims 32, 16, 8, 1 and 31, groups of 1, 8 and 48 q heads a kv head,
causal, non-causal, windows of 64 and 256 and a ragged S, and the scales
the wrapper rewrites.  A negative control (p rounded once to q's dtype)
misses the rule; the pair keeps p to 2^-16 (bf16) and 2^-21 (float16) of
itself; the source's constants are the wrapper's mirrors, the geometry fits
two blocks an SM, and every short 16-bit row dispatches to the kernel.
"""
import re
import zlib
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from _flash_emulation import emulate32, split

torch.set_num_threads(1)  # small tensors: extra threads only contend

FLASH_CU = flash_ops.SOURCE.read_text()
#: shared memory a block may use on the H100 (232,448 of the SM's 256 KB)
SMEM_LIMIT = 232_448
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
DIMS = (32, 16, 8, 1, 31)
#: q heads a kv head: MHA (2/2), 8/1 and 48/1
GROUPS = (1, 8, 48)
#: (S, causal, window): four 64-key tiles, causal and not; windows of 64
#: and 256 (at S = 384, two q tiles); a ragged last tile, with a window of
#: 64 and without a mask
MASKS = ((256, True, None), (256, False, None), (256, True, 64), (384, True, 256),
         (200, True, 64), (200, False, None))


def cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FLASH_CU).group(1))


def heads(group):
    return (2, 2) if group == 1 else (group, 1)


@lru_cache(maxsize=None)
def case(name, d, group, s, causal, window, scale=None):
    """Seeded q, k, v (B = 1) in q's dtype and the Pallas kernel's output
    in interpret mode (one q and one k block of S)."""
    h, hkv = heads(group)
    rng = np.random.default_rng(zlib.crc32(repr((name, d, group, s, causal, window)).encode()))
    q, k, v = (rng.standard_normal((1, n, s, d)).astype(np.float32) for n in (h, hkv, hkv))
    tdt, jdt = DTYPES[name]
    want = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                     causal=causal, window=window, scale=scale, block_q=s, block_k=s,
                     interpret=True)
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))).to(tdt)
    return (*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), want)


def within_rule(got, want) -> bool:
    """Phase 5's rule for these kernels (``chip_smoke.close_enough``): one
    16-bit ulp of the larger magnitude + 1e-5."""
    return chip_smoke.close_enough(torch, got, want)


# ----------------------------------------------- the emulation vs Pallas
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("s,causal,window", MASKS)
def test_the_kernel_meets_the_one_ulp_rule(name, d, group, s, causal, window):
    q, k, v, want = case(name, d, group, s, causal, window)
    got = emulate32(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == want.shape
    assert within_rule(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("scale", (-0.177, 0.0))
def test_scales_the_wrapper_rewrites(name, scale):
    """A negative scale runs as -q with |scale|, scale 0 as a zero q with
    scale 1 (every p exactly 1 on the MUFU and the FMA pipes alike)."""
    q, k, v, want = case(name, 32, 8, 256, True, None, scale)
    got = emulate32(q, k, v, causal=True, window=None, scale=scale)
    assert within_rule(got, want), float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", DIMS)
def test_the_port_on_the_cpu_matches_pallas(name, d):
    """The wrapper on CPU tensors (the plain version) against the Pallas
    kernel at every head dim here, GQA 8/1, causal with a window of 64."""
    q, k, v, want = case(name, d, 8, 256, True, 64)
    got = flash_attention(q, k, v, causal=True, window=64)
    assert got.dtype == q.dtype and within_rule(got, want)


@pytest.mark.parametrize("name", list(DTYPES))
def test_p_rounded_once_misses_the_rule(name):
    """The negative control: p rounded once to q's dtype before p.v (one
    product, not the hi + lo pair) misses the rule at 8/1 x 32, S = 256,
    non-causal (each row's p spread over 256 keys), where the pair meets
    it; so phase 5 cannot pass a kernel that rounds p once."""
    q, k, v, want = case(name, 32, 8, 256, False, None)
    assert within_rule(emulate32(q, k, v, causal=False, window=None), want)
    assert not within_rule(emulate32(q, k, v, causal=False, window=None, split_p=False), want)


def test_phase_5_holds_these_rows_to_the_one_ulp_rule():
    """chip_smoke.p_rounded, which picks the looser 16-bit flash rule, is
    False for every bf16 and float16 row of 1 to 32 (and above 256) and
    True for 33 to 256, while the source feeds p.v the pair hi + lo at 32
    and rounds p once (pack_p) on flash_wgmma's other widths."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in range(1, 33):
            assert not chip_smoke.p_rounded(dtype, d)
        assert chip_smoke.p_rounded(dtype, 33) and chip_smoke.p_rounded(dtype, 256)
        assert not chip_smoke.p_rounded(dtype, 257)
    assert not any(chip_smoke.p_rounded(torch.float32, d) for d in (8, 32, 64, 256, 300))
    consume32 = re.search(r"__device__ __forceinline__ void consume32\(.*?\n}\n", FLASH_CU,
                          re.S).group(0)
    assert "wgmma_rs<Elt>(o, ph[4 * kk]" in consume32 and "wgmma_rs<Elt>(o, pl[4 * kk]" in consume32
    assert "pack_p" not in consume32 and "pack_p<Elt>(" in FLASH_CU


# ------------------------------------------------------------- the pair
@pytest.mark.parametrize("name,bits,floor", [("bfloat16", 16, 0.0), ("float16", 21, 2.0 ** -25)])
def test_the_pair_keeps_p(name, bits, floor):
    """hi + lo recovers p to 2^-16 of itself in bf16 (hi truncated: lo
    below one bf16 ulp of p, rounded to 8 bits), and in float16 to 2^-21
    of itself plus half of float16's least subnormal (hi rounded; the
    kernel's 2^7 keeps the row's largest p at 2^7 or more, so that floor is
    below 2^-32 of l), over p from 2^-40 to 2^15; hi alone is 2^-8 and
    2^-11 off."""
    dtype = DTYPES[name][0]
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp2(rng.uniform(-40, 15, 100_000)).astype(np.float32))
    hi, lo = split(p, dtype)
    assert bool(((hi + lo - p).abs() <= 2.0 ** -bits * p + floor).all())
    assert float(((hi - p).abs() / p).max()) > 2.0 ** -(bits - 6)


# ------------------------------------------------ the geometry and routes
def test_the_constants_are_the_sources():
    assert (cu_int("k32Cols"), cu_int("k32Keys"), cu_int("k32Ring")) == \
        (32, flash_ops.K32_KEYS, flash_ops.K32_RING)
    assert "constexpr int k32RowBytes = k32Cols * 2;" in FLASH_CU
    # float16's 2^7, added in the exponent's FMA
    assert "constexpr int kShift = kIsHalf<Elt> ? 7 : 0;" in FLASH_CU
    assert "online_softmax_fma<KB, true, kIsHalf<Elt>, kShift, false>(" in FLASH_CU
    # l from the pair's products with the ones, whole in each thread
    assert "store_rows<Elt, k32Cols / 2 + 4, false>(o, o[16], o[18]" in FLASH_CU


#: shared memory of an SM, which its blocks share (228 KB)
SM_SMEM = 233_472


def test_the_geometry_fits_two_blocks_an_sm():
    """WGeo<32> as ``ops.smem32_bytes`` mirrors it: q 128 rows of 64 bytes,
    k and v tiles of K32_KEYS rows of 64 bytes in a ring of K32_RING
    stages, a tile of ones, the barriers and the refill counters, 1 KB
    slack: two blocks within an SM's shared memory (and 128 registers a
    thread: __launch_bounds__(256, 2)); TMA boxes of 32 columns (64 bytes,
    the 64-byte swizzle's span) and K32_KEYS rows; every tile 1 KB aligned,
    so the swizzle's 512-byte pattern starts with it."""
    keys, ring, row = flash_ops.K32_KEYS, flash_ops.K32_RING, 64
    qtile, tile = 128 * row, keys * row
    smem = flash_ops.smem32_bytes()
    assert smem == 1024 + qtile + 2 * ring * tile + tile + 8 * (1 + 3 * ring) + 4 * ring
    assert smem == 46_200 and 2 * smem <= SM_SMEM and keys <= 256
    assert qtile % 1024 == 0 and tile % 1024 == 0
    for line in ("static constexpr int span = keys * (r64 ? k32RowBytes : kHalf * 2);",
                 "static constexpr int qtile = r64 ? kWBQ * k32RowBytes : boxes * kHalfBytes;",
                 "static constexpr int ones = r64 ? tile : 0;",
                 "1024 + qtile + 2 * ring * tile + ones + 8 * (1 + 3 * ring) + "
                 "(self_load ? 4 * ring : 0);",
                 "static constexpr bool self_load = r64 || D > kWCols || D == 96;",
                 "static constexpr int blocks = r64 ? 2 : 1;",
                 "static_assert(k32Keys == 64,",
                 "__launch_bounds__(WGeo<D>::threads, WGeo<D>::blocks)",
                 "static constexpr bool narrow = !r64 && nx >= 2;",
                 "constexpr int box = WGeo<D>::r64 ? k32Cols : kHalf;",
                 "WGeo<D>::r64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;"):
        assert line in FLASH_CU, line
    # the descriptors: 64-byte swizzle (layout type 2), 8-row groups 512 B;
    # v's 32 columns, then 8 of the ones tile LBO past them
    assert "(2ull << 62)" in FLASH_CU
    assert "sw64_desc(tK + kk * 32, 16, 512)" in FLASH_CU
    assert "sw64_desc(tV + kk * 16 * k32RowBytes, sOnes - tV, 512)" in FLASH_CU
    assert "const uint32_t sOnes = sV + R * T;" in FLASH_CU
    assert "const uint32_t bar_q = sV + R * T + WGeo<D>::ones;" in FLASH_CU
    # p.v: m64n40k16 twice a k-step (hi and lo): o's 32 columns and l's 8
    assert "wgmma.mma_async.sync.aligned.m64n40k16" in FLASH_CU
    # registers a thread holds in a tile: the scores, p's pair and o with
    # l, within the 128 of two blocks an SM
    assert keys // 2 + 2 * (keys // 4) + 32 // 2 + 4 == 84 < 128


def test_the_dispatch_sends_every_short_16bit_row_to_wgmma():
    """launch_16bit: a row of 32 to flash_wgmma<T, 32>, a shorter one
    (padded by the wrapper to a multiple of 8) to flash_wgmma_any<T, 32>;
    nothing 16-bit reaches flash_tf32, whose source keeps no 16-bit code;
    the wrapper rewrites scales <= 0 at these widths."""
    body = re.search(r"cudaError_t launch_16bit\(.*?\n}\n", FLASH_CU, re.S).group(0)
    assert "ld == 32  ? launch_wgmma<T, 32, false>" in body
    assert "ld < 32   ? launch_wgmma<T, 32, true>" in body
    assert "launch_tf32" not in body
    tf32 = FLASH_CU.split("// ------------------------------------- flash_tf32")[1]
    tf32 = tf32.split("// ------------------------------ flash_tf32_wide")[0]
    assert "__nv_bfloat16" not in tf32 and "__half" not in tf32 and "kOne" not in tf32
    for dtype in (torch.bfloat16, torch.float16):
        for d in range(1, 33):
            row = flash_ops.row_elems(dtype, d)
            assert row == -(-d // 8) * 8 and flash_ops.width(dtype, d) == 32
            label = flash_ops.kernel_label(dtype, d)
            short = flash_ops._SHORT[dtype]
            assert label == (f"flash_wgmma<{short}, 32>" if row == 32
                             else f"flash_wgmma_any<{short}, 32>")
            assert flash_ops.positive_only(dtype, d)
    assert 32 in flash_ops.POSITIVE_SCALE_DIMS and 32 in flash_ops.WGMMA_HEAD_DIMS
    assert flash_ops.TF32_ANY_WIDTHS == (32, 64, 128, 256)
    assert flash_ops.width(torch.float32, 8) == 32
    assert flash_ops.kernel_label(torch.float32, 8) == "flash_tf32_any<f32, 32>"
