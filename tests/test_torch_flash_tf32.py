"""``flash_tf32``, the float32 flash kernel on the TF32 tensor cores,
checked on the CPU (bf16 and float16 at head dim 32 run ``flash_wgmma``:
``tests/test_torch_head_dim32.py``).

The kernel itself runs only on the card (``chip_smoke.py`` phase 5 holds
it to its plain version there).  Here an emulation of its arithmetic is
held to the JAX package's Pallas kernel in interpret mode:

* every float32 operand x (q * scale, k, p, v) split as hi = tf32(x) and
  lo = tf32(x - hi), tf32 being ``cvt.rna.tf32.f32``: add 0x1000 to the
  bits and clear the low 13;
* each product as three float32 matmuls of the rounded operands, lo.hi +
  hi.lo + hi.hi;
* the online softmax in float32 over the kernel's key tiles, each warp of
  16 q rows walking the tiles its rows see, as ``flash_attention.cu`` does.

It must meet phase 5's rule (1e-5 + 1e-5 |ref|) at every head dim,
causal, non-causal and windowed, with GQA
4/2, and a negative control (one TF32 product a pair) must miss the
float32 rule at every head dim, so the test tells the two apart.  The
kernel's geometry (shared memory, bank-free fragment loads, 16-byte rows)
is checked against the constants of the source.
"""
import re
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops as flash_ops
from _flash_emulation import emulate32

torch.set_num_threads(1)  # small tensors: extra threads only contend

FLASH_CU = flash_ops.SOURCE.read_text()
#: shared memory a block may use on the H100 (232,448 of the SM's 256 KB)
SMEM_LIMIT = 232_448
#: (causal, window) of the cases: causal, non-causal, a window that masks
#: inside the key tiles
MASKS = ((True, None), (False, None), (True, 48))
S = 192


def cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FLASH_CU).group(1))


def geometry(d: int) -> dict:
    """TGeo<float, D> of flash_attention.cu."""
    wide = d > 128
    warps = cu_int("kTWideWarps") if wide else cu_int("kTWarps")
    rows = cu_int("kTRows") * warps
    keys = cu_int("kTWideKeys") if wide else cu_int("kTKeys")
    qs = (d + 15) // 16 * 16 + 8
    ks, vs = qs, d + 4
    smem = rows * qs * 4 + cu_int("kTStages") * keys * (ks + vs) * 4
    return dict(warps=warps, rows=rows, keys=keys, qs=qs, ks=ks, vs=vs, smem=smem)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest,
    ties away from zero): add half of the dropped 13 bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a @ b as the kernel's TF32 products, float32 sums: three (lo.hi +
    hi.lo + hi.hi), or one (the negative control)."""
    if products == 1:
        return tf32(a) @ tf32(b)
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def emulate(q, k, v, *, causal, window, products=3):
    """flash_tf32's arithmetic on the CPU: (B, H, S, D) float32 in and out."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    geo = geometry(d)
    bq, bk = geo["rows"], geo["keys"]
    scale = 1.0 / d ** 0.5
    qs = (q.to(torch.float32) * scale).reshape(b * h, s, d)
    kf = k.to(torch.float32).repeat_interleave(group, dim=1).reshape(b * h, s, d)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1).reshape(b * h, s, d)
    out = torch.empty(b * h, s, d, dtype=torch.float32)
    n_tiles = -(-s // bk)
    for q0 in range(0, s, bq):
        hi = min((q0 + bq - 1) // bk + 1, n_tiles) if causal else n_tiles
        lo = max(int((q0 - window + 1) / bk), 0) if window else 0
        for r0 in range(q0, min(q0 + bq, s), 16):
            whi = min((r0 + 15) // bk + 1, hi) if causal else hi
            wlo = max(int((r0 - window + 1) / bk), lo) if window else lo
            rows = torch.arange(r0, r0 + 16)
            qw = torch.zeros(b * h, 16, d)
            qw[:, : min(16, s - r0)] = qs[:, r0:r0 + 16]
            m = torch.full((b * h, 16, 1), -1e30)
            l = torch.zeros((b * h, 16, 1))
            o = torch.zeros((b * h, 16, d))
            for j in range(wlo, whi):
                cols = torch.arange(j * bk, (j + 1) * bk)
                kt = torch.zeros(b * h, bk, d)
                vt = torch.zeros(b * h, bk, d)
                valid = min(bk, s - j * bk)
                kt[:, :valid] = kf[:, j * bk:j * bk + valid]
                vt[:, :valid] = vf[:, j * bk:j * bk + valid]
                sc = product(qw, kt.transpose(1, 2), products)
                keep = torch.ones(16, bk, dtype=torch.bool)
                if causal:
                    keep &= cols[None, :] <= rows[:, None]
                if window:
                    keep &= cols[None, :] > rows[:, None] - window
                sc = torch.where(keep, sc, torch.tensor(-1e30))
                sc = torch.where(cols[None, :] >= s, torch.tensor(-torch.inf), sc)
                mx = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                corr = torch.exp(m - mx)
                p = torch.exp(sc - mx)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                o = o * corr + product(p, vt, products)
                m = mx
            n = min(16, s - r0)
            out[:, r0:r0 + n] = (o / l.clamp_min(1e-30))[:, :n]
    return out.reshape(b, h, s, d).to(q.dtype)


@lru_cache(maxsize=None)
def case(d: int, causal: bool, window, dtype_name: str, s: int = S):
    """Seeded q, k, v (B = 1, GQA 4/2) and the Pallas kernel's output in
    interpret mode, set up as the JAX package's tests set it up."""
    rng = np.random.default_rng(1000 + d)
    q = rng.standard_normal((1, 4, s, d)).astype(np.float32)
    k = rng.standard_normal((1, 2, s, d)).astype(np.float32)
    v = rng.standard_normal((1, 2, s, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype_name)
    block = 64 if s % 64 == 0 else s
    ref = jax_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                    causal=causal, window=window, block_q=block, block_k=block,
                    interpret=True)
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32))).to(tdt)
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), ref)


def within_rule(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Phase 5's rule (``chip_smoke.close_enough``): float32 within 1e-5 +
    1e-5 |want|; bf16 within one bf16 ulp of the larger magnitude + 1e-5."""
    return chip_smoke.close_enough(torch, got, want)


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_three_tf32_products_meet_the_float32_rule(d, causal, window):
    q, k, v, ref = case(d, causal, window, "float32")
    got = emulate(q, k, v, causal=causal, window=window)
    err = float((got - ref).abs().max())
    assert within_rule(got, ref), (d, causal, window, err)
    assert err < 5e-6


@pytest.mark.parametrize("d", (120, 256))
def test_ragged_end_meets_the_float32_rule(d):
    """S = 200: the last key tile holds keys past S (-inf), with a window
    of 64 that masks inside both q tiles' key ranges."""
    q, k, v, ref = case(d, True, 64, "float32", 200)
    got = emulate(q, k, v, causal=True, window=64)
    assert within_rule(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("causal,window", MASKS)
def test_bf16_at_32_meets_the_one_ulp_rule(causal, window):
    """bf16 at head dim 32 runs flash_wgmma<bf16, 32>: exact
    q.k products with float32 sums, p.v with p as a bf16 hi + lo pair,
    the output rounded once to bf16 (that kernel's emulation,
    ``_flash_emulation.emulate32``)."""
    q, k, v, ref = case(32, causal, window, "bfloat16")
    assert flash_ops.kernel_label(torch.bfloat16, 32) == "flash_wgmma<bf16, 32>"
    got = emulate32(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert within_rule(got, ref), float((got.float() - ref.float()).abs().max())


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_one_tf32_product_misses_the_float32_rule(d):
    """The negative control: one TF32 product a pair (operands rounded to
    10 mantissa bits) misses 1e-5 + 1e-5 |ref| at every head dim, by far."""
    q, k, v, ref = case(d, True, None, "float32")
    got = emulate(q, k, v, causal=True, window=None, products=1)
    assert not within_rule(got, ref)
    assert float((got - ref).abs().max()) > 1e-4


def test_tf32_rounds_to_nearest_ties_away():
    """The emulation's tf32 is cvt.rna's: 10 mantissa bits, to nearest,
    ties away from zero; hi + lo recovers x to 2^-22 of it."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0]
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(y)
    assert bool(((tf32(hi) == hi) & (tf32(lo) == lo)).all())
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("d", flash_ops.HEAD_DIMS)
def test_flash_tf32_geometry(d):
    """TGeo<float, D>: the block's shared memory fits, every row is a whole
    number of 16-byte cp.async copies, and a warp's fragment loads hit 32
    distinct banks: q and k as 8-byte pairs at (row g, word 2t) by
    half-warps, v as words at (row 2t, column g)."""
    geo = geometry(d)
    assert geo["smem"] <= SMEM_LIMIT
    assert (geo["rows"], geo["keys"]) == ((64, 32) if d == 256 else (128, 64))
    assert (geo["qs"] * 4) % 16 == 0 and (d * 4) % 16 == 0
    assert (geo["ks"] * 4) % 16 == 0 and (geo["vs"] * 4) % 16 == 0
    assert d % 8 == 0 and d <= geo["qs"] and d <= geo["ks"] and d <= geo["vs"]
    # q and k: a half-warp (g 0..3 or 4..7, t 0..3) reads two words each
    for stride in (geo["qs"], geo["ks"]):
        half = [{(g * stride + 2 * t + w) % 32 for g in gs for t in range(4) for w in (0, 1)}
                for gs in (range(4), range(4, 8))]
        assert all(len(banks) == 32 for banks in half)
    for e in (0, 1):  # b0 (key 2t) and b1 (key 2t + 1)
        banks = {((2 * t + e) * geo["vs"] + g) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32
    assert f"launch_tf32<T, {d}, false>" in FLASH_CU
    assert flash_ops.kernel_name(torch.float32, d) == "flash_tf32"


def test_flash_tf32_dispatch_and_launch_bounds():
    """flash_tf32 runs float32 at every head dim and nothing else (bf16 and
    float16 at 32 run flash_wgmma); two blocks an SM (128
    registers a thread) up to D = 64, one above; 8 warps below D = 256 and
    4 at 256; three mma.sync products a float32 pair."""
    assert flash_ops.kernel_name(torch.bfloat16, 32) == "flash_wgmma"
    assert flash_ops.kernel_name(torch.float32, 32) == "flash_tf32"
    launch_16bit = FLASH_CU.split("cudaError_t launch_16bit")[1].split("\n}\n")[0]
    assert "? launch_wgmma<T, 32, false>" in launch_16bit and "launch_tf32" not in launch_16bit
    assert "static constexpr int min_blocks = D <= 64 ? 2 : 1;" in FLASH_CU
    assert "__launch_bounds__(TGeo<T, D>::threads, TGeo<T, D>::min_blocks)" in FLASH_CU
    assert (cu_int("kTWarps"), cu_int("kTWideWarps"), cu_int("kTStages")) == (8, 4, 2)
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in FLASH_CU
    assert 'asm("cvt.rna.tf32.f32 %0, %1;"' in FLASH_CU
    body = re.search(r"__device__ __forceinline__ void mma3\(.*?\n}\n", FLASH_CU, re.S).group(0)
    assert body.count("mma_tf32(") == 3  # lo.hi, hi.lo, hi.hi


@pytest.mark.parametrize("mangled,name", [
    ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea710flash_tf32IfLi128EEEvPKT_S3_S3_"
     "PS1_iiifi", "flash_tf32<f32, 128>"),
    ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea710flash_tf32I13__nv_bfloat16Li32EEE"
     "vPKT_S4_S4_PS2_iiifi", "flash_tf32<bf16, 32>"),
    ("_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea711flash_wgmmaILi256EEEv14CUtensorMap"
     "_stS1_S1_P13__nv_bfloat16iiifi", "flash_wgmma<256>"),
])
def test_kernel_label_reads_names_that_end_in_digits(mangled, name):
    """phase 1's ptxas report and phase 7's rows name flash_tf32's
    instances (a name ending in digits, after a namespace hash that may end
    in digits too)."""
    assert chip_smoke.kernel_label(mangled) == name
