"""Head dims 80 (qwen3-32b), 120 (h2o-danube-3-4b) and 256
(recurrentgemma-9b) through the port's attention kernels, checked on the
CPU.

* Every ported config's head dim passes both wrappers' device checks.
* The plain flash and decode versions (what the wrappers take on CPU
  tensors) against the Pallas kernels in interpret mode at D = 80, 120
  and 256: float32 to rtol=atol=1e-5 (float32 sums in another order),
  bfloat16 within one bf16 ulp (both round once from float32).
* bf16 at D = 64 takes every finite scale: the wrapper's rewrite
  (``positive_scale``) gives the plain version's result at the original
  scale.
* The decode kernel's padded width: zero columns past D in q, k and v
  change no output column (``padded_decode`` below mirrors it in torch),
  and the shared-memory geometry of ``decode_attention.cu`` (mirrored by
  ``geometry``) keeps every k chunk inside its row and the mma loads off
  shared bank conflicts; its shared memory (mirrored by
  ``decode_smem_bytes``) fits the block at every head dim, dtype and group.
* flash_wgmma's geometry at D = 64, 80-128 and 256, from the constants of
  ``flash_attention.cu``.
* ``LM`` with ``use_flash_kernel=True`` at head dims 120, 80 and 256 against
  the JAX package, params carried across by ``params_from_numpy``, at
  the 1e-4 of tests/test_torch_models.py in float32.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import LM as JaxLM
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import params_from_numpy

torch.set_num_threads(1)  # small tensors: extra threads only contend

F32 = dict(rtol=1e-5, atol=1e-5)
NEW_DIMS = (80, 120)
#: the head dims held to Pallas here: qwen3-32b's, danube's, recurrentgemma's
PARITY_DIMS = NEW_DIMS + (256,)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_within_bf16_ulp(got, want):
    got, want = as_f32(got), as_f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def to_torch(x, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 else t


def to_jax(x, bf16=False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------- wrapper checks
#: the ported configs whose blocks call the attention kernels (an MLA or
#: xLSTM block calls none: deepseek's d_model / heads = 56 is no kernel's
#: head dim, and xlstm has no attention)
KERNEL_ARCHS = tuple(a for a in PORTED if {k for unit, _ in get_config(a).segments for k in unit}
                     & {"attn", "attn_geglu", "moe_attn"})


def test_the_kernel_configs_are_the_attention_ones():
    assert set(PORTED) - set(KERNEL_ARCHS) == {"xlstm_350m", "deepseek_v3_671b"}
    assert get_config("deepseek_v3_671b").head_dim == 56
    assert 56 not in flash_ops.HEAD_DIMS and 56 not in decode_ops.HEAD_DIMS


@pytest.mark.parametrize("arch", KERNEL_ARCHS)
def test_every_ported_config_head_dim_passes_both_wrappers(arch):
    cfg = get_config(arch)
    d, h, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    assert d in flash_ops.HEAD_DIMS and d in decode_ops.HEAD_DIMS
    q = torch.zeros((1, h, 4, d), dtype=torch.bfloat16)
    k = torch.zeros((1, hkv, 4, d), dtype=torch.bfloat16)
    flash_ops._check_cuda(q, k, k, cfg.window)
    decode_ops._check_cuda(q[:, :, 0], k, k, torch.ones((1,), dtype=torch.int32))


def test_the_new_head_dims_are_those_of_qwen3_and_danube():
    assert get_config("qwen3-32b").head_dim == 80
    assert get_config("h2o-danube-3-4b").head_dim == 120
    assert set(NEW_DIMS) <= set(flash_ops.HEAD_DIMS) == set(decode_ops.HEAD_DIMS)


@pytest.mark.parametrize("d", [96, 112])
def test_a_head_dim_no_config_needs_is_refused(d):
    """Head dims 96 and 112 (no compiled width) are in the kernels' domain
    now: both wrappers take them, on the ``_any`` kernels: decode's of width
    128, bf16 flash's at the row rounded up to a multiple of 32 (96 and
    128).  So is d + 256, on the wide kernels (q.k across D in pieces); a
    head dim of 0 is the one refused."""
    q = torch.zeros((1, 2, 4, d))
    flash_ops._check_cuda(q, q, q, None)
    decode_ops._check_cuda(q[:, :, 0], q, q, torch.ones((1,), dtype=torch.int32))
    assert decode_ops.width(d) == 128
    assert flash_ops.width(torch.bfloat16, d) == -(-d // 32) * 32
    wide = torch.zeros((1, 2, 4, d + 256))
    flash_ops._check_cuda(wide, wide, wide, None)
    decode_ops._check_cuda(wide[:, :, 0], wide, wide, torch.ones((1,), dtype=torch.int32))
    assert flash_ops.kernel_label(torch.float32, d + 256) == "flash_tf32_wide<f32>"
    assert decode_ops.decode_kernel(torch.float32, 1, d + 256) == "decode_wide<f32>"
    empty = torch.zeros((1, 2, 4, 0))
    with pytest.raises(ValueError, match="head dim"):
        flash_ops._check_cuda(empty, empty, empty, None)
    with pytest.raises(ValueError, match="head dim"):
        decode_ops._check_cuda(empty[:, :, 0], empty, empty, torch.ones((1,), dtype=torch.int32))


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan")])
def test_a_non_positive_scale_is_refused_at_bf16_64(scale, rng):
    """flash_wgmma<64> takes its softmax maxima over the unscaled scores,
    so its launcher refuses a scale <= 0; the wrapper launches it with
    ``positive_scale``'s (q', scale'), a positive scale whose scaled
    scores are those of the original.  A negative scale and scale 0 are
    so computed: through the plain version the rewrite gives exactly the
    plain version at the original scale, causal, windowed and not.  Only
    NaN is refused."""
    assert "if (!(scale > 0.0f)) return cudaErrorInvalidValue;" in FLASH_CU
    assert "q, scale = positive_scale(q, float(scale))" in Path(flash_ops.__file__).read_text()
    q = to_torch(normal(rng, 1, 4, 128, 64), True)
    k, v = to_torch(normal(rng, 1, 2, 128, 64), True), to_torch(normal(rng, 1, 2, 128, 64), True)
    if scale != scale:  # NaN
        with pytest.raises(ValueError, match="finite scale"):
            flash_ops.positive_scale(q, scale)
        return
    q2, scale2 = flash_ops.positive_scale(q, scale)
    assert scale2 > 0 and q2.dtype == q.dtype and q2.shape == q.shape
    for causal, window in ((True, None), (False, None), (True, 48)):
        kw = dict(causal=causal, window=window)
        want = attention_ref(q, k, v, scale=scale, **kw)
        assert torch.equal(attention_ref(q2, k, v, scale=scale2, **kw), want)
        # and it is the function of the scale: not the default scale's result
        assert not torch.equal(want, attention_ref(q, k, v, **kw))
    assert flash_ops.positive_scale(q, 0.125) == (q, 0.125)


# ------------------------------------------------------------ vs Pallas
@pytest.mark.parametrize("d", PARITY_DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 48),
                                           (False, 40)])
def test_flash_vs_pallas_at_new_head_dims(d, causal, window, rng):
    q, k, v = normal(rng, 1, 4, 128, d), normal(rng, 1, 2, 128, d), normal(rng, 1, 2, 128, d)
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    got = flash_attention(*(to_torch(x) for x in (q, k, v)), **kw)
    want = jax_flash(*(to_jax(x) for x in (q, k, v)), interpret=True, **kw)
    assert got.shape == (1, 4, 128, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("d", PARITY_DIMS)
def test_flash_bf16_vs_pallas_at_new_head_dims(d, rng):
    q, k, v = normal(rng, 1, 4, 128, d), normal(rng, 1, 1, 128, d), normal(rng, 1, 1, 128, d)
    kw = dict(causal=True, window=64, block_q=64, block_k=64)
    got = flash_attention(*(to_torch(x, True) for x in (q, k, v)), **kw)
    want = jax_flash(*(to_jax(x, True) for x in (q, k, v)), interpret=True, **kw)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("d", PARITY_DIMS)
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_vs_pallas_at_new_head_dims(d, bf16, rng):
    b, h, hkv, s = 4, 8, 2, 256
    q, k, v = normal(rng, b, h, d), normal(rng, b, hkv, s, d), normal(rng, b, hkv, s, d)
    lengths = np.array([1, 63, s, 130], np.int32)
    got = decode_attention(*(to_torch(x, bf16) for x in (q, k, v)), torch.from_numpy(lengths),
                           block_s=64)
    want = jax_decode(*(to_jax(x, bf16) for x in (q, k, v)), jnp.asarray(lengths),
                      interpret=True, block_s=64)
    assert got.shape == (b, h, d)
    if bf16:
        assert_within_bf16_ulp(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ------------------------------------------------ the decode kernel's padding
def padded_width(d: int) -> int:
    """decode_attention.cu's DP: D rounded up to a multiple of 32."""
    return -(-d // 32) * 32


def padded_decode(q, k, v, lengths):
    """The kernel's arithmetic on its padded width: q, k and v get zero
    columns up to DP, and the output keeps the first D."""
    d = q.shape[-1]
    pad = padded_width(d) - d
    wide = [torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v)]
    return decode_attention_ref(*wide, lengths, scale=d ** -0.5)[..., :d]


@pytest.mark.parametrize("d", PARITY_DIMS)
def test_zero_columns_past_d_change_no_output(d, rng):
    b, h, hkv, s = 2, 8, 2, 128
    q = to_torch(normal(rng, b, h, d))
    k, v = to_torch(normal(rng, b, hkv, s, d)), to_torch(normal(rng, b, hkv, s, d))
    lengths = torch.tensor([0, 77], dtype=torch.int32)
    np.testing.assert_allclose(padded_decode(q, k, v, lengths).numpy(),
                               decode_attention_ref(q, k, v, lengths).numpy(), **F32)


def geometry(d: int, elem: int):
    """decode_attention.cu's Geo<T, D>: chunks a padded row (CPR), chunks
    with data (CD), chunks a row in shared memory (SC)."""
    cpr = padded_width(d) * elem // 16
    sc = cpr if cpr < 8 else -(-cpr // 8) * 8
    return cpr, d * elem // 16, sc


def k_offset(r: int, c: int, cpr: int, elem: int) -> int:
    """decode_attention.cu's k_offset: the byte offset of chunk c of k
    row r (0..7) inside the row."""
    if elem == 2:
        return (c ^ (r & (7 if cpr >= 8 else cpr - 1))) * 16
    return (c ^ ((r & 1) << 2)) * 16 if cpr >= 8 else c * 16


DECODE_CU = decode_ops.SOURCE.read_text()


def decode_smem_bytes(d: int, elem: int, group: int) -> int:
    """decode_attention.cu's smem_bytes<T, D>(group): q in float32, each
    warp's scores, p and corr, and the larger of the warps' k/v stages
    (one stage for float32 at D = 256, else two) and their merge area."""
    dp = padded_width(d)
    _, _, sc = geometry(d, elem)
    stages = 1 if elem == 4 and d > 128 else 2
    stage = 8 * stages * 2 * 8 * sc * 16
    merge = 8 * 8 * (dp + 2) * 4
    return group * dp * 4 + 8 * (2 * 8 * 8 + 8) * 4 + max(stage, merge)


@pytest.mark.parametrize("d", decode_ops.HEAD_DIMS)
@pytest.mark.parametrize("elem", [2, 4])
def test_decode_shared_memory_fits_at_every_group(d, elem):
    """The block's shared memory at the largest group (the launcher opts
    in to it) fits the H100's 232,448 B; at D = 256, 200,960 B at group 64
    in both dtypes (float32 on one stage a warp: two would be 262,144 B of
    stages alone) and 151,808 B at recurrentgemma's 16."""
    assert ("static constexpr int kStages = sizeof(T) == 4 && D > 128 ? 1 : 2;"
            in DECODE_CU)
    assert "static constexpr int kWarpBytes = kStages * kStepBytes;" in DECODE_CU
    assert decode_smem_bytes(d, elem, decode_ops.MAX_GROUP) <= SMEM_LIMIT
    if d == 256:
        assert decode_smem_bytes(d, elem, 64) == 200_960
        assert decode_smem_bytes(d, elem, 16) == 151_808
        assert 8 * 2 * 2 * 8 * geometry(d, 4)[2] * 16 == 262_144  # two float32 stages


@pytest.mark.parametrize("d", decode_ops.HEAD_DIMS)
@pytest.mark.parametrize("elem", [2, 4])
def test_decode_shared_memory_rows_hold_every_chunk_once(d, elem):
    cpr, cd, sc = geometry(d, elem)
    assert cpr % 4 == 0 and padded_width(d) % 32 == 0 and d * elem % 16 == 0
    assert cd <= cpr <= sc
    for r in range(8):
        offsets = [k_offset(r, c, cpr, elem) for c in range(cpr)]
        assert len(set(offsets)) == cpr  # a permutation of the row's chunks
        assert max(offsets) < sc * 16  # never past the row
    if elem == 2 and cpr >= 8:  # the mma B loads: 8 rows, 8 distinct bank quads
        for c in range(cpr):
            quads = {(r * sc * 16 + k_offset(r, c, cpr, elem)) // 16 % 8 for r in range(8)}
            assert len(quads) == 8


def group_geometry(d: int, mt: int) -> dict:
    """decode_attention.cu's GGeo<D, MT> (decode_group, bf16 groups above
    8): MT m-tiles of 16 heads, 64-row steps, k/v rows as decode_split
    keeps them (v with k's swizzle), q in bf16 rows of DP + 8 elements,
    scores [head][row + 4] in float32, p's bf16 hi and lo [head][row + 8],
    a ring of 3 stages (2 at D = 256); p.v's MT x NT output tiles of 16
    heads x 8 columns, TPW a warp."""
    _, _, sc = geometry(d, 2)
    rows, gp, dp = 64, 16 * mt, padded_width(d)
    g = dict(rows=rows, gp=gp, dp=dp, kk=dp // 16, row_bytes=sc * 16,
             stages=2 if d > 128 else 3, qs=dp * 2 + 16, ss=rows + 4, ps=rows + 8,
             nt=dp // 8, tpw=-(-mt * (dp // 8) // 8))
    g["step"] = 2 * rows * g["row_bytes"]
    g["bytes"] = (g["stages"] * g["step"] + gp * g["qs"] + (gp * g["ss"] + gp) * 4
                  + 2 * gp * g["ps"] * 2)
    return g


def test_decode_group_constants_are_the_wrappers():
    """ops.NARROW_GROUP and ops.GROUP_ROWS are the kernel's kNarrowGroup
    and kGroupRows; GGeo's choices are the lines group_geometry mirrors."""
    assert f"constexpr int kNarrowGroup = {decode_ops.NARROW_GROUP};" in DECODE_CU
    assert f"constexpr int kGroupRows = {decode_ops.GROUP_ROWS};" in DECODE_CU
    assert decode_ops.GROUP_ROWS % decode_ops.CHUNK_ALIGN == 0
    for line in ("static constexpr int GP = 16 * MT;",
                 "static constexpr int kStages = D > 128 ? 2 : 3;",
                 "static constexpr int QS = DP * 2 + 16;",
                 "static constexpr int SS = R + 4;",
                 "static constexpr int PS = R + 8;",
                 "static constexpr int NT = DP / 8;",
                 "static constexpr int TPW = (MT * NT + kWarps - 1) / kWarps;",
                 "kStages * kStepBytes + GP * QS + (GP * SS + GP) * 4 + 2 * GP * PS * 2;",
                 "cp_async16(dv + rr * G::kRowBytes + k_offset<T, G::CPR>(rr, c), vp + src, valid);",
                 "vr * G::kRowBytes;",
                 ": \"r\"(vrow + k_offset<T, G::CPR>(vr, nt)));",
                 "const int a = (16 * (i / G::NT) + g) * G::PS + 16 * ks + 2 * t;",
                 "sPh[sh * G::PS + 4 * i + sj] = hi;",
                 "if (group > kNarrowGroup) {",
                 "const int mt = (slice + 15) / 16;",
                 "const int n_slices = (group + kMaxGroup - 1) / kMaxGroup;",
                 "return (group + n_slices - 1) / n_slices;"):
        assert line in DECODE_CU, line
    # MT 1 .. 4 cover every slice, and a slice is at most MAX_GROUP heads
    assert -(-decode_ops.MAX_GROUP // 16) == 4
    for group in range(1, 1025):
        n, width = decode_ops.group_slices(group)
        assert width <= decode_ops.MAX_GROUP and (n - 1) * width < group <= n * width


@pytest.mark.parametrize("d", decode_ops.HEAD_DIMS)
@pytest.mark.parametrize("mt", [1, 2, 3, 4])
def test_decode_group_shared_memory_and_banks(d, mt):
    """decode_group<D, MT> fits the block's shared memory at every head
    dim and head tile count (granite-34b's 48 heads at 128: 138,432 B;
    recurrentgemma-9b's 16 at 256: 148,544 B; 64 at 256: 200,960 B), p.v's
    tiles cover the output, and its shared loads keep a warp's 32 lanes on
    32 banks: the q fragments (rows QS bytes apart), the k fragments and
    v's transposed ldmatrix rows (decode_split's swizzle), the softmax's
    score reads (four threads a head), and p's fragments (rows PS bf16
    apart)."""
    g = group_geometry(d, mt)
    assert g["bytes"] <= SMEM_LIMIT
    want = {(128, 3): 138_432, (256, 1): 148_544, (256, 4): 200_960}
    if (d, mt) in want:
        assert g["bytes"] == want[(d, mt)]
    assert 4 * g["gp"] <= 256 and g["rows"] // 8 == 8  # softmax threads; a warp per 8 rows
    assert (g["tpw"] - 1) * 8 < mt * g["nt"] <= g["tpw"] * 8  # every tile, no empty round
    assert g["nt"] * 8 == g["dp"] and g["gp"] == 16 * mt
    for kk in range(g["kk"]):
        for extra in (0, 16):  # a0 / a2 (and a1 / a3, 8 rows on: the same banks)
            banks = {((gg * g["qs"] + 32 * kk + extra + 4 * t) // 4) % 32
                     for gg in range(8) for t in range(4)}
            assert len(banks) == 32
    cpr = g["dp"] * 2 // 16
    if cpr >= 8:
        for w in range(8):
            for c in range(cpr):
                quads = {((8 * w + gg) * g["row_bytes"] + k_offset(8 * w + gg, c, cpr, 2)) // 16 % 8
                         for gg in range(8)}
                assert len(quads) == 8
    for i in range(g["rows"] // 4):
        banks = {(h * g["ss"] + 4 * i + j) % 32 for h in range(8) for j in range(4)}
        assert len(banks) == 32
    for ks in range(g["rows"] // 16):
        for extra in (0, 4):  # a0 / a2 in 32-bit words (a1 / a3, 8 heads on: the same)
            banks = {(gg * g["ps"] // 2 + 8 * ks + extra + t) % 32
                     for gg in range(8) for t in range(4)}
            assert len(banks) == 32


# -------------------------------------------------- flash_wgmma geometry
FLASH_CU = flash_ops.SOURCE.read_text()
#: shared memory a block may use on the H100 (232,448 of the SM's 256 KB)
SMEM_LIMIT = 232_448
#: flash_attention.cu's choices by head dim: p.v's columns, the block's
#: shared memory
PV_COLS = "return D <= kHalf ? kHalf : D <= 80 ? 80 : D <= 96 ? 96 : D <= kWCols ? kWCols : D;"
SMEM_PICK = ("static constexpr int smem =\n      1024 + qtile + 2 * ring * tile + ones + 8 * (1 + 3 * ring) + "
             "(self_load ? 4 * ring : 0);")
#: ones is D = 32's tile of ones (0 at every other width)
ONES_PICK = "static constexpr int ones = r64 ? tile : 0;"


def cu_consts():
    """Every ``constexpr int`` of flash_attention.cu that does not depend
    on a template parameter, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = (.*?);", FLASH_CU, re.S):
        expr = re.sub(r"//[^\n]*", "", expr)
        try:
            env[name] = int(eval(f"({expr})", {}, dict(env)))  # noqa: S307 - the repo's own source
        except (NameError, SyntaxError):
            pass  # a template-dependent constant
    return env


def cu_function(name: str) -> str:
    """The body of a function of flash_attention.cu at namespace level."""
    return re.search(rf"\n\S[^\n]* {name}\(.*?\n}}\n", FLASH_CU, re.S).group(0)


def route_dims(body: str, kernel: str):
    """The compiled widths ``body`` sends to ``kernel`` at rows of exactly
    that width (its ``false`` instances; ``true`` is the _any kernel)."""
    return {int(d) for d in re.findall(rf"{kernel}<(?:T, )?(\d+), false>", body)}


def test_flash_route_table_is_the_sources():
    """(dtype, D) -> kernel in ops.kernel_name, as launch_f32 and
    launch_16bit (bf16 and float16) of flash_attention.cu dispatch."""
    f32, bf16 = cu_function("launch_f32"), cu_function("launch_16bit")
    assert route_dims(f32, "launch_tf32") == set(flash_ops.HEAD_DIMS)
    assert route_dims(f32, "launch_wgmma") == set()
    assert route_dims(bf16, "launch_wgmma") == set(flash_ops.WGMMA_HEAD_DIMS)
    assert route_dims(bf16, "launch_tf32") == (set(flash_ops.HEAD_DIMS)
                                               - set(flash_ops.WGMMA_HEAD_DIMS))
    for d in flash_ops.HEAD_DIMS:
        assert flash_ops.kernel_name(torch.float32, d) == "flash_tf32"
        want = "flash_wgmma" if d in flash_ops.WGMMA_HEAD_DIMS else "flash_tf32"
        assert flash_ops.kernel_name(torch.bfloat16, d) == want
        assert flash_ops.kernel_name(torch.float16, d) == want
    # bf16 at 64 (musicgen-medium) and at 32 are on wgmma; float32 at every
    # head dim runs the split-TF32 mma.sync kernel; the CUDA-core flash_fwd
    # is gone
    assert flash_ops.kernel_name(torch.bfloat16, 64) == "flash_wgmma"
    assert "launch_wgmma<T, 64, false>" in bf16 and "launch_tf32<T, 64, " not in bf16
    assert flash_ops.kernel_name(torch.bfloat16, 32) == "flash_wgmma"
    assert "launch_wgmma<T, 32, false>" in bf16 and "launch_tf32" not in bf16
    assert "flash_fwd" not in FLASH_CU
    # every ported config that calls the kernels computes in bf16, on the
    # tensor cores
    for arch in KERNEL_ARCHS:
        cfg = get_config(arch)
        assert cfg.compute_dtype == torch.bfloat16
        assert flash_ops.kernel_name(cfg.compute_dtype, cfg.head_dim) == "flash_wgmma", arch
    assert get_config("musicgen_medium").head_dim == 64


#: flash_wgmma's head dims whose tiles are two 64-column spans
WIDE_DIMS = tuple(d for d in flash_ops.WGMMA_HEAD_DIMS if 64 < d <= 128)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_wgmma_geometry(d):
    """flash_wgmma<D>'s tiles, tensor maps, k-steps, shared memory and
    stores, from the constants in flash_attention.cu."""
    c = cu_consts()
    half, cols, bq, bk = c["kHalf"], c["kWCols"], c["kWBQ"], c["kWBK"]
    assert (bq, bk, cols, half) == (128, 128, 128, 64)
    # tensor map: rows of D elements, a multiple of 16 bytes as TMA needs,
    # and so is a head's stride at any S
    assert (d * 2) % 16 == 0
    assert all((s * d * 2) % 16 == 0 for s in (1, 200, 2048))
    # boxes of 64 x 128: the inner extent is the 128-byte swizzle span, and
    # two boxes reach past D (the second starts inside the row)
    assert half * 2 == 128 and half < d <= 2 * half == cols
    # expect_tx counts both boxes whole: columns past D are TMA's zero fill
    assert c["kTileBytes"] == 2 * half * bk * 2 == 2 * c["kHalfBytes"]
    # q.k^T: ceil(D/16) steps of k16, each inside one 64-column half
    steps = -(-d // 16)
    assert "kk < (D + 15) / 16" in FLASH_CU
    assert steps == {80: 5, 120: 8, 128: 8}[d] and steps * 16 <= cols
    offsets = [(kk // 4) * c["kHalfBytes"] + (kk % 4) * 32 for kk in range(steps)]
    assert all(o % c["kHalfBytes"] + 32 <= 128 for o in offsets)  # within a 128-byte row
    covered = [16 * kk + j for kk in range(steps) for j in range(16)]
    assert covered[:d] == list(range(d)) and all(col >= d for col in covered[d:])
    # shared memory: q, the two-stage k and v rings, barriers, 1 KB slack
    assert c["kWSmem"] == (1024 + c["kTileBytes"] * (1 + 2 * c["kStages"])
                           + 8 * (1 + 3 * c["kStages"]))
    assert c["kWSmem"] <= SMEM_LIMIT
    assert c["kWThreads"] == (c["kConsumers"] + 1) * 128
    # p.v: m64n80k16 up to D = 80 (64 columns of the first half, 16 of the
    # second, a legal wgmma width), else m64n128k16 over the padded tile
    assert PV_COLS in FLASH_CU
    assert "m64n80k16" in FLASH_CU
    pv = 80 if d <= 80 else cols
    assert d <= pv <= cols and pv % 8 == 0 and pv - half <= half
    # stores: column 8j + 2(lane % 4) + e of the m64nPV accumulator, pairs
    # kept under col < D: every output column written exactly once
    written = [8 * j + c2 + e for j in range(pv // 8) for c2 in (0, 2, 4, 6)
               if 8 * j + c2 < d for e in (0, 1)]
    assert sorted(written) == list(range(d))


def test_flash_wgmma_geometry_at_64():
    """flash_wgmma<64> (musicgen-medium): one 64-column span a tile, from
    the constants and WGeo of flash_attention.cu."""
    c = cu_consts()
    d, half, bk = 64, c["kHalf"], c["kWBK"]
    # a row of the tensor map is one 128-byte swizzle span and one box
    assert d * 2 == half * 2 == 128
    assert "static constexpr int boxes = (D + kHalf - 1) / kHalf;" in FLASH_CU
    # (r64: D = 32's rows of 64 bytes)
    assert "static constexpr int keys = r64 ? k32Keys : D > kWCols ? kWideKeys : kWBK;" \
        in FLASH_CU
    assert "static constexpr int span = keys * (r64 ? k32RowBytes : kHalf * 2);" in FLASH_CU
    assert "static constexpr int tile = boxes * span;" in FLASH_CU
    assert "static constexpr int qtile = r64 ? kWBQ * k32RowBytes : boxes * kHalfBytes;" \
        in FLASH_CU
    boxes = -(-d // half)
    tile = boxes * bk * half * 2
    assert boxes == 1 and tile == 16 * 1024
    # every k and v tile is `boxes` boxes and expects the bytes they deliver
    # (a full 64 x 128 box each, rows past S as zero fill): load_tile, which
    # the producer and, at D = 256, the consumers call; q likewise
    assert FLASH_CU.count("for (int h = 0; h < B; ++h)") == 3
    assert FLASH_CU.count("mbar_expect_tx(full + 8 * s, T);") == 1
    assert FLASH_CU.count("mbar_expect_tx(bar_q, QT);") == 2
    assert "mbar_expect_tx(bar_q, QT);" in FLASH_CU
    assert tile == boxes * half * bk * 2
    # no box starts past column 0 or reaches past column 64
    box_columns = [(h * half, h * half + half) for h in range(boxes)]
    assert box_columns == [(0, 64)] and all(end <= d for _, end in box_columns)
    # q.k^T: four k-steps of 16, all inside the one 128-byte row
    steps = -(-d // 16)
    offsets = [(kk // 4) * c["kHalfBytes"] + (kk % 4) * 32 for kk in range(steps)]
    assert steps == 4 and offsets == [0, 32, 64, 96]
    assert all(o + 32 <= 128 for o in offsets)
    # p.v at m64n64k16 writes every output column below 64 exactly once
    assert PV_COLS in FLASH_CU
    assert "m64n64k16" in FLASH_CU
    pv = half
    written = [8 * j + c2 + e for j in range(pv // 8) for c2 in (0, 2, 4, 6)
               if 8 * j + c2 < d for e in (0, 1)]
    assert sorted(written) == list(range(d))
    # the ring: four stages of k and v, q, barriers and 1 KB slack within
    # the block's shared memory
    assert c["kNarrowStages"] == 4
    assert c["kNarrowSmem"] == (1024 + c["kHalfBytes"] * (1 + 2 * c["kNarrowStages"])
                                + 8 * (1 + 3 * c["kNarrowStages"]))
    assert c["kNarrowSmem"] <= SMEM_LIMIT
    assert SMEM_PICK in FLASH_CU and ONES_PICK in FLASH_CU
    # registers a consumer thread holds across the overlapped loop: the
    # scores (64), o (pv / 2) and the bf16 p of the last tile (32), under
    # the 240 that setmaxnreg gives a consumer
    assert 64 + pv // 2 + 32 < 240 and "setmaxnreg.inc.sync.aligned.u32 240;" in FLASH_CU


def test_flash_wgmma_geometry_at_256():
    """flash_wgmma<256> (recurrentgemma-9b): four 64-column spans a row,
    k and v tiles of 64 keys, a ring of two stages, two warpgroups and no
    producer, from the constants and WGeo of flash_attention.cu."""
    c = cu_consts()
    d, half, bq = 256, c["kHalf"], c["kWBQ"]
    keys, span = c["kWideKeys"], c["kWideSpanBytes"]
    assert (c["kWideCols"], keys, bq) == (256, 64, 128)
    assert 256 in flash_ops.WGMMA_HEAD_DIMS and 256 in decode_ops.HEAD_DIMS
    assert flash_ops.kernel_name(torch.bfloat16, 256) == "flash_wgmma"
    assert flash_ops.kernel_name(torch.float32, 256) == "flash_tf32"
    # 128-key tiles do not fit: q 64 KB + 2 stages of k and v at 64 KB
    assert 1024 + 4 * c["kHalfBytes"] + 2 * c["kStages"] * 4 * c["kHalfBytes"] > SMEM_LIMIT
    # the tensor map's rows are 512 B; boxes of 64 columns x 128 q rows or
    # 64 keys, four a tile; the tiles' bytes are what expect_tx counts
    boxes = d // half
    assert boxes == 4 and d * 2 == 512 and (d * 2) % 16 == 0
    assert span == keys * half * 2 == 8 * 1024
    assert c["kWideTileBytes"] == boxes * span == 32 * 1024
    assert c["kWideQBytes"] == boxes * c["kHalfBytes"] == 64 * 1024
    assert "make_map(&tk, k, bh / group, seq_len, ld, keys, type, box, sw)" in FLASH_CU
    assert "make_map(&tq, q, bh, seq_len, ld, kWBQ, type, box, sw)" in FLASH_CU
    assert "constexpr int keys = WGeo<D>::keys;" in FLASH_CU
    assert "tma_load(ring + s * T + h * SP, map, full + 8 * s, h * kHalf, (lo + it) * KB, kvh);" \
        in FLASH_CU
    assert "tma_load(sQ + h * kHalfBytes, tm_q" in FLASH_CU
    # the ring: two stages, 197 KB with q, 1 KB slack, the barriers (q; k
    # landed, v landed, read a stage) and a refill counter a stage; three
    # stages would not fit
    assert c["kWideStages"] == 2
    assert c["kWideSmem"] == (1024 + c["kWideQBytes"] + 2 * 2 * c["kWideTileBytes"]
                              + 8 * (1 + 3 * 2) + 4 * 2)
    assert c["kWideSmem"] == 197_696 <= SMEM_LIMIT
    assert 1024 + c["kWideQBytes"] + 2 * 3 * c["kWideTileBytes"] > SMEM_LIMIT
    assert "st_shared(bar_empty + 8 * R + 4 * s, 0u);" in FLASH_CU
    assert SMEM_PICK in FLASH_CU and ONES_PICK in FLASH_CU
    # q.k^T: 16 k-steps of m64n64k16; step kk reads span kk / 4 of q (128
    # rows, kHalfBytes apart) and of k (64 rows, kWideSpanBytes apart), 32 B
    # into the 128-byte row, every column of D exactly once
    steps = -(-d // 16)
    assert steps == 16 and "m64n64k16" in FLASH_CU
    q_off = [(kk // 4) * c["kHalfBytes"] + (kk % 4) * 32 for kk in range(steps)]
    k_off = [(kk // 4) * span + (kk % 4) * 32 for kk in range(steps)]
    assert all(o % 128 + 32 <= 128 for o in q_off + k_off)
    assert max(k_off) + 32 <= c["kWideTileBytes"] and max(q_off) + 32 <= c["kWideQBytes"]
    assert "sw128_desc(tK + (kk / 4) * WGeo<D>::span + off, 16, 1024)" in FLASH_CU
    # p.v: one m64n256k16 a k-step of 16 keys (4 over a tile), v's spans
    # WGeo<D>::span apart (LBO); writes every output column once
    assert PV_COLS in FLASH_CU and "m64n256k16" in FLASH_CU
    assert "sw128_desc(tV + kk * 16 * 128, WGeo<D>::span, 1024)" in FLASH_CU
    pv = d
    assert keys // 16 == 4 and (keys // 16 - 1) * 16 * 128 + 16 * 128 <= span
    written = [8 * j + c2 + e for j in range(pv // 8) for c2 in (0, 2, 4, 6)
               if 8 * j + c2 < d for e in (0, 1)]
    assert sorted(written) == list(range(d))
    # registers a consumer thread holds: o (128), the scores (32) and the
    # bf16 p of the tile before (16).  ptxas budgets a block of w warps
    # 65,536 / 4 / (32 ceil(w / 4)) registers a thread (the register file is
    # split over four sub-partitions), capped at 255: 12 or 9 warps get 168,
    # too few; the 8 warps of two warpgroups and no producer get 255
    def budget(warps):
        return min(255, 65_536 // 4 // (32 * -(-warps // 4)) // 8 * 8)
    assert budget(12) == budget(9) == 168 < pv // 2 + keys // 2 + keys // 4
    assert c["kWideThreads"] == 2 * 128 and budget(c["kWideThreads"] // 32) == 255
    assert pv // 2 + keys // 2 + keys // 4 < 255
    assert "static constexpr int threads = self_load ? kWideThreads : kWThreads;" in FLASH_CU
    assert "static constexpr bool self_load = r64 || D > kWCols || D == 96;" in FLASH_CU
    # one block an SM at 256 (two only at D = 32's 64-key tiles)
    assert "__launch_bounds__(WGeo<D>::threads, WGeo<D>::blocks)" in FLASH_CU
    assert "static constexpr int blocks = r64 ? 2 : 1;" in FLASH_CU
    # key tiles a q tile sees, at the tile height: the causal bound reaches
    # the tile of the q tile's last row, the window's its first row's window
    assert "const int hi = causal ? min((q0 + kWBQ - 1) / KB + 1, n_kt) : n_kt;" in FLASH_CU
    for q0, window in ((0, None), (128, None), (3968, 2048), (2048, 2048), (256, 64)):
        hi = (q0 + bq - 1) // keys + 1
        lo = max((q0 - window + 1) // keys, 0) if window and q0 - window + 1 > 0 else 0
        first = max(q0 - window + 1, 0) if window else 0
        assert lo * keys <= first and hi * keys > q0 + bq - 1
        assert (hi - 1) * keys <= q0 + bq - 1  # no tile wholly past the q tile


def test_flash_tf32_float32_shared_memory_at_256():
    """float32 at D = 256 runs flash_tf32<float, 256>: four warps of 16 q
    rows, q * scale as float32 and a two-stage ring of 32-key k and v tiles
    take 201,728 B of the block's shared memory (TGeo in the source)."""
    c = cu_consts()
    d = 256
    rows, keys, stages = c["kTRows"] * c["kTWideWarps"], c["kTWideKeys"], c["kTStages"]
    assert (rows, keys, stages) == (64, 32, 2)
    qs = (d + 15) // 16 * 16 + 8
    ks, vs = qs, d + 4
    smem = rows * qs * 4 + stages * keys * (ks + vs) * 4
    assert (qs, vs) == (264, 260) and smem == 201_728 <= SMEM_LIMIT
    # q's split halves beside the ring would not fit
    assert 2 * rows * qs * 4 + stages * keys * (ks + vs) * 4 > SMEM_LIMIT
    for line in ("static constexpr int qs = (D + 15) / 16 * 16 + 8;",
                 "static constexpr int ks = qs;",
                 "static constexpr int vs = D + 4;",
                 "static constexpr int smem = rows * qs * 4 + kTStages * keys * (ks + vs) * 4;",
                 "static constexpr int keys = wide ? kTWideKeys : kTKeys;"):
        assert line in FLASH_CU
    assert "launch_tf32<T, 256, false>" in cu_function("launch_f32")


def overlapped_turns(n_iter):
    """The named-barrier turns of consume_overlap<64>, played out: each
    warpgroup's program as a list of ("sync", own barrier) / ("arrive",
    the other's) steps, run in whatever order can proceed.  Returns each
    barrier's arrivals left over at the end, or None on a deadlock."""
    def program(wg):
        mine, other = 1 + wg, 2 - wg
        steps = [("arrive", other)] if wg == 1 else []  # warpgroup 0 first
        steps += [("sync", mine), ("arrive", other)]  # tile 0: q.k^T
        steps += [("sync", mine), ("arrive", other)] * (n_iter - 1)  # q.k^T, p.v
        steps += [("sync", mine)] + ([("arrive", other)] if wg == 0 else [])  # last p.v
        return steps

    progs, pcs = [program(0), program(1)], [0, 0]
    pending = {1: 0, 2: 0}  # warpgroups arrived and not yet released
    waiting = {1: False, 2: False}
    while pcs[0] < len(progs[0]) or pcs[1] < len(progs[1]):
        moved = False
        for wg in (0, 1):
            if pcs[wg] == len(progs[wg]):
                continue
            kind, bar = progs[wg][pcs[wg]]
            if kind == "arrive":
                pending[bar] += 1
                pcs[wg] += 1
                moved = True
            elif not waiting[bar]:
                waiting[bar] = True
                pending[bar] += 1
                moved = True
            if kind == "sync" and waiting[bar] and pending[bar] == 2:
                pending[bar], waiting[bar] = 0, False  # 256 threads: released
                pcs[wg] += 1
                moved = True
        if not moved:
            return None
    return pending


@pytest.mark.parametrize("n_iter", [1, 2, 3, 16])
def test_overlapped_schedule_turns_balance(n_iter):
    """The two consumer warpgroups' turns at the tensor cores never
    deadlock and leave no arrival behind, for every tile count (a block
    sees 1 to S/128 key tiles)."""
    assert overlapped_turns(n_iter) == {1: 0, 2: 0}
    assert "if (wg == 1) bar_arrive(other);" in FLASH_CU
    assert "if (wg == 0) bar_arrive(other);" in FLASH_CU


def wide_refills(n_iter: int, ring: int, seed: int):
    """consume_wide<256>'s loads, played out: two warpgroups, no producer.
    Thread 0 loads tiles 0 .. ring - 1 of k and v; each warpgroup reads k
    tile j (q.k^T) and v tile j - 1 (p.v) in iteration j, then releases
    (refill) k tile j and v tile j - 1: every thread arrives on the
    release's barrier and thread 0 counts at its slot's counter; the second
    to count loads each released tile + ring into its stage.  The two warpgroups and the copies in flight advance
    in a random order.  Returns each ring's loads, or None on a deadlock;
    asserts that a tile is read from its own stage once it has landed and
    that a stage is refilled only after both warpgroups released it."""
    import random

    rnd = random.Random(seed)
    stage = {"k": [None] * ring, "v": [None] * ring}  # tile landed in each stage
    released = {"k": {}, "v": {}}  # tile -> warpgroups that released it
    count = [0] * ring
    loads = {"k": [], "v": []}
    flight = []  # (ring, tile) copies issued, not landed

    def load(r, tile):
        if tile >= ring:  # the stage's last tile was released by both
            assert released[r].get(tile - ring, set()) == {0, 1}
        stage[r][tile % ring] = None
        loads[r].append(tile)
        flight.append((r, tile))

    def program():
        ops = [("read", "k", 0), ("release", 0, -1)]
        for j in range(1, n_iter):
            ops += [("read", "k", j), ("read", "v", j - 1), ("release", j, j - 1)]
        return ops + [("read", "v", n_iter - 1)]

    for tile in range(min(ring, n_iter)):
        load("k", tile)
        load("v", tile)
    progs, pcs = [program(), program()], [0, 0]
    while pcs[0] < len(progs[0]) or pcs[1] < len(progs[1]) or flight:
        moves = [("land", i) for i in range(len(flight))]
        for wg in (0, 1):
            if pcs[wg] == len(progs[wg]):
                continue
            op = progs[wg][pcs[wg]]
            if op[0] == "release" or stage[op[1]][op[2] % ring] == op[2]:
                moves.append(("wg", wg))
        if not moves:
            return None
        what, i = rnd.choice(moves)
        if what == "land":
            r, tile = flight.pop(i)
            stage[r][tile % ring] = tile
            continue
        op = progs[i][pcs[i]]
        pcs[i] += 1
        if op[0] == "release":
            _, kt, vt = op
            nxt = [(r, t + ring) for r, t in (("k", kt), ("v", vt))
                   if t >= 0 and t + ring < n_iter]
            for r, t in (("k", kt), ("v", vt)):
                if t >= 0:
                    released[r].setdefault(t, set()).add(i)
            if nxt:
                old = count[kt % ring]
                count[kt % ring] += 1
                if old % 2:  # the second to count: both released, refill
                    for r, t in nxt:
                        load(r, t)
    return loads


@pytest.mark.parametrize("n_iter", [1, 2, 3, 4, 7, 32])
def test_wide_refills_load_every_tile_once(n_iter):
    """consume_wide's refills never deadlock, load every k and v tile once
    into its stage, after both warpgroups released the tile before it, in
    any order the warpgroups and copies take (a block sees 1 to S/64 key
    tiles).  The kernel's lines are the ones played out, and it takes the
    D = 64 schedule's turns (test_overlapped_schedule_turns_balance)."""
    ring = cu_consts()["kWideStages"]
    for seed in range(30):
        loads = wide_refills(n_iter, ring, seed)
        assert loads is not None, seed
        assert sorted(loads["k"]) == list(range(n_iter)) == sorted(loads["v"])
    for line in ("const bool k_next = kt >= 0 && kt + R < n_iter, v_next = vt >= 0 && vt + R < n_iter;",
                 "(atom_add_shared(cnt + 4 * s, 1u) & 1u)) {",
                 "mbar_wait(read + 8 * s, (j / R) & 1);",
                 "refill<D>(bar_read, cnt, sK, sV, bar_k, bar_v, tm_k, tm_v, j, kt, vt, n_iter, lo, kvh);",
                 "release(it, it, it - 1);",
                 "release(0, 0, -1);",
                 "for (int it = 0; it < R && it < n_iter; ++it) {"):
        assert line in FLASH_CU, line
    body = cu_function("consume_wide")
    assert body.count("bar_sync(mine);") == 3 and "if (wg == 1) bar_arrive(other);" in body
    assert body.count("bar_arrive(other);") == 4 and "if (wg == 0) bar_arrive(other);" in body


# ------------------------------------------------------------------ LM
def small_config(pkg_cfg, d_head: int):
    """A 2-layer danube-family smoke config whose head dim is ``d_head``
    (2 q heads, 1 kv head, window 16)."""
    return dataclasses.replace(pkg_cfg, d_model=2 * d_head, n_heads=2, n_kv_heads=1,
                               d_ff=2 * d_head, n_layers=2,
                               segments=((("attn",), 2),), use_flash_kernel=True)


@pytest.mark.parametrize("d_head", [120, 80, 256])
def test_lm_kernel_route_at_new_head_dims_matches_jax(d_head):
    jcfg = dataclasses.replace(small_config(jax_smoke_config("h2o_danube_3_4b"), d_head),
                               compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(small_config(get_smoke_config("h2o_danube_3_4b"), d_head),
                               compute_dtype=torch.float32)
    assert pcfg.head_dim == d_head and pcfg.window == 16
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    np.testing.assert_allclose(as_f32(port(torch.from_numpy(tokens))),
                               as_f32(jax.jit(jmodel.forward)(params, jnp.asarray(tokens))),
                               rtol=1e-4, atol=1e-4)
    state_j = jmodel.init_decode_state(2, max_len=32)
    state_p = port.init_decode_state(2, max_len=32)
    step = jax.jit(jmodel.decode_step)
    lengths = np.array([0, 5], np.int32)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        want, state_j = step(params, state_j, jnp.asarray(tok), jnp.asarray(lengths))
        got, state_p = port.decode_step(state_p, torch.from_numpy(tok),
                                        torch.from_numpy(lengths))
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=1e-4, atol=1e-4)
        lengths = lengths + 1
