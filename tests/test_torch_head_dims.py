"""Head dims 80 (qwen3-32b) and 120 (h2o-danube-3-4b) through the port's
attention kernels, checked on the CPU.

* Every ported config's head dim passes both wrappers' device checks.
* The plain flash and decode versions (what the wrappers take on CPU
  tensors) against the Pallas kernels in interpret mode at D = 80 and
  120: float32 to rtol=atol=1e-5 (float32 sums in another order),
  bfloat16 within one bf16 ulp (both round once from float32).
* The decode kernel's padded width: zero columns past D in q, k and v
  change no output column (``padded_decode`` below mirrors it in torch),
  and the shared-memory geometry of ``decode_attention.cu`` (mirrored by
  ``geometry``) keeps every k chunk inside its row and the mma loads off
  shared bank conflicts.
* ``LM`` with ``use_flash_kernel=True`` at head dims 120 and 80 against
  the JAX package, params carried across by ``params_from_numpy``, at
  the 1e-4 of tests/test_torch_models.py in float32.
"""
import dataclasses
import re

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
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import params_from_numpy

torch.set_num_threads(1)  # small tensors: extra threads only contend

F32 = dict(rtol=1e-5, atol=1e-5)
NEW_DIMS = (80, 120)


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
@pytest.mark.parametrize("arch", PORTED)
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


@pytest.mark.parametrize("d", [96, 256])
def test_a_head_dim_no_config_needs_is_refused(d):
    q = torch.zeros((1, 2, 4, d))
    with pytest.raises(ValueError, match="head dim"):
        flash_ops._check_cuda(q, q, q, None)
    with pytest.raises(ValueError, match="head dim"):
        decode_ops._check_cuda(q[:, :, 0], q, q, torch.ones((1,), dtype=torch.int32))


# ------------------------------------------------------------ vs Pallas
@pytest.mark.parametrize("d", NEW_DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 48),
                                           (False, 40)])
def test_flash_vs_pallas_at_new_head_dims(d, causal, window, rng):
    q, k, v = normal(rng, 1, 4, 128, d), normal(rng, 1, 2, 128, d), normal(rng, 1, 2, 128, d)
    kw = dict(causal=causal, window=window, block_q=64, block_k=64)
    got = flash_attention(*(to_torch(x) for x in (q, k, v)), **kw)
    want = jax_flash(*(to_jax(x) for x in (q, k, v)), interpret=True, **kw)
    assert got.shape == (1, 4, 128, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("d", NEW_DIMS)
def test_flash_bf16_vs_pallas_at_new_head_dims(d, rng):
    q, k, v = normal(rng, 1, 4, 128, d), normal(rng, 1, 1, 128, d), normal(rng, 1, 1, 128, d)
    kw = dict(causal=True, window=64, block_q=64, block_k=64)
    got = flash_attention(*(to_torch(x, True) for x in (q, k, v)), **kw)
    want = jax_flash(*(to_jax(x, True) for x in (q, k, v)), interpret=True, **kw)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("d", NEW_DIMS)
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


@pytest.mark.parametrize("d", NEW_DIMS)
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


# -------------------------------------------------- flash_wgmma geometry
FLASH_CU = flash_ops.SOURCE.read_text()
#: shared memory a block may use on the H100 (232,448 of the SM's 256 KB)
SMEM_LIMIT = 232_448


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
    return {int(d) for d in re.findall(rf"{kernel}<(?:T, )?(\d+)>", body)}


def test_flash_route_table_is_the_sources():
    """(dtype, D) -> kernel in ops.kernel_name, as launch_f32 and
    launch_bf16 of flash_attention.cu dispatch."""
    f32, bf16 = cu_function("launch_f32"), cu_function("launch_bf16")
    assert route_dims(f32, "launch") == set(flash_ops.HEAD_DIMS)
    assert route_dims(f32, "launch_wgmma") == set()
    assert route_dims(bf16, "launch_wgmma") == set(flash_ops.WGMMA_HEAD_DIMS)
    assert route_dims(bf16, "launch") == set(flash_ops.HEAD_DIMS) - set(flash_ops.WGMMA_HEAD_DIMS)
    for d in flash_ops.HEAD_DIMS:
        assert flash_ops.kernel_name(torch.float32, d) == "flash_fwd"
        want = "flash_wgmma" if d in flash_ops.WGMMA_HEAD_DIMS else "flash_fwd"
        assert flash_ops.kernel_name(torch.bfloat16, d) == want
    # every ported config computes in bf16, on the tensor cores but for
    # musicgen-medium, whose head dim 64 runs flash_fwd
    for arch in PORTED:
        cfg = get_config(arch)
        assert cfg.compute_dtype == torch.bfloat16
        want = "flash_fwd" if arch == "musicgen_medium" else "flash_wgmma"
        assert flash_ops.kernel_name(cfg.compute_dtype, cfg.head_dim) == want, arch
    assert get_config("musicgen_medium").head_dim == 64


@pytest.mark.parametrize("d", flash_ops.WGMMA_HEAD_DIMS)
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
    assert "return D <= 80 ? 80 : kWCols;" in FLASH_CU and "m64n80k16" in FLASH_CU
    pv = 80 if d <= 80 else cols
    assert d <= pv <= cols and pv % 8 == 0 and pv - half <= half
    # stores: column 8j + 2(lane % 4) + e of the m64nPV accumulator, pairs
    # kept under col < D: every output column written exactly once
    written = [8 * j + c2 + e for j in range(pv // 8) for c2 in (0, 2, 4, 6)
               if 8 * j + c2 < d for e in (0, 1)]
    assert sorted(written) == list(range(d))


# ------------------------------------------------------------------ LM
def small_config(pkg_cfg, d_head: int):
    """A 2-layer danube-family smoke config whose head dim is ``d_head``
    (2 q heads, 1 kv head, window 16)."""
    return dataclasses.replace(pkg_cfg, d_model=2 * d_head, n_heads=2, n_kv_heads=1,
                               d_ff=2 * d_head, n_layers=2,
                               segments=((("attn",), 2),), use_flash_kernel=True)


@pytest.mark.parametrize("d_head", [120, 80])
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
