"""The kernels' whole domain, checked on the CPU: float16 in both
attention kernels, any head dim from 1 to 256, any decode group, and any
number of aggregation groups.

* float16 flash and decode: the port's plain versions (what the wrappers
  take on CPU tensors) against the Pallas kernels in interpret mode at
  head dims 1, 33, 96, 150 and 200, and decode at MQA groups 71/1 (Falcon-7B's) and
  128/1, at small S: within one float16 ulp plus 1e-5 (both compute in
  float32 and round once); bfloat16 and float32 at the same odd head dims.
* fused_filter_agg at 1,500 and 4,096 groups against the Pallas kernel in
  interpret mode: counts exact, float sums to rtol = atol = 1e-5.
* A two-layer smoke ``LM`` in float16, forward and decode, on both routes,
  against the JAX package's float16 LM, params carried by
  ``params_from_numpy``: the mean |difference| within 2e-2 and the port no
  farther from the float32 logits than JAX within 1.5x, the bf16 rule of
  tests/test_torch_models.py (float16 rounds at other places in the two
  frameworks too).
* The wrappers' launch arguments through stand-in libraries: the float16
  dtype code, the row and compiled width each head dim runs (flash pads
  rows whose bytes are not a multiple of 16 only in float32 and in 16-bit
  types at most 32 or above 192 elements; it passes the caller's tensors
  and the library's output otherwise), the
  group slices and the plan above 64 q heads, the caches passed as they
  are, and the many-group variant's plan and partials.
* Head dims above 256 taken by both wrappers in every dtype, and 0
  refused (``tests/test_torch_wide_heads.py`` holds the wide kernels'
  plans).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.fused_filter_agg import fused_filter_agg as jax_ffa
from repro.models import LM as JaxLM
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.fused_filter_agg import fused_filter_agg
from repro_torch.kernels.fused_filter_agg import ops as ffa_ops
from repro_torch.models import params_from_numpy

torch.set_num_threads(1)  # small tensors: extra threads only contend

H100_SMS = 132
ODD_DIMS = (1, 33, 96, 150, 200)
#: torch dtype, the JAX dtype, mantissa bits (None: float32's 1e-5 rule)
DTYPES = {"float16": (torch.float16, jnp.float16, 10),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 7),
          "float32": (torch.float32, jnp.float32, None)}


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_close(got, want, bits):
    """float32: 1e-5 + 1e-5 |want|; a 16-bit type: one ulp of the type
    at the larger magnitude plus 1e-5."""
    got, want = as_f32(got), as_f32(want)
    diff = np.abs(got - want)
    if bits is None:
        assert np.all(diff <= 1e-5 + 1e-5 * np.abs(want)), float(diff.max())
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(mag)) - bits)
    assert np.all(diff <= 1e-5 + ulp), float(np.max(diff - ulp))


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(x, name):
    tdt, jdt, _ = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


# ------------------------------------------------ plain versions vs Pallas
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", ODD_DIMS)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 16)])
def test_flash_at_odd_head_dims_matches_pallas(name, d, causal, window, rng):
    b, h, hkv, s = 1, 4, 2, 64
    (qt, qj), (kt, kj), (vt, vj) = (both(normal(rng, b, n, s, d), name)
                                    for n in (h, hkv, hkv))
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jax_flash(qj, kj, vj, causal=causal, window=window, interpret=True,
                     block_q=32, block_k=32)
    assert got.dtype == qt.dtype and got.shape == (b, h, s, d)
    assert_close(got, want, DTYPES[name][2])


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", ODD_DIMS)
def test_decode_at_odd_head_dims_matches_pallas(name, d, rng):
    b, h, hkv, s = 3, 8, 2, 128
    (qt, qj), (kt, kj), (vt, vj) = (both(x, name) for x in (
        normal(rng, b, h, d), normal(rng, b, hkv, s, d), normal(rng, b, hkv, s, d)))
    lengths = np.array([0, 5, s], np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), interpret=True, block_s=64)
    assert got.dtype == qt.dtype and got.shape == (b, h, d)
    assert_close(got, want, DTYPES[name][2])


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("group,d", [(71, 64), (128, 64), (71, 33)])
def test_decode_at_groups_above_64_matches_pallas(name, group, d, rng):
    b, s = 2, 128
    (qt, qj), (kt, kj), (vt, vj) = (both(x, name) for x in (
        normal(rng, b, group, d), normal(rng, b, 1, s, d), normal(rng, b, 1, s, d)))
    lengths = np.array([7, s - 1], np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), interpret=True, block_s=64)
    assert_close(got, want, DTYPES[name][2])


@pytest.mark.parametrize("num_groups", [1500, 4096])
def test_fused_filter_agg_above_1024_groups_matches_pallas(num_groups, rng):
    n = 6000
    keys = rng.integers(-1, num_groups + 1, n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    filt = (rng.random(n) * 100).astype(np.float32)
    kw = dict(op="ge", threshold=30.0, num_groups=num_groups)
    got_s, got_c = fused_filter_agg(torch.from_numpy(keys), torch.from_numpy(vals),
                                    torch.from_numpy(filt), **kw)
    want_s, want_c = jax_ffa(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(filt),
                             interpret=True, **kw)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ---------------------------------------------------------- LM in float16
@pytest.mark.parametrize("flag", [False, True])
def test_lm_in_float16_matches_jax(flag):
    """yi_6b's two-layer smoke config in float16: forward and three decode
    steps, on the reference route and the kernel route."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"), use_flash_kernel=flag,
                               compute_dtype=jnp.float16)
    pcfg = dataclasses.replace(get_smoke_config("yi_6b"), use_flash_kernel=flag,
                               compute_dtype=torch.float16)
    assert pcfg.n_layers == 2
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = params_from_numpy(tree, pcfg, device="cpu")
    f32 = params_from_numpy(tree, dataclasses.replace(pcfg, compute_dtype=torch.float32),
                            device="cpu")

    def close(got, want, ref):
        got, want, ref = as_f32(got), as_f32(want), as_f32(ref)
        assert np.all(np.isfinite(got))
        assert np.abs(got - want).mean() <= 2e-2
        assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max() + 1e-6

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    got = port(torch.from_numpy(tokens))
    assert got.dtype == torch.float16
    close(got, jax.jit(jmodel.forward)(params, jnp.asarray(tokens)), f32(torch.from_numpy(tokens)))
    state_j = jmodel.init_decode_state(2, max_len=32)
    state_p = port.init_decode_state(2, max_len=32)
    state_f = f32.init_decode_state(2, max_len=32)
    step = jax.jit(jmodel.decode_step)
    lengths = np.array([0, 5], np.int32)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        want, state_j = step(params, state_j, jnp.asarray(tok), jnp.asarray(lengths))
        got, state_p = port.decode_step(state_p, torch.from_numpy(tok), torch.from_numpy(lengths))
        ref, state_f = f32.decode_step(state_f, torch.from_numpy(tok), torch.from_numpy(lengths))
        close(got, want, ref)
        lengths = lengths + 1


# ------------------------------------------------ the wrappers' arguments
class FakeFlashLib:
    def __init__(self):
        self.calls = []

    def flash_attention_launch(self, *args):
        self.calls.append(args)
        return 0


class FakeDecodeLib:
    def __init__(self):
        self.calls = []

    def decode_attention_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("dtype,d,row,width,kernel", [
    (torch.float16, 128, 128, 128, "flash_wgmma<f16, 128>"),
    (torch.float16, 32, 32, 32, "flash_wgmma<f16, 32>"),
    (torch.bfloat16, 96, 96, 96, "flash_wgmma_any<bf16, 96>"),
    (torch.bfloat16, 33, 33, 64, "flash_wgmma_any<bf16, 64>"),
    (torch.float16, 1, 8, 32, "flash_wgmma_any<f16, 32>"),
    (torch.float32, 33, 36, 64, "flash_tf32_any<f32, 64>"),
    (torch.float32, 100, 100, 128, "flash_tf32_any<f32, 128>"),
    (torch.bfloat16, 250, 256, 256, "flash_wgmma<bf16, 256>"),
    (torch.float32, 250, 252, 256, "flash_tf32_any<f32, 256>"),
    (torch.float16, 80, 80, 80, "flash_wgmma<f16, 80>"),
    (torch.bfloat16, 100, 100, 128, "flash_wgmma_any<bf16, 128>"),
    (torch.float16, 100, 100, 128, "flash_wgmma_any<f16, 128>"),
    (torch.bfloat16, 150, 150, 160, "flash_wgmma_any<bf16, 160>"),
    (torch.float16, 150, 150, 160, "flash_wgmma_any<f16, 160>"),
    (torch.bfloat16, 160, 160, 160, "flash_wgmma_any<bf16, 160>"),
    (torch.float16, 160, 160, 160, "flash_wgmma_any<f16, 160>"),
    (torch.bfloat16, 192, 192, 192, "flash_wgmma_any<bf16, 192>"),
    (torch.float16, 192, 192, 192, "flash_wgmma_any<f16, 192>"),
    (torch.bfloat16, 200, 200, 224, "flash_wgmma_any<bf16, 224>"),
    (torch.float16, 200, 200, 224, "flash_wgmma_any<f16, 224>"),
    (torch.bfloat16, 224, 224, 224, "flash_wgmma_any<bf16, 224>"),
    (torch.float16, 224, 224, 224, "flash_wgmma_any<f16, 224>"),
    (torch.float32, 150, 152, 256, "flash_tf32_any<f32, 256>"),
    (torch.float16, 90, 90, 96, "flash_wgmma_any<f16, 96>"),
    (torch.bfloat16, 170, 170, 192, "flash_wgmma_any<bf16, 192>"),
    (torch.bfloat16, 210, 216, 224, "flash_wgmma_any<bf16, 224>"),
    (torch.float16, 250, 256, 256, "flash_wgmma<f16, 256>")])
def test_flash_wrapper_rows_widths_and_dtype_codes(dtype, d, row, width, kernel):
    """The library gets the dtype code (float16: 2) and the row it reads:
    the head dim itself where its bytes are a multiple of 16 or it is a
    bf16 or float16 row of 33 to 192 (the caller's tensors, no copy, and
    the library's output returned as it is), else padded with zero
    columns (float32, and 16-bit rows above 192, still pad); the kernel is the one of the row's width
    where the row is a compiled width, else the ``_any`` kernel of the
    smallest width above it (flash_wgmma_any: every multiple of 32), and
    the output keeps D."""
    b, h, hkv, s = 1, 4, 2, 16
    q = torch.randn(b, h, s, d).to(dtype)
    k, v = torch.randn(b, hkv, s, d).to(dtype), torch.randn(b, hkv, s, d).to(dtype)
    assert flash_ops.row_elems(dtype, d) == row and flash_ops.width(dtype, d) == width
    assert flash_ops.kernel_label(dtype, d) == kernel
    lib = FakeFlashLib()
    out = flash_ops._launch(lib, q, k, v, causal=True, scale=d ** -0.5, window=None,
                            device=0, stream=0)
    (args,) = lib.calls
    assert args[1] == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    assert args[2] == row and args[7:10] == (b * h, s, h // hkv)
    assert args[10] == 1 and args[11] == pytest.approx(d ** -0.5)  # the unpadded D's scale
    assert (args[3] == q.data_ptr()) == (row == d)  # padded only where needed
    assert (args[4], args[5]) == (k.data_ptr(), v.data_ptr()) or row != d
    assert (out.data_ptr() == args[6]) == (row == d)  # nor is the output copied back
    assert out.shape == (b, h, s, d) and out.dtype == dtype and out.is_contiguous()


@pytest.mark.parametrize("dtype,group,d,kernel", [
    (torch.float16, 4, 128, "decode_split<f16, 128>"),
    (torch.float16, 48, 128, "decode_group<f16, 128, 3>"),
    (torch.bfloat16, 71, 64, "decode_group<bf16, 64, 3>"),
    (torch.bfloat16, 128, 64, "decode_group<bf16, 64, 4>"),
    (torch.float32, 71, 64, "decode_split<f32, 64>"),
    (torch.float16, 8, 33, "decode_split_any<f16, 64>"),
    (torch.bfloat16, 16, 1, "decode_group_any<bf16, 32, 1>"),
    (torch.float32, 4, 250, "decode_split_any<f32, 256>"),
    (torch.bfloat16, 4, 96, "decode_split_any<bf16, 128>")])
def test_decode_wrapper_dtype_widths_slices_and_no_cache_copy(dtype, group, d, kernel):
    """The library gets the float16 code, the head dim itself (the kernel
    picks its compiled width), the caches and q as they are (no copy at
    any head dim), the group whole (the library cuts it into slices of at
    most 64 heads) and the plan of split_plan, which counts a block per
    slice; the partials are sized for every q head."""
    b, s = 4, 4096
    q = torch.zeros((b, group, d), dtype=dtype)
    k = torch.zeros((b, 1, s, d), dtype=dtype)
    v = torch.zeros((b, 1, s, d), dtype=dtype)
    lengths = torch.full((b,), s, dtype=torch.int32)
    decode_ops._check_cuda(q, k, v, lengths)
    assert decode_ops.decode_kernel(dtype, group, d) == kernel
    lib = FakeDecodeLib()
    out = decode_ops._launch(lib, q, k, v, lengths, d ** -0.5, device=0, stream=0,
                             sms=H100_SMS)
    (args,) = lib.calls
    assert args[1] == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    assert args[2] == d
    assert (args[3], args[4], args[5]) == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    n_splits, chunk = decode_ops.split_plan(s, b, H100_SMS, group, d, dtype)
    assert args[10:16] == (b, 1, group, s, n_splits, chunk)
    if n_splits > 1:
        assert args[9] - args[8] == b * group * n_splits * d * 4
    assert out.shape == q.shape and out.dtype == dtype


@pytest.mark.parametrize("group,slices", [(64, (1, 64)), (65, (2, 33)), (71, (2, 36)),
                                          (128, (2, 64)), (129, (3, 43)), (256, (4, 64))])
def test_group_slices_and_their_plan(group, slices):
    """A group above 64 is cut into the fewest slices of at most 64 heads;
    the plan counts a block per slice, so the wide-group plan keeps at
    most one block an SM (Falcon-7B: 4 sequences x 2 slices)."""
    assert decode_ops.group_slices(group) == slices
    n_splits, chunk = decode_ops.split_plan(4096, 4, H100_SMS, group, 64)
    assert chunk % decode_ops.GROUP_ROWS == 0 and (n_splits - 1) * chunk < 4096
    assert n_splits == 1 or 4 * slices[0] * n_splits <= H100_SMS


@pytest.mark.parametrize("num_groups,windows", [(1024, (1, 1024)), (1025, (2, 513)),
                                                (3072, (3, 1024)), (4096, (4, 1024)),
                                                (65536, (64, 1024)), (262144, (256, 1024))])
def test_many_group_plan(num_groups, windows):
    """Above 1024 groups: windows of at most 1,024 groups (bins of 64 KB,
    three blocks an SM), rows partitioned by window in blocks of 2,048
    rows (a plan of n and G alone), about 396 bin blocks, each chunk's
    partials at most G entries; the launch passes the plan, pairs for
    every row, the bucket offsets and the partials.  Up to 1024 groups a
    call stays one launch of grid(n)."""
    assert ffa_ops.windows(num_groups) == windows
    assert ffa_ops.smem_bytes(num_groups) <= 232_448
    n = 2_796_308

    class Lib:
        def fused_filter_agg_tile_rows(self):
            return 2048

        def fused_filter_agg_launch(self, *args):
            self.args, self.entry = args, "one"
            return 0

        def fused_filter_agg_many_launch(self, *args):
            self.args, self.entry = args, "many"
            return 0

    lib = Lib()
    keys = torch.zeros(n, dtype=torch.int32)
    sums, counts = ffa_ops._launch(lib, keys, torch.zeros(n), torch.zeros(n), "ge", 0.0,
                                   num_groups, index=0, stream=0)
    assert sums.shape == counts.shape == (num_groups,)
    if num_groups <= ffa_ops.MAX_GROUPS:
        blocks, rows = ffa_ops.grid(n, 2048)
        assert lib.entry == "one" and lib.args[9:12] == (num_groups, blocks, rows)
        assert lib.args[14] - lib.args[13] == blocks * num_groups * 4
        return
    p = ffa_ops.many_plan(n, num_groups)
    assert lib.entry == "many" and lib.args[9:16] == (num_groups, *p)
    assert (p.windows, p.width) == windows and p.buckets == p.windows
    assert p.row_blocks * ffa_ops.PART_ROWS >= n > (p.row_blocks - 1) * ffa_ops.PART_ROWS
    assert p.windows * p.chunks <= ffa_ops.BIN_BLOCKS + p.windows
    assert lib.args[20] - lib.args[19] == p.chunks * num_groups * 4


def test_head_dim_257_is_refused():
    """Head dims above 256 were refused until both kernels took q.k across
    D in pieces (``flash_wgmma_wide`` in bf16 and float16, ``flash_tf32_wide``
    in float32, ``decode_wide``); now both wrappers' checks take 257, 512
    and 1024 in float32, bfloat16 and float16, as the Pallas kernels do,
    and refuse only a head dim of 0."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for d in (257, 512, 1024):
            q = torch.zeros((1, 2, 4, d), dtype=dtype)
            flash_ops._check_cuda(q, q, q, None)
            decode_ops._check_cuda(q[:, :, 0], q, q, torch.ones((1,), dtype=torch.int32))
            assert flash_ops.kernel_name(dtype, d) == (
                "flash_tf32_wide" if dtype == torch.float32 else "flash_wgmma_wide")
            narrow = "_narrow" if d * dtype.itemsize % 16 else ""  # rows not whole 16-byte pieces
            assert decode_ops.decode_kernel(dtype, 2, d).startswith(f"decode_wide{narrow}<")
        for d in (1, 2, 255, 256):
            small = torch.zeros((1, 2, 4, d), dtype=dtype)
            flash_ops._check_cuda(small, small, small, None)
            decode_ops._check_cuda(small[:, :, 0], small, small,
                                   torch.ones((1,), dtype=torch.int32))
        empty = torch.zeros((1, 2, 4, 0), dtype=dtype)
        with pytest.raises(ValueError, match="head dim"):
            flash_ops._check_cuda(empty, empty, empty, None)
        with pytest.raises(ValueError, match="head dim"):
            decode_ops._check_cuda(empty[:, :, 0], empty, empty,
                                   torch.ones((1,), dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_non_float_and_double_inputs_are_refused(dtype):
    q = torch.zeros((1, 2, 4, 64), dtype=dtype)
    with pytest.raises(TypeError):
        flash_ops._check_cuda(q, q, q, None)
    with pytest.raises(TypeError):
        decode_ops._check_cuda(q[:, :, 0], q, q, torch.ones((1,), dtype=torch.int32))


def test_the_libraries_refuse_unknown_dtype_codes():
    """Both C entry points take codes 0, 1 and 2 and refuse any other
    (the wrappers' tables), instead of reading every other code as bf16."""
    for ops in (flash_ops, decode_ops):
        src = ops.SOURCE.read_text()
        assert "dtype < 0 || dtype > 2" in src
        assert ops._DTYPES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ------------------------------------------------- phase 5's 16-bit rules
def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_domain", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,bits", [(torch.bfloat16, 7), (torch.float16, 10)])
def test_the_flash_rule_at_an_exact_route(dtype, bits):
    """Where the chunked route's error is exactly 0 (scale 0: p = 1, a
    mean of v), the 16-bit flash rule holds the kernel to one ulp of the
    type plus 1e-5 (close_enough), not to bit-exact sums; two ulps fail.
    Where the route has error, the rule is twice the route's, as before."""
    cs = _chip_smoke()
    want = torch.linspace(0.5, 0.9, 64).to(dtype)
    ulp = 2.0 ** (-1 - bits)  # an ulp in [0.5, 1)
    one_off = want.clone()
    one_off[7] = (want[7].float() + ulp).to(dtype)
    two_off = want.clone()
    two_off[7] = (want[7].float() + 2 * ulp).to(dtype)
    assert float((one_off.float() - want.float()).abs().max()) == ulp
    assert cs.flash_bf16_close(torch, one_off, want, want.clone())[0]
    assert not cs.flash_bf16_close(torch, two_off, want, want.clone())[0]
    # the route with an error of 2 ulps at one element: the rule is twice it
    yard = want.clone()
    yard[3] = (want[3].float() + 2 * ulp).to(dtype)
    assert cs.flash_bf16_close(torch, two_off, want, yard)[0]
    four_off = want.clone()
    four_off[9] = (want[9].float() + 5 * ulp).to(dtype)
    assert not cs.flash_bf16_close(torch, four_off, want, yard)[0]
    assert cs.close_enough(torch, one_off, want) and not cs.close_enough(torch, two_off, want)


def test_kernel_labels_name_float16():
    """ptxas's mangled float16 instantiations read as chip_smoke's kernels
    line and the wrappers name them."""
    cs = _chip_smoke()
    assert cs.kernel_label("_ZN12_GLOBAL__N_111flash_wgmmaI6__halfLi128EEEv14CUtensorMap_st"
                           "S1_S1_PS1_iiiifi") == "flash_wgmma<f16, 128>"
    assert cs.kernel_label("_ZN12_GLOBAL__N_112decode_splitI6__halfLi128EEEvPKT_") == \
        "decode_split<f16, 128>"
    assert cs.kernel_label("_ZN12_GLOBAL__N_112decode_groupI6__halfLi64ELi3EEEvPKT_") == \
        "decode_group<f16, 64, 3>"
    assert cs.kernel_label("_ZN52_GLOBAL__N__48c8a485_19_fused_filter_agg_cu_6f2cae11"
                           "14merge_partialsEPKfPKiiiPfS4_") == "merge_partials"
    assert flash_ops.kernel_label(torch.float16, 128) == "flash_wgmma<f16, 128>"
    assert decode_ops.decode_kernel(torch.float16, 4, 128) == "decode_split<f16, 128>"
