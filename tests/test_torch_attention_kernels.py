"""The port's flash_attention and decode_attention wrappers (CPU tensors)
against the JAX package's Pallas kernels in interpret mode.

On CPU tensors the wrappers take the kernels' plain versions, so none of
these launch a CUDA kernel (chip_smoke.py holds the kernels to the plain
versions on the card).  Shapes mirror tests/test_kernels_attention.py.

Tolerances: float32 to rtol=atol=1e-5 (float32 sums in another order:
one softmax over the row against the Pallas kernel's online softmax over
blocks); bfloat16 outputs within one bf16 ulp of the Pallas output (both
compute in float32 from the same bf16 inputs and round once at the end).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.decode_attention import decode_attention_ref as jax_decode_oracle
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jax_attn
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as port_attn

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

F32 = dict(rtol=1e-5, atol=1e-5)


def to_torch(x: np.ndarray, bf16: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if bf16 else t


def to_jax(x: np.ndarray, bf16: bool = False):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def assert_within_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger magnitude."""
    got, want = as_f32(got), as_f32(want)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


def qkv(rng, b, h, hkv, s, d):
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def flash_both(q, k, v, bf16=False, **kw):
    got = flash_attention(*(to_torch(x, bf16) for x in (q, k, v)), **kw)
    want = jax_flash(*(to_jax(x, bf16) for x in (q, k, v)), interpret=True, **kw)
    return got, want


# ------------------------------------------------------------------ flash
@pytest.mark.parametrize(
    "b,h,hkv,s,d",
    [
        (1, 2, 2, 128, 32),   # MHA
        (1, 4, 2, 128, 32),   # GQA 2:1
        (2, 4, 1, 256, 64),   # MQA
        (1, 2, 2, 192, 32),   # seq not multiple of default blocks
    ],
)
def test_flash_causal_shapes_vs_pallas(b, h, hkv, s, d, rng):
    got, want = flash_both(*qkv(rng, b, h, hkv, s, d), causal=True, block_q=64, block_k=64)
    assert got.shape == (b, h, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_noncausal_vs_pallas(rng):
    got, want = flash_both(*qkv(rng, 1, 2, 2, 128, 32), causal=False, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [32, 64, 100])
def test_flash_sliding_window_vs_pallas(window, rng):
    got, want = flash_both(*qkv(rng, 1, 2, 1, 256, 32), causal=True, window=window,
                           block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_noncausal_window_vs_pallas(rng):
    got, want = flash_both(*qkv(rng, 1, 4, 2, 128, 32), causal=False, window=48,
                           block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_bf16_vs_pallas(rng):
    got, want = flash_both(*qkv(rng, 1, 4, 2, 128, 32), bf16=True, causal=True,
                           block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got, want)


def test_flash_block_sizes_change_no_result(rng):
    """The block arguments only fix the S % block contract."""
    q, k, v = (to_torch(x) for x in qkv(rng, 1, 2, 2, 256, 32))
    a = flash_attention(q, k, v, block_q=64, block_k=64)
    b = flash_attention(q, k, v, block_q=128, block_k=32)
    assert torch.equal(a, b)


def test_flash_seq_not_divisible_by_block_raises_like_jax(rng):
    q, k, v = qkv(rng, 1, 2, 2, 192, 32)
    with pytest.raises(AssertionError):
        jax_flash(*(to_jax(x) for x in (q, k, v)), block_q=128, interpret=True)
    with pytest.raises(AssertionError):
        flash_attention(*(to_torch(x) for x in (q, k, v)), block_q=128)


def test_flash_default_blocks_take_short_sequences(rng):
    """bq = min(block_q, S): a 20-token prompt passes with the defaults."""
    got, want = flash_both(*qkv(rng, 1, 4, 2, 20, 32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_plain_version_is_the_wrapper_on_cpu(rng):
    q, k, v = (to_torch(x) for x in qkv(rng, 1, 4, 2, 64, 32))
    before = flash_ops.LAUNCHES
    assert torch.equal(flash_attention(q, k, v, window=16), attention_ref(q, k, v, window=16))
    assert flash_ops.LAUNCHES == before  # CPU tensors never launch


# ----------------------------------------------------------------- decode
def decode_inputs(rng, b, h, hkv, s, d):
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


def decode_both(q, k, v, lengths, bf16=False, **kw):
    got = decode_attention(*(to_torch(x, bf16) for x in (q, k, v)),
                           torch.from_numpy(lengths), **kw)
    want = jax_decode(*(to_jax(x, bf16) for x in (q, k, v)), jnp.asarray(lengths),
                      interpret=True, **kw)
    return got, want


@pytest.mark.parametrize(
    "b,h,hkv,s,d",
    [
        (1, 2, 2, 256, 32),
        (2, 4, 2, 512, 64),
        (3, 4, 1, 384, 32),
    ],
)
def test_decode_shapes_vs_pallas(b, h, hkv, s, d, rng):
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    got, want = decode_both(*decode_inputs(rng, b, h, hkv, s, d), lengths, block_s=128)
    assert got.shape == (b, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_ragged_lengths_gqa_vs_pallas(rng):
    s = 256
    lengths = np.array([1, s - 1, s, 77], np.int32)
    got, want = decode_both(*decode_inputs(rng, 4, 8, 2, s, 64), lengths, block_s=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_full_cache_vs_pallas(rng):
    lengths = np.full((2,), 256, np.int32)
    got, want = decode_both(*decode_inputs(rng, 2, 2, 2, 256, 32), lengths, block_s=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_tiny_length_is_the_first_value(rng):
    q, k, v = decode_inputs(rng, 1, 2, 2, 128, 32)
    got, want = decode_both(q, k, v, np.ones((1,), np.int32), block_s=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got[0, 0].numpy(), v[0, 0, 0], **F32)


def test_decode_bf16_vs_pallas(rng):
    lengths = np.array([256, 100], np.int32)
    got, want = decode_both(*decode_inputs(rng, 2, 4, 2, 256, 32), lengths, bf16=True,
                            block_s=128)
    assert got.dtype == torch.bfloat16
    assert_within_bf16_ulp(got, want)


def test_decode_length_zero_is_the_mean_of_the_cache(rng):
    """The Pallas kernel masks with -1e30, so at length 0 every weight is
    exp(0) = 1 and it returns the mean of all S cache rows; the port
    follows the kernel.  The JAX oracle masks with -inf and returns NaN
    (ROADMAP.md §3)."""
    q, k, v = decode_inputs(rng, 2, 4, 2, 128, 32)
    lengths = np.array([0, 5], np.int32)
    got, want = decode_both(q, k, v, lengths, block_s=64)
    mean = np.repeat(v[0].mean(axis=1), 2, axis=0)  # (H, D): kv head h // group
    np.testing.assert_allclose(np.asarray(want)[0], mean, **F32)
    np.testing.assert_allclose(got[0].numpy(), mean, **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = np.asarray(jax_decode_oracle(*(jnp.asarray(x) for x in (q, k, v)),
                                          jnp.asarray(lengths)))
    assert np.isnan(oracle[0]).all() and np.isfinite(oracle[1]).all()


def test_decode_cache_not_divisible_by_block_raises_like_jax(rng):
    q, k, v = decode_inputs(rng, 1, 2, 2, 384, 32)
    lengths = np.array([10], np.int32)
    with pytest.raises(AssertionError):
        jax_decode(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(lengths),
                   block_s=256, interpret=True)
    with pytest.raises(AssertionError):
        decode_attention(*(to_torch(x) for x in (q, k, v)), torch.from_numpy(lengths),
                         block_s=256)


def test_decode_plain_version_is_the_wrapper_on_cpu(rng):
    q, k, v = (to_torch(x) for x in decode_inputs(rng, 2, 4, 2, 64, 32))
    lengths = torch.tensor([3, 64], dtype=torch.int32)
    before = decode_ops.LAUNCHES
    assert torch.equal(decode_attention(q, k, v, lengths),
                       decode_attention_ref(q, k, v, lengths))
    assert decode_ops.LAUNCHES == before  # CPU tensors never launch


# ------------------------------------------- the decode-window divergence
def _danube_decode(port_flag: bool, rng):
    """attention.decode_step on h2o-danube's smoke config (window 16) at
    lengths past the window, JAX and port, with the same weights."""
    import jax

    jcfg = dataclasses.replace(
        jax_smoke_config("h2o_danube_3_4b").attention_config(),
        use_flash_kernel=port_flag, compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(
        get_smoke_config("h2o_danube_3_4b").attention_config(),
        use_flash_kernel=port_flag, compute_dtype=torch.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jax_attn.init_attention(jax.random.PRNGKey(3), jcfg))
    b, s_max = 2, 64
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((b, jcfg.n_kv_heads, s_max, jcfg.d_head)).astype(np.float32)
    v = rng.standard_normal((b, jcfg.n_kv_heads, s_max, jcfg.d_head)).astype(np.float32)
    lengths = np.array([20, 40], np.int32)
    want, _ = jax_attn.decode_step(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg, jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(lengths))
    got, _ = port_attn.decode_step(
        jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params), pcfg,
        torch.from_numpy(x),
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},
        torch.from_numpy(lengths))
    return got.numpy(), np.asarray(want)


def test_decode_window_divergence_kept_branch_by_branch(rng):
    """With a window, the kernel branch ignores it and the reference
    branch applies it (JAX attention.py:271-282); each port branch equals
    its JAX branch, and the two branches differ."""
    got_k, want_k = _danube_decode(True, np.random.default_rng(7))
    got_r, want_r = _danube_decode(False, np.random.default_rng(7))
    np.testing.assert_allclose(got_k, want_k, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-4, atol=1e-4)
    assert np.abs(want_k - want_r).max() > 1e-2
