"""Port's fused_filter_agg wrapper (CPU tensors) vs the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as the reference's own tests run
it.  Counts and integer-valued sums must match exactly; float sums to
rtol=atol=1e-5 (the reference's tolerance: f32 sums in another order).
On CPU tensors the wrapper takes the plain version, so none of these
launch the CUDA kernel (chip_smoke.py holds the kernel to the plain
version on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_filter_agg import fused_filter_agg as jax_ffa
from repro.kernels.fused_filter_agg import fused_filter_agg_ref as jax_ffa_ref
from repro_torch.kernels.fused_filter_agg import fused_filter_agg, fused_filter_agg_ref, ops

torch.set_num_threads(1)  # tiny tensors: extra threads only contend


def make_inputs(n, num_groups, rng, dtype=np.float32):
    return (
        rng.integers(0, num_groups, n).astype(np.int32),
        rng.standard_normal(n).astype(dtype),
        (rng.random(n) * 100).astype(dtype),
    )


def both(keys, vals, filt, **kw):
    """(port sums, port counts, jax sums, jax counts) as numpy."""
    got_s, got_c = fused_filter_agg(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(filt), **kw
    )
    exp_s, exp_c = jax_ffa(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(filt), interpret=True, **kw
    )
    assert got_s.dtype == torch.float32 and got_c.dtype == torch.float32
    return got_s.numpy(), got_c.numpy(), np.asarray(exp_s), np.asarray(exp_c)


@pytest.mark.parametrize("n", [128, 1024, 1000, 4096, 5000])
@pytest.mark.parametrize("num_groups", [64, 256, 1000])
def test_shapes_sweep_vs_pallas(n, num_groups, rng):
    keys, vals, filt = make_inputs(n, num_groups, rng)
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt, op="ge", threshold=50.0, num_groups=num_groups
    )
    np.testing.assert_allclose(got_s, exp_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c, exp_c)


@pytest.mark.parametrize("op", ["ge", "gt", "le", "lt", "eq", "ne"])
def test_ops_sweep_vs_pallas(op, rng):
    keys, vals, filt = make_inputs(2048, 128, rng)
    filt = np.round(filt)  # make eq/ne meaningful
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt, op=op, threshold=42.0, num_groups=128
    )
    np.testing.assert_allclose(got_s, exp_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c, exp_c)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_int_and_float_values_vs_pallas(dtype, rng):
    keys = rng.integers(0, 64, 1024).astype(np.int32)
    vals = rng.integers(-5, 5, 1024).astype(dtype)
    filt = rng.integers(0, 10, 1024).astype(np.float32)
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt, op="gt", threshold=4.0, num_groups=64
    )
    # integer-valued sums are exact in f32 at this size: no tolerance
    np.testing.assert_array_equal(got_s, exp_s)
    np.testing.assert_array_equal(got_c, exp_c)


def test_int32_filter_column_compares_in_f32(rng):
    """The engine feeds int32 filter columns as they are; the kernel and
    its plain version compare them in float32, as JAX's astype does."""
    keys = rng.integers(0, 16, 3000).astype(np.int32)
    vals = rng.integers(0, 9, 3000).astype(np.int32)
    filt = rng.integers(17900, 18100, 3000).astype(np.int32)
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt.astype(np.float32), op="ge", threshold=17987.0, num_groups=16
    )
    int_s, int_c = fused_filter_agg(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(filt),
        op="ge", threshold=17987.0, num_groups=16,
    )
    np.testing.assert_array_equal(int_s.numpy(), exp_s)
    np.testing.assert_array_equal(int_c.numpy(), exp_c)
    np.testing.assert_array_equal(got_s, exp_s)


def test_empty_selection(rng):
    keys, vals, filt = make_inputs(512, 128, rng)
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt, op="ge", threshold=1e9, num_groups=128
    )
    assert got_s.sum() == 0 and got_c.sum() == 0
    np.testing.assert_array_equal(got_c, exp_c)


def test_out_of_range_keys_dropped_like_the_pallas_kernel(rng):
    """Keys -1 and >= G contribute nothing, in the port and in the JAX
    kernel (its one-hot matches no group lane for them)."""
    keys = rng.integers(0, 64, 3000).astype(np.int32)
    keys[::7] = -1
    keys[3::11] = 64
    keys[5::13] = 1000
    vals = rng.integers(1, 9, 3000).astype(np.float32)
    filt = (rng.random(3000) * 100).astype(np.float32)
    got_s, got_c, exp_s, exp_c = both(
        keys, vals, filt, op="ge", threshold=30.0, num_groups=64
    )
    np.testing.assert_array_equal(got_s, exp_s)
    np.testing.assert_array_equal(got_c, exp_c)
    in_range = (keys >= 0) & (keys < 64) & (filt >= 30.0)
    assert got_c.sum() == in_range.sum()


def test_jax_oracle_folds_minus_one_into_last_group(rng):
    """Pins down a discrepancy inside the JAX package: its jnp oracle
    (``ref.py``: ``.at[keys].add(..., mode="drop")``) wraps key -1 to group
    G-1 instead of dropping it, while its Pallas kernel drops it.  The
    port follows the kernel."""
    G = 32
    keys = rng.integers(0, G, 2000).astype(np.int32)
    keys[::5] = -1
    vals = np.ones(2000, np.float32)
    filt = np.ones(2000, np.float32)
    kw = dict(op="ge", threshold=0.5, num_groups=G)
    _, oracle_c = jax_ffa_ref(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(filt), **kw)
    got_s, got_c, _, kernel_c = both(keys, vals, filt, **kw)
    minus_one = int((keys == -1).sum())
    oracle_c, kernel_c = np.asarray(oracle_c), np.asarray(kernel_c)
    assert oracle_c[G - 1] == kernel_c[G - 1] + minus_one
    np.testing.assert_array_equal(oracle_c[: G - 1], kernel_c[: G - 1])
    np.testing.assert_array_equal(got_c, kernel_c)


def test_plain_version_matches_wrapper_on_cpu(rng):
    keys, vals, filt = make_inputs(3000, 100, rng)
    args = [torch.from_numpy(a) for a in (keys, vals, filt)]
    kw = dict(op="lt", threshold=25.0, num_groups=100)
    s1, c1 = fused_filter_agg(*args, **kw)
    s2, c2 = fused_filter_agg_ref(*args, **kw)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)


def test_launch_counter_does_not_move_on_cpu(rng):
    keys, vals, filt = make_inputs(1024, 64, rng)
    before = ops.LAUNCHES
    fused_filter_agg(
        torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(filt),
        op="ge", threshold=50.0, num_groups=64,
    )
    assert ops.LAUNCHES == before


def _bad_inputs(case):
    keys = torch.zeros(16, dtype=torch.int32)
    vals = torch.zeros(16, dtype=torch.float32)
    filt = torch.zeros(16, dtype=torch.float32)
    kw = dict(op="ge", threshold=0.0, num_groups=8)
    if case == "int64-keys":
        keys = keys.long()
    elif case == "float64-values":
        vals = vals.double()
    elif case == "bool-filter":
        filt = filt.bool()
    elif case == "2d":
        keys = keys.reshape(4, 4)
    elif case == "non-contiguous":
        vals = torch.zeros(32, dtype=torch.float32)[::2]
    elif case == "ragged":
        filt = filt[:15]
    elif case == "bad-op":
        kw["op"] = "between"
    elif case == "no-groups":
        kw["num_groups"] = 0
    elif case == "numpy":
        vals = vals.numpy()
    return (keys, vals, filt), kw


@pytest.mark.parametrize("case", [
    "int64-keys", "float64-values", "bool-filter", "2d", "non-contiguous",
    "ragged", "bad-op", "no-groups", "numpy",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, kw = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError)):
        fused_filter_agg(*args, **kw)


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 8192, 8193, 1_000_000, 2**23, 2**23 + 1000, 2**26])
def test_launch_grid_covers_rows_and_depends_on_n_only(n):
    tile = 2048
    blocks, rows = ops.grid(n, tile)
    assert 1 <= blocks <= ops.MAX_BLOCKS
    assert rows % tile == 0 and rows > 0
    assert blocks * rows >= n
    assert (blocks - 1) * rows < max(n, 1)  # no block starts past the end
    assert ops.grid(n, tile) == (blocks, rows)
