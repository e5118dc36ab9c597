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


# ------------------------------------------------- the one-launch kernel
class FakeLib:
    """Records the wrapper's call into the kernel library."""

    def __init__(self):
        self.calls = []

    def fused_filter_agg_tile_rows(self):
        return 2048

    def fused_filter_agg_launch(self, *args):
        self.calls.append(args)
        return 0


def fake_launch(keys, vals, filt, num_groups, stream=0, op="ge"):
    lib = FakeLib()
    out = ops._launch(lib, keys, vals, filt, op, 1.5, num_groups, index=0, stream=stream)
    return lib.calls[0], out


@pytest.mark.parametrize("n", [0, 1, 4095, 2_796_308, 2**23 + 3])
def test_plan_is_a_function_of_n_alone(n):
    """The grid the wrapper launches is grid(n): the same for every G,
    every value dtype and every card (no SM count enters it)."""
    keys = torch.zeros(n, dtype=torch.int32)
    plans = set()
    for G in (1, 64, 1024):
        for vals in (torch.zeros(n, dtype=torch.int32), torch.zeros(n)):
            args, _ = fake_launch(keys, vals, torch.zeros(n), G)
            plans.add((args[10], args[11]))
            assert args[9] == G and args[6] == n
    assert plans == {ops.grid(n, 2048)}


def test_shared_memory_fits_the_card_for_every_group_count():
    """8 warps x G x (sum, count) of bins, the lane values and the last
    block's slices: within the 227 KB a block may use at every G, above
    the 48 KB that needs the opt-in only at large G.  Up to MAX_GROUPS
    (1024) the kernel is one launch with every group in a block's bins;
    above it the bins hold one window of at most WINDOW groups, so any G
    fits."""
    for G in range(1, ops.MAX_GROUPS + 1):
        assert ops.smem_bytes(G) <= 232_448
        assert ops.windows(G) == (1, G)
    for G in list(range(ops.MAX_GROUPS + 1, 4 * ops.WINDOW, 7)) + [65_536, 1_000_003]:
        n, widest = ops.windows(G)
        assert ops.smem_bytes(G) <= 232_448 and widest <= ops.WINDOW
        assert (n - 1) * widest < G <= n * widest
    assert ops.smem_bytes(64) < 48 * 1024 < ops.smem_bytes(ops.MAX_GROUPS)
    assert ops.MAX_GROUPS == 1024


def test_route_cap_is_the_kernel_cap_and_the_jax_routes():
    from repro.engine.route import DEFAULT_MAX_GROUPS as JAX_MAX_GROUPS
    from repro_torch.engine.route import DEFAULT_MAX_GROUPS

    assert DEFAULT_MAX_GROUPS == JAX_MAX_GROUPS == ops.MAX_GROUPS


def test_launch_passes_one_ticket_per_stream_and_partials_of_the_plan():
    n, G = 9000, 65
    keys, vals, filt = torch.zeros(n, dtype=torch.int32), torch.zeros(n), torch.zeros(n)
    a, (sums, counts) = fake_launch(keys, vals, filt, G, stream=11)
    b, _ = fake_launch(keys, vals, filt, G, stream=11)
    c, _ = fake_launch(keys, vals, filt, G, stream=12)
    blocks = ops.grid(n, 2048)[0]
    ticket = ops._tickets[(0, 11)]
    assert a[15] == b[15] == ticket.data_ptr() and c[15] != a[15]  # per stream, kept
    assert int(ticket.item()) == 0 and ticket.dtype == torch.int32
    assert a[14] - a[13] == blocks * G * 4  # float32 sums, then int32 counts
    assert sums.shape == counts.shape == (G,) and sums.dtype == counts.dtype == torch.float32
    assert (a[16], a[17]) == (sums.data_ptr(), counts.data_ptr())
    assert a[12] == 0b111  # all three columns start on a 16-byte boundary


def test_tickets_and_launch_count_under_threads(monkeypatch):
    """Pipeline stages launch from executor threads: many threads at once
    asking for the tickets of many streams get one tensor per (device,
    stream), and no launch count is lost.  The switch interval is cut and
    the ticket's allocation yields, so an unguarded check-then-create
    would be interleaved."""
    import sys
    import threading
    import time
    from types import SimpleNamespace

    def yielding_zeros(*a, **kw):
        time.sleep(1e-4)  # let another thread in between check and store
        return torch.zeros(*a, **kw)

    monkeypatch.setattr(ops, "torch", SimpleNamespace(zeros=yielding_zeros, int32=torch.int32))
    keys = [(5, s) for s in range(1000, 1100)]  # each made once, by a race
    n_threads, per_thread = 32, 100
    got = {k: set() for k in keys}
    barrier = threading.Barrier(n_threads)
    before, interval = ops.LAUNCHES, sys.getswitchinterval()

    def work():
        barrier.wait(timeout=60)
        for k in keys[:per_thread]:
            got[k].add(id(ops._ticket(*k, torch.device("cpu"))))
            ops._count_launch()

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        launched = ops.LAUNCHES - before
        ops.LAUNCHES = before
        for k in keys:
            ops._tickets.pop(k, None)
    assert launched == n_threads * per_thread
    assert all(len(ids) == 1 for ids in got.values()), got


@pytest.mark.parametrize("offs", [(1, 1, 1), (2, 2, 2), (3, 3, 3), (1, 2, 3), (0, 3, 0)])
def test_misaligned_views_go_through_the_wrapper(offs, rng):
    """Views that start 1-3 elements past a 16-byte boundary: the launch
    says which columns are aligned, and on the CPU the wrapper's result
    equals the Pallas kernel's on the same rows."""
    n, G = 5000, 64
    keys, vals, filt = make_inputs(n + 3, G, rng)
    base = [torch.from_numpy(a) for a in (keys, vals, filt)]
    view = [t[o:o + n] for t, o in zip(base, offs)]
    args, _ = fake_launch(*view, G)
    assert args[12] == sum(1 << i for i, o in enumerate(offs) if o == 0)
    got_s, got_c = fused_filter_agg(*view, op="ge", threshold=50.0, num_groups=G)
    exp_s, exp_c = jax_ffa(*(jnp.asarray(t.numpy()) for t in view), op="ge", threshold=50.0,
                           num_groups=G, interpret=True)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(exp_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(exp_c))


@pytest.mark.parametrize("case,match", [
    ("int64-keys", "keys must be int32"),
    ("float64-values", "values must be int32 or float32"),
    ("bool-filter", "filter_vals must be int32 or float32"),
    ("2d", "must be 1-D"),
    ("non-contiguous", "must be contiguous"),
    ("ragged", "has 15 rows"),
    ("bad-op", "op must be one of"),
    ("no-groups", "num_groups must be positive"),
    ("numpy", "must be a torch.Tensor"),
])
def test_wrapper_error_messages(case, match):
    args, kw = _bad_inputs(case)
    with pytest.raises((TypeError, ValueError), match=match):
        fused_filter_agg(*args, **kw)


def emulate_kernel(keys, vals, filt, op, threshold, G, tile=2048, threads=256):
    """The kernel's order of float additions, in numpy float32: block b
    of grid(n) walks its tiles; in each, quad qd, row j of the quad, warp
    w, its 32 lanes' rows; the lanes of one key add in ascending lane
    order into the warp's bin; the warps' bins add in warp order into the
    block's partial; the last block adds the partials in block order, in
    max(1, 256 // G) slices of blocks, then the slices in order."""
    n = len(keys)
    keep = np.asarray(ref_mask(filt, op, threshold)) & (keys >= 0) & (keys < G)
    key = np.where(keep, keys, -1)
    v = vals.astype(np.float32)
    blocks, rows = ops.grid(n, tile)
    part_s = np.zeros((blocks, G), np.float32)
    part_c = np.zeros((blocks, G), np.int64)
    lanes = np.arange(32)
    for b in range(blocks):
        bin_s = np.zeros((8, G), np.float32)
        bin_c = np.zeros((8, G), np.int64)
        end = min(n, (b + 1) * rows)
        for base in range(b * rows, end, tile):
            for qd in range(2):
                for j in range(4):
                    for w in range(8):
                        r = base + (qd * threads + w * 32 + lanes) * 4 + j
                        k = np.where(r < end, key[np.minimum(r, max(n - 1, 0))], -1)
                        for g in sorted(set(k[k >= 0].tolist())):
                            s = np.float32(0)
                            for lane in lanes[k == g]:
                                s = np.float32(s + v[r[lane]])
                            bin_s[w, g] = np.float32(bin_s[w, g] + s)
                            bin_c[w, g] += int((k == g).sum())
        for w in range(8):
            part_s[b] = (part_s[b] + bin_s[w]).astype(np.float32)
            part_c[b] += bin_c[w]
    slices = max(1, threads // G)
    sums = np.zeros(G, np.float32)
    counts = np.zeros(G, np.int64)
    for sl in range(slices):
        s = np.zeros(G, np.float32)
        for p in range(blocks * sl // slices, blocks * (sl + 1) // slices):
            s = (s + part_s[p]).astype(np.float32)
            counts += part_c[p]
        sums = (sums + s).astype(np.float32)
    return sums, counts.astype(np.float32)


def ref_mask(filt, op, threshold):
    from repro_torch.kernels.fused_filter_agg.ref import _mask

    return _mask(torch.from_numpy(filt), op, threshold).numpy()


@pytest.mark.parametrize("n,G", [(0, 64), (1, 1), (4095, 63), (9000, 65), (9000, 300),
                                 (20000, 1), (6000, 1024)])
def test_kernel_order_of_sums_matches_pallas(n, G, rng):
    """The one-launch kernel's algorithm (``emulate_kernel``) on the CPU:
    counts exact and float sums within 1e-5 of the Pallas kernel; with
    integer values the sums are exact too.  No rows (the Pallas kernel
    takes none) give zeros, as the plain version does."""
    keys = rng.integers(-1, G + 1, n).astype(np.int32)
    filt = (rng.random(n) * 100).astype(np.float32)
    for vals in (rng.standard_normal(n).astype(np.float32),
                 rng.integers(-50, 51, n).astype(np.float32)):
        got_s, got_c = emulate_kernel(keys, vals, filt, "ge", 30.0, G)
        if n == 0:
            exp_s, exp_c = fused_filter_agg_ref(
                *(torch.from_numpy(a) for a in (keys, vals, filt)),
                op="ge", threshold=30.0, num_groups=G)
            exp_s, exp_c = exp_s.numpy(), exp_c.numpy()
        else:
            exp_s, exp_c = jax_ffa(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(filt),
                                   op="ge", threshold=30.0, num_groups=G, interpret=True)
        np.testing.assert_array_equal(got_c, np.asarray(exp_c))
        np.testing.assert_allclose(got_s, np.asarray(exp_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_s, np.asarray(exp_s))  # integer values: exact


# ------------------------------------------- more than 1,024 groups
def emulate_many(keys, vals, filt, op, threshold, G, threads=256, tile=2048):
    """The three launches above MAX_GROUPS (fused_filter_agg.cu's header),
    in numpy float32, with their layout: partition block b stages rows
    [PART_ROWS b, ..); warp w ranks its lanes' rows step by step (quad qd,
    row j, lanes ascending) within their bucket; the block writes each
    pair at its region's bucket offset + the warps' counts before w + the
    rank.  Bin block (window, chunk) takes the chunk's row blocks in order,
    SEG_BATCH at a time, whose segments of the window's bucket make one
    sequence of pairs, cut into units of 32 consecutive pairs, warp k
    taking a batch's units k, k + 8, ...; in a unit the lanes of one group
    add in
    ascending lane order into the warp's bin; the warps' bins add in warp
    order; merge_partials adds the chunks' partials in order.  Returns
    (sums, counts, offsets, pair keys)."""
    n = len(keys)
    p = ops.many_plan(n, G)
    rows_a_block = ops.PART_ROWS
    keep = np.asarray(ref_mask(filt, op, threshold)) & (keys >= 0) & (keys < G)
    bucket = np.where(keep, keys // p.width // p.per_bucket, -1)
    v = vals.astype(np.float32)
    pair_key = np.full(n, -7, np.int64)
    pair_val = np.zeros(n, np.float32)
    offsets = np.zeros((p.row_blocks, p.buckets + 1), np.int64)
    lanes = np.arange(32)
    for b in range(p.row_blocks):
        begin, end = b * rows_a_block, min(n, (b + 1) * rows_a_block)
        cnt = np.zeros((8, p.buckets), np.int64)
        placed = []
        for base in range(begin, end, tile):
            for qd in range(2):
                for j in range(4):
                    for w in range(8):
                        for r in base + (qd * threads + w * 32 + lanes) * 4 + j:
                            if r < end and bucket[r] >= 0:
                                placed.append((bucket[r], w, cnt[w, bucket[r]], r))
                                cnt[w, bucket[r]] += 1
        before = np.cumsum(cnt, axis=0) - cnt  # the warps' counts before w
        offsets[b, 1:] = np.cumsum(cnt.sum(axis=0))
        for u, w, pos, r in placed:
            dst = begin + offsets[b, u] + before[w, u] + pos
            assert pair_key[dst] == -7  # every place taken once
            pair_key[dst], pair_val[dst] = keys[r], v[r]
    part_s = np.zeros((p.chunks, G), np.float32)
    part_c = np.zeros((p.chunks, G), np.int64)
    for c in range(p.chunks):
        b0, b1 = p.row_blocks * c // p.chunks, p.row_blocks * (c + 1) // p.chunks
        for win in range(p.windows):
            g0, u = win * p.width, win // p.per_bucket
            width = min(p.width, G - g0)
            bin_s = np.zeros((8, width), np.float32)
            bin_c = np.zeros((8, width), np.int64)
            for bb in range(b0, b1, ops.SEG_BATCH):
                seq = np.concatenate(
                    [b * rows_a_block + np.arange(offsets[b, u], offsets[b, u + 1])
                     for b in range(bb, min(bb + ops.SEG_BATCH, b1))] + [np.zeros(0, np.int64)])
                for k in range(-(-len(seq) // 32)):
                    w_unit = k % 8
                    ok = k * 32 + lanes < len(seq)
                    at = seq[np.minimum(k * 32 + lanes, max(len(seq) - 1, 0))]
                    key = np.where(ok, pair_key[at] - g0, -1)
                    key = np.where((key >= 0) & (key < width), key, -1)
                    for g in sorted(set(key[key >= 0].tolist())):
                        s = np.float32(0)
                        for lane in lanes[key == g]:
                            s = np.float32(s + pair_val[at[lane]])
                        bin_s[w_unit, g] = np.float32(bin_s[w_unit, g] + s)
                        bin_c[w_unit, g] += int((key == g).sum())
            for w in range(8):
                part_s[c, g0:g0 + width] = (part_s[c, g0:g0 + width] + bin_s[w]).astype(np.float32)
                part_c[c, g0:g0 + width] += bin_c[w]
    sums = np.zeros(G, np.float32)  # 8 slices of chunks in order, then the slices
    for sl in range(8):
        s = np.zeros(G, np.float32)
        for c in range(p.chunks * sl // 8, p.chunks * (sl + 1) // 8):
            s = (s + part_s[c]).astype(np.float32)
        sums = (sums + s).astype(np.float32)
    return sums, part_c.sum(axis=0).astype(np.float32), offsets, pair_key


@pytest.mark.parametrize("n,G", [(9000, 1025), (9000, 7000), (4097, 1_100_000), (0, 2000)])
def test_many_group_order_of_sums_matches_pallas(n, G, rng):
    """The partition and binning (``emulate_many``) on the CPU: every
    passing row placed once, the bucket offsets those of a count, counts
    exact, float sums within 1e-5 of the Pallas kernel, integer-valued sums
    exact.  1,100,000 groups take two windows a bucket (above WINDOW x
    MAX_BUCKETS)."""
    keys = rng.integers(-1, G + 1, n).astype(np.int32)
    if G > 10_000:  # crowd a few windows, so that buckets hold several groups
        keys = np.where(rng.random(n) < 0.7, keys % 20_000, keys).astype(np.int32)
    filt = (rng.random(n) * 100).astype(np.float32)
    p = ops.many_plan(n, G)
    assert (p.per_bucket > 1) == (G > ops.WINDOW * ops.MAX_BUCKETS)
    for vals in (rng.standard_normal(n).astype(np.float32),
                 rng.integers(-50, 51, n).astype(np.float32)):
        got_s, got_c, offsets, pair_key = emulate_many(keys, vals, filt, "ge", 30.0, G)
        keep = (filt >= 30.0) & (keys >= 0) & (keys < G)
        assert offsets[:, -1].sum() == keep.sum() == (pair_key != -7).sum()
        for b in range(p.row_blocks):
            rows = slice(b * ops.PART_ROWS, (b + 1) * ops.PART_ROWS)
            u = keys[rows][keep[rows]] // p.width // p.per_bucket
            assert np.array_equal(np.diff(offsets[b]), np.bincount(u, minlength=p.buckets))
        if n == 0:
            exp_s, exp_c = (t.numpy() for t in fused_filter_agg_ref(
                *(torch.from_numpy(a) for a in (keys, vals, filt)),
                op="ge", threshold=30.0, num_groups=G))
        elif G > 10_000:  # the Pallas kernel's one-hot over G is too large here
            exp_s, exp_c = (t.numpy() for t in fused_filter_agg_ref(
                *(torch.from_numpy(a) for a in (keys, vals, filt)),
                op="ge", threshold=30.0, num_groups=G))
        else:
            exp_s, exp_c = jax_ffa(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(filt),
                                   op="ge", threshold=30.0, num_groups=G, interpret=True)
        np.testing.assert_array_equal(got_c, np.asarray(exp_c))
        np.testing.assert_allclose(got_s, np.asarray(exp_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_s, np.asarray(exp_s))  # integer values: exact


class ManyLib(FakeLib):
    def fused_filter_agg_many_launch(self, *args):
        self.calls.append(args)
        return 0


#: Q2's rows (phase 2's query path) and, by group count, the plan, the
#: launches (kernel, blocks) and the scratch bytes
Q2_ROWS = 2_796_308
MANY_PLANS = {
    1025: ((1366, 2, 513, 2, 1, 198),
           [("partition_rows", 1366), ("bin_buckets", 396), ("merge_partials", 33)], 1_623_600),
    4096: ((1366, 4, 1024, 4, 1, 99),
           [("partition_rows", 1366), ("bin_buckets", 396), ("merge_partials", 128)],
           3_244_032),
    65536: ((1366, 64, 1024, 64, 1, 7),
            [("partition_rows", 1366), ("bin_buckets", 448), ("merge_partials", 2048)],
            3_670_016),
    262144: ((1366, 256, 1024, 256, 1, 2),
             [("partition_rows", 1366), ("bin_buckets", 512), ("merge_partials", 8192)],
             4_194_304),
}


@pytest.mark.parametrize("G", sorted(MANY_PLANS))
def test_many_group_plan_launches_and_scratch(G):
    """At Q2's rows: 2,048-row partition blocks, windows of at most 1,024
    groups, a bucket a window, about 396 bin blocks; scratch of 8 B a row
    of pairs, the bucket offsets and a chunk's partials; the wrapper passes
    that plan and scratch to the many-group entry point, and the outputs."""
    plan, launches, partial_bytes = MANY_PLANS[G]
    p = ops.many_plan(Q2_ROWS, G)
    assert tuple(p) == plan and ops.launch_sequence(Q2_ROWS, G) == launches
    assert ops.scratch_bytes(Q2_ROWS, G) == {
        "pairs": 8 * Q2_ROWS, "offsets": 4 * p.row_blocks * (p.buckets + 1),
        "partials": partial_bytes}
    assert ops.smem_bytes(G) <= 232_448
    lib = ManyLib()
    keys = torch.zeros(Q2_ROWS, dtype=torch.int32)
    sums, counts = ops._launch(lib, keys, torch.zeros(Q2_ROWS), torch.zeros(Q2_ROWS), "ge",
                               0.0, G, index=0, stream=0)
    (args,) = lib.calls
    assert args[6] == Q2_ROWS and args[9] == G and args[10:16] == plan
    assert args[16] == 0b111
    assert args[20] - args[19] == p.chunks * G * 4  # float32 sums, then int32 counts
    assert (args[21], args[22]) == (sums.data_ptr(), counts.data_ptr())
    assert sums.shape == counts.shape == (G,)


def test_many_group_entry_point_checks_the_plan():
    """The C entry point recomputes what it can of the plan and refuses a
    call that disagrees, instead of writing past the scratch."""
    src = ops.SOURCE.read_text()
    for needle in ("row_blocks != want_blocks", "width > kWindow", "buckets > kMaxBuckets",
                   "chunks > row_blocks", "num_groups <= kMaxGroups"):
        assert needle in src
    assert f"constexpr int kWindow = {ops.WINDOW};" in src
    assert f"constexpr int kMaxBuckets = {ops.MAX_BUCKETS};" in src
    assert "constexpr int kPartRows = kTileRows;" in src and ops.PART_ROWS == 2048
    assert f"constexpr int kSegBatch = {ops.SEG_BATCH};" in src
