"""Head dims above 256 in both attention kernels, checked on the CPU.

The Pallas kernels take any head dim; the port runs ``flash_wgmma_wide``
(bf16, float16), ``flash_tf32_wide`` (float32) and ``decode_wide`` above
256 (``chip_smoke.py`` phase 5 holds them to their plain versions on the
card).  Here:

* the port's plain versions (what the wrappers take on CPU tensors) at
  head dims 257, 320 and 576 against the Pallas kernels in interpret mode,
  in float32, bfloat16 and float16: within 1e-5 + 1e-5 |want| in float32
  and one ulp of the type plus 1e-5 in the 16-bit types (both compute in
  float32 and round once);
* an emulation of each wide kernel's plan against the Pallas kernel under
  the same rules: flash's blocks of 64 q rows and 512 output columns
  (two halves of 256), q.k over 64-column pieces split between the halves
  and summed, on wgmma in bf16 and float16 (64-key tiles, the lazy
  maximum, p as a hi + lo pair) and split-TF32 in float32 (32-key tiles,
  16-row warps, three products a pair); decode's chunks of
  ``split_plan`` (at most 512 rows), q.k summed over 64-column pieces, a
  softmax a chunk, p.v in slices of 512 bytes a row (bf16 and float16: p
  as a hi + lo pair, float16 at 2^15) and the combine, at lengths 0, 1,
  tile and chunk edges and S;
* the plans without a card: both wide kernels' shared memory within the
  227 KB a block may use at every head dim from 257 to 1,024 (it does not
  depend on the head dim), every output column in exactly one group, and
  the wrappers' launch arguments through stand-in libraries (the row, the
  dtype code, the 16-bit scale rewrite, the decode plan and its partials);
* both ``_check_cuda`` take head dims 257 to 1,024 in every dtype and
  refuse 0 (``tests/test_torch_domain.py::test_head_dim_257_is_refused``).
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from test_torch_flash_tf32 import product

torch.set_num_threads(1)  # small tensors: extra threads only contend

H100_SMS = 132
#: shared memory a block may use on the H100 (232,448 of the SM's 256 KB)
SMEM_LIMIT = 232_448
#: and an SM's blocks together (228 KB)
SM_SMEM = 233_472
WIDE_DIMS = (257, 320, 576)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
MASKS = ((True, None), (False, None), (True, 40))
FLASH_CU = flash_ops.SOURCE.read_text()
DECODE_CU = decode_ops.SOURCE.read_text()


def normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def both(x, name):
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def as_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(dtype)


def within_rule(got, want) -> bool:
    """Phase 5's rule (``chip_smoke.close_enough``)."""
    return chip_smoke.close_enough(torch, got, want)


# ------------------------------------------------ plain versions vs Pallas
@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_above_256_matches_pallas(name, d, causal, window, rng):
    b, h, hkv, s = 1, 4, 2, 64
    (qt, qj), (kt, kj), (vt, vj) = (both(normal(rng, b, n, s, d), name)
                                    for n in (h, hkv, hkv))
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jax_flash(qj, kj, vj, causal=causal, window=window, interpret=True,
                     block_q=32, block_k=32)
    assert got.dtype == qt.dtype and got.shape == (b, h, s, d)
    assert within_rule(got, as_torch(want, qt.dtype))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_decode_above_256_matches_pallas(name, d, rng):
    b, h, hkv, s = 4, 8, 2, 128
    (qt, qj), (kt, kj), (vt, vj) = (both(x, name) for x in (
        normal(rng, b, h, d), normal(rng, b, hkv, s, d), normal(rng, b, hkv, s, d)))
    lengths = np.array([0, 1, 65, s], np.int32)
    got = decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), interpret=True, block_s=64)
    assert got.dtype == qt.dtype and got.shape == (b, h, d)
    assert within_rule(got, as_torch(want, qt.dtype))


# -------------------------------------------------- the wide kernels' plans
def cu_int(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def emulate_flash_wide(q, k, v, *, causal, window):
    """The wide flash kernels' plans and arithmetic on the CPU.  A block
    takes a q tile of 64 rows and a group of 512 output columns
    (``wide_groups``), its two halves 256 columns each; a key tile's scores
    are the sum of two halves of q.k, each half the pieces of 64 columns it
    takes (pieces 0, 2, .. and 1, 3, ..), computed once a group.
    bfloat16 and float16 (``flash_wgmma_wide``): 64-key tiles, exact
    products and float32 sums, each half one chain; masks -inf; the online
    softmax with its maxima over the unscaled scores, a lazy maximum (it
    moves only past 2^8) and exp2 of the scaled differences; p.v as the pair
    hi = round(p s) + lo = round(p s - hi) in q's dtype (s = 2^7 in float16,
    1 in bf16) against v, scaled back in the finish.  float32
    (``flash_tf32_wide``): 32-key tiles walked by warps of 16 rows (a warp
    skips the tiles masked for all its rows), each piece's split-TF32
    products (three a pair, k split once) in accumulators of their own, masks
    -1e30 and -inf past S, the eager softmax, p.v split-TF32 (p and v
    split, three products a pair)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    ld = flash_ops.row_elems(q.dtype, d)
    f32 = q.dtype == torch.float32
    bq, bk = flash_ops.WIDE_ROWS, flash_ops.wide_keys(q.dtype)
    assert (bq, bk) == ((cu_int(FLASH_CU, "kXRows"), cu_int(FLASH_CU, "kXKeys")) if f32 else
                        (cu_int(FLASH_CU, "kGRows"), cu_int(FLASH_CU, "kGKeys")))
    piece = cu_int(FLASH_CU, "kXPiece" if f32 else "kGPiece")
    assert piece == flash_ops.WIDE_PIECE
    assert cu_int(FLASH_CU, "kXCols" if f32 else "kGCols") == flash_ops.WIDE_GROUP
    rows_a_warp = 16 if f32 else bq  # wgmma: a warpgroup takes the tile's rows
    pscale = 128.0 if q.dtype == torch.float16 else 1.0
    scale = 1.0 / d ** 0.5
    c = scale * math.log2(math.e)

    def pad(x):
        return torch.nn.functional.pad(x.to(torch.float32), (0, ld - d)).reshape(-1, s, ld)

    qs = pad(q)
    if f32:
        qs = qs * scale
    kf = pad(k.repeat_interleave(group, dim=1))
    vf = pad(v.repeat_interleave(group, dim=1))
    bh = b * h
    out = torch.empty(bh, s, ld, dtype=torch.float32)
    n_tiles = -(-s // bk)
    pieces = [range(w * piece, ld, 2 * piece) for w in (0, 1)]
    for c0, cols in flash_ops.wide_groups(q.dtype, d):
        for q0 in range(0, s, bq):
            hi = min((q0 + bq - 1) // bk + 1, n_tiles) if causal else n_tiles
            lo = max(int((q0 - window + 1) / bk), 0) if window else 0
            for r0 in range(q0, min(q0 + bq, s), rows_a_warp):
                n_r = rows_a_warp
                whi = min((r0 + n_r - 1) // bk + 1, hi) if causal else hi
                wlo = max(int((r0 - window + 1) / bk), lo) if window else lo
                rows = torch.arange(r0, r0 + n_r)
                qw = torch.zeros(bh, n_r, ld)
                qw[:, : min(n_r, s - r0)] = qs[:, r0:r0 + n_r]
                m = torch.full((bh, n_r, 1), -1e30)
                l = torch.zeros((bh, n_r, 1))
                o = torch.zeros((bh, n_r, cols))
                for j in range(wlo, whi):
                    keys = torch.arange(j * bk, (j + 1) * bk)
                    kt = torch.zeros(bh, bk, ld)
                    vt = torch.zeros(bh, bk, cols)
                    valid = min(bk, s - j * bk)
                    kt[:, :valid] = kf[:, j * bk:j * bk + valid]
                    vt[:, :valid] = vf[:, j * bk:j * bk + valid, c0:c0 + cols]
                    halves = []
                    for mine in pieces:
                        part = torch.zeros(bh, n_r, bk)
                        for p0 in mine:
                            qp = qw[..., p0:p0 + piece]
                            kp = kt[..., p0:p0 + piece].transpose(1, 2)
                            # float32: each piece in accumulators of its own
                            part = part + (product(qp, kp, 3) if f32 else qp @ kp)
                        halves.append(part)
                    sc = halves[0] + halves[1]
                    keep = torch.ones(n_r, bk, dtype=torch.bool)
                    if causal:
                        keep &= keys[None, :] <= rows[:, None]
                    if window:
                        keep &= keys[None, :] > rows[:, None] - window
                    sc = torch.where(keep, sc, torch.tensor(-1e30 if f32 else -torch.inf))
                    sc = torch.where(keys[None, :] >= s, torch.tensor(-torch.inf), sc)
                    if f32:
                        mx = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                        corr, p = torch.exp(m - mx), torch.exp(sc - mx)
                        pv = product(p, vt, 3)
                    else:
                        mx = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                        mx = torch.where((mx - m) * c <= 8.0, m, mx)  # the lazy maximum
                        corr, p = torch.exp2((m - mx) * c), torch.exp2((sc - mx) * c)
                        ph = (p * pscale).to(q.dtype).to(torch.float32)
                        pl = (p * pscale - ph).to(q.dtype).to(torch.float32)
                        pv = ph @ vt + pl @ vt
                    l = l * corr + p.sum(dim=-1, keepdim=True)
                    o = o * corr + pv
                    m = mx
                n = min(n_r, s - r0)
                out[:, r0:r0 + n, c0:c0 + cols] = (o / (l.clamp_min(1e-30) * pscale))[:, :n]
    return out[..., :d].reshape(b, h, s, d).to(q.dtype)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d,s", [(320, 96), (576, 72), (1024, 72)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_wide_plan_meets_the_rules(name, d, s, causal, window, rng):
    """One column group (320: its second half 64 columns), two with a
    ragged last one (576: 64 columns) and two whole ones (1024: more
    pieces than a warpgroup's ring holds), S a whole and a ragged number of
    key tiles and of 64-row q tiles, GQA 4/2."""
    (qt, qj), (kt, kj), (vt, vj) = (both(normal(rng, 1, n, s, d), name) for n in (4, 2, 2))
    got = emulate_flash_wide(qt, kt, vt, causal=causal, window=window)
    want = jax_flash(qj, kj, vj, causal=causal, window=window, interpret=True,
                     block_q=s, block_k=s)
    assert within_rule(got, as_torch(want, qt.dtype))


def emulate_decode_wide(q, k_cache, v_cache, lengths, sms=H100_SMS, split_p=True):
    """decode_wide's plan and arithmetic on the CPU: the chunks of
    split_plan (at most 512 rows); in each, the batch's scores summed over
    the 64-column pieces of each k row tile, the scale, -1e30 past the
    length (only at length 0, which walks every row), the chunk's maximum,
    p and l in float32; p.v a slice at a time (``wide_slice``: 256 columns
    in bf16 and float16, 128 in float32) over the v row tiles: float32 p
    and v in float32, bf16 and float16 p as the pair
    hi = round(p s) + lo = round(p s - hi) in q's dtype (s = 2^15 in
    float16, 1 in bf16) against v, both products into float32 and scaled
    back by 1 / s; the chunks combined as decode_combine_wide does (a
    single chunk is the output).  ``split_p=False``: p rounded once to q's
    dtype instead (the negative control)."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    n_splits, chunk = decode_ops.split_plan(s, b * hkv, sms, group, d, q.dtype)
    assert chunk <= cu_int(DECODE_CU, "kWideChunk") and chunk % 64 == 0
    piece, cols = cu_int(DECODE_CU, "kWidePiece"), decode_ops.wide_slice(q.dtype)
    kr, vr = decode_ops.wide_tile_rows(q.dtype)
    f32 = q.dtype == torch.float32
    pscale = 32768.0 if q.dtype == torch.float16 else 1.0
    scale = 1.0 / d ** 0.5
    qf = q.to(torch.float32).reshape(b, hkv, group, d)
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    out = torch.empty(b, hkv, group, d)
    for bi in range(b):
        ln = int(lengths[bi])
        n = min(ln, s) if ln > 0 else s
        ms, ls, accs = [], [], []
        for c0 in range(0, n_splits * chunk, chunk):
            if c0 >= n:
                continue  # an empty partial: weight 0
            c1 = min(c0 + chunk, n)
            sc = torch.zeros(hkv, group, c1 - c0)
            for r0 in range(c0, c1, kr):  # a k row tile, its pieces in order
                r1 = min(r0 + kr, c1)
                for p0 in range(0, d, piece):
                    sc[..., r0 - c0:r1 - c0] += (qf[bi, :, :, p0:p0 + piece]
                                                 @ kf[bi, :, r0:r1, p0:p0 + piece].transpose(1, 2))
            rows = torch.arange(c0, c1)
            sc = torch.where(rows >= ln, torch.tensor(-1e30), sc * scale)
            m = sc.amax(dim=-1, keepdim=True)
            p = torch.exp(sc - m)
            ms.append(m)
            ls.append(p.sum(dim=-1, keepdim=True))
            if f32:
                pairs = (p,)
            elif not split_p:
                pairs = ((p * pscale).to(q.dtype).to(torch.float32),)
            else:
                hi = (p * pscale).to(q.dtype).to(torch.float32)
                pairs = (hi, (p * pscale - hi).to(q.dtype).to(torch.float32))
            acc = torch.zeros(hkv, group, d)
            for col0 in range(0, d, cols):  # an output slice, its v row tiles in order
                for r0 in range(c0, c1, vr):
                    r1 = min(r0 + vr, c1)
                    vt = vf[bi, :, r0:r1, col0:col0 + cols]
                    for part in pairs:
                        acc[..., col0:col0 + cols] += part[..., r0 - c0:r1 - c0] @ vt
            accs.append(acc / pscale)
        if len(ms) == 1 and n_splits == 1:
            out[bi] = accs[0] / ls[0].clamp_min(1e-30)
            continue
        mx = torch.stack(ms).amax(dim=0)
        num = sum(torch.exp(m - mx) * a for m, a in zip(ms, accs))
        den = sum(torch.exp(m - mx) * l_ for m, l_ in zip(ms, ls))
        out[bi] = num / den.clamp_min(1e-30)
    return out.reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("d,group,s,edges", [
    (320, 4, 256, False), (576, 9, 128, False), (257, 16, 64, False),
    (515, 16, 384, True), (384, 8, 1024, True)])
def test_decode_wide_plan_meets_the_rules(name, d, group, s, edges, rng):
    """Several chunks (and one, at S = 64), ragged head batches (4 q heads
    a kv head; 9: 8 and 1) and full ones (16: two of 8; 8), piece and slice
    tails (257 and 515: 64-column pieces and slices of 256 or 128 columns
    with 1 and 3 columns; 320 and 576 a 64-column slice), lengths 0, 1, a
    chunk edge and S; and, where ``edges``, the plan of a card of 4 SMs
    (one chunk of 384 rows; two of 512), so that a chunk holds several
    tiles, and lengths one row either side of a k row tile's edge (128 rows
    in 16-bit, 64 in float32), one past a v row tile's (32 rows) and one
    past the chunk's edge or one short of S."""
    b, hkv = 4, 1
    sms = 4 if edges else H100_SMS
    (qt, qj), (kt, kj), (vt, vj) = (both(x, name) for x in (
        normal(rng, b, group * hkv, d), normal(rng, b, hkv, s, d), normal(rng, b, hkv, s, d)))
    _, chunk = decode_ops.split_plan(s, b * hkv, sms, group, d, qt.dtype)
    kr, vr = decode_ops.wide_tile_rows(qt.dtype)
    lengths = np.array([kr - 1, kr + 1, vr + 1, min(chunk + 1, s) if s > chunk else s - 1]
                       if edges else [0, 1, min(chunk + 1, s), s], np.int32)
    got = emulate_decode_wide(qt, kt, vt, lengths, sms)
    want = jax_decode(qj, kj, vj, jnp.asarray(lengths), interpret=True, block_s=64)
    assert within_rule(got, as_torch(want, qt.dtype))


@pytest.mark.parametrize("name", ["bfloat16", "float16"])
def test_decode_wide_needs_p_as_a_pair(name, rng):
    """The negative control: p rounded once to the 16-bit type before p.v
    (one product, not the hi + lo pair) misses the rule, where the pair
    meets it, at a chunk of 512 rows, 8 q heads and lengths 0, 1, 200, S."""
    b, group, s, d = 4, 8, 1024, 384
    (qt, qj), (kt, kj), (vt, vj) = (both(x, name) for x in (
        normal(rng, b, group, d), normal(rng, b, 1, s, d), normal(rng, b, 1, s, d)))
    lengths = np.array([0, 1, 200, s], np.int32)
    want = as_torch(jax_decode(qj, kj, vj, jnp.asarray(lengths), interpret=True, block_s=64),
                    qt.dtype)
    assert within_rule(emulate_decode_wide(qt, kt, vt, lengths, 4), want)
    assert not within_rule(emulate_decode_wide(qt, kt, vt, lengths, 4, split_p=False), want)


def test_wide_shared_memory_and_slices_at_every_head_dim():
    """Both wide kernels' blocks fit the card at every head dim from 257
    to 1,024 (their shared memory does not grow with it), and the flash
    column groups cover every output column exactly once, each half of a
    group 256 columns or what is left."""
    for d in range(257, 1025):
        for dtype, _ in DTYPES.values():
            assert flash_ops.wide_smem_bytes(dtype) <= SMEM_LIMIT
            ld = flash_ops.row_elems(dtype, d)
            covered = np.zeros(ld, np.int64)
            for c0, cols in flash_ops.wide_groups(dtype, d):
                assert 0 < cols <= flash_ops.WIDE_GROUP and c0 % flash_ops.WIDE_GROUP == 0
                covered[c0:c0 + cols] += 1
            assert (covered == 1).all(), d
            name = "flash_tf32_wide" if dtype == torch.float32 else "flash_wgmma_wide"
            assert flash_ops.kernel_label(dtype, d) == f"{name}<{flash_ops._SHORT[dtype]}>"
            assert flash_ops.positive_only(dtype, d) == (dtype != torch.float32)
            narrow = "_narrow" if d * dtype.itemsize % 16 else ""  # rows not whole 16-byte pieces
            assert decode_ops.decode_kernel(dtype, 4, d) == (
                f"decode_wide{narrow}<{decode_ops._SHORT[dtype]}>")
    for dtype, _ in DTYPES.values():  # two decode_wide blocks an SM, 1 KB each reserved
        assert 2 * (decode_ops.wide_smem_bytes(dtype) + 1024) <= SM_SMEM


def test_wide_geometry_matches_the_sources():
    """The wrappers' mirrors of the kernels' constants and shared memory:
    both wide flash kernels take 64 q rows and 512 output columns a block
    and 64-column pieces; flash_wgmma_wide 64-key tiles and a ring of 4
    stages a warpgroup (214,096 B), flash_tf32_wide 8 warps and 32-key
    tiles (214,528 B)."""
    for name in ("kGCols", "kXCols"):
        assert cu_int(FLASH_CU, name) == flash_ops.WIDE_GROUP == 512
    for name in ("kGPiece", "kXPiece"):
        assert cu_int(FLASH_CU, name) == flash_ops.WIDE_PIECE == 64
    for name in ("kGRows", "kXRows"):
        assert cu_int(FLASH_CU, name) == flash_ops.WIDE_ROWS == 64
    assert cu_int(FLASH_CU, "kGKeys") == flash_ops.wide_keys(torch.bfloat16) == 64
    assert cu_int(FLASH_CU, "kXKeys") == flash_ops.wide_keys(torch.float32) == 32
    assert cu_int(FLASH_CU, "kGRing") == 4 and cu_int(FLASH_CU, "kXWarps") == 8
    assert 2 * cu_int(FLASH_CU, "kGWgCols") == 2 * cu_int(FLASH_CU, "kXSetCols") == 512
    assert flash_ops.wide_smem_bytes(torch.float32) == 214_528
    assert flash_ops.wide_smem_bytes(torch.bfloat16) == 214_096
    assert flash_ops.wide_smem_bytes(torch.float16) == 214_096
    assert "214,096 B" in FLASH_CU and "214,528 B" in FLASH_CU  # the comments agree
    assert cu_int(DECODE_CU, "kWideChunk") == decode_ops.WIDE_CHUNK == 512
    assert cu_int(DECODE_CU, "kWidePiece") == decode_ops.WIDE_PIECE == 64
    assert cu_int(DECODE_CU, "kWideSliceBytes") == decode_ops.WIDE_SLICE_BYTES == 512
    assert cu_int(DECODE_CU, "kWideHeads") == decode_ops.WIDE_HEADS == 8
    assert cu_int(DECODE_CU, "kWideTile") == decode_ops.WIDE_TILE == 16384
    assert cu_int(DECODE_CU, "kWideQBytes") == decode_ops.WIDE_Q_BYTES == 2048
    assert cu_int(DECODE_CU, "kWideStages") == decode_ops.WIDE_STAGES == 4
    # WideGeo: every tile 1,024 16-byte chunks (four a thread), whole tiles a chunk
    for dtype, _ in DTYPES.values():
        esz = torch.empty((), dtype=dtype).element_size()
        kr, vr = decode_ops.wide_tile_rows(dtype)
        assert kr * decode_ops.WIDE_PIECE * esz == vr * decode_ops.wide_slice(dtype) * esz \
            == 4 * 256 * 16
        assert decode_ops.WIDE_CHUNK % kr == decode_ops.WIDE_CHUNK % vr == 0
        assert decode_ops.WIDE_HEADS * decode_ops.WIDE_PIECE * esz <= decode_ops.WIDE_Q_BYTES
    assert decode_ops.wide_tile_rows(torch.bfloat16) == (128, 32)
    assert decode_ops.wide_slice(torch.bfloat16) == 256 and decode_ops.wide_slice(torch.float32) == 128
    assert decode_ops.wide_tile_rows(torch.float32) == (64, 32)
    assert decode_ops.wide_smem_bytes(torch.bfloat16) == 106_816
    assert decode_ops.wide_smem_bytes(torch.float16) == 106_816
    assert decode_ops.wide_smem_bytes(torch.float32) == 90_176
    assert "106,816 B" in DECODE_CU and "90,176 B" in DECODE_CU  # the comments agree
    # no refusal of wide rows is left in either C entry point
    assert "head_dim > 256" not in FLASH_CU and "head_dim > 256" not in DECODE_CU


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


@pytest.mark.parametrize("dtype,d,row", [
    (torch.float32, 257, 260), (torch.float32, 512, 512), (torch.bfloat16, 257, 264),
    (torch.float16, 576, 576), (torch.bfloat16, 1024, 1024)])
def test_flash_wrapper_above_256(dtype, d, row):
    """The library gets the row (padded only where its bytes are not a
    multiple of 16), the dtype code and the default scale of the unpadded
    D.  flash_tf32_wide takes any scale as it is; flash_wgmma_wide (bf16,
    float16) takes scale > 0 only, so a negative scale reaches it as -q and
    |scale| (``positive_scale``), a copy of q."""
    b, h, hkv, s = 1, 4, 2, 16
    q = torch.randn(b, h, s, d).to(dtype)
    k, v = torch.randn(b, hkv, s, d).to(dtype), torch.randn(b, hkv, s, d).to(dtype)
    assert flash_ops.row_elems(dtype, d) == row and flash_ops.width(dtype, d) == row
    wgmma = dtype != torch.float32
    assert flash_ops.kernel_name(dtype, d) == (
        "flash_wgmma_wide" if wgmma else "flash_tf32_wide")
    assert flash_ops.positive_only(dtype, d) == wgmma
    flash_ops._check_cuda(q, k, v, None)
    lib = FakeFlashLib()
    qs, scale = (flash_ops.positive_scale(q, -(d ** -0.5)) if wgmma else (q, -(d ** -0.5)))
    out = flash_ops._launch(lib, qs, k, v, causal=True, scale=scale, window=None,
                            device=0, stream=0)
    (args,) = lib.calls
    assert args[1] == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
    assert args[2] == row and args[7:10] == (b * h, s, h // hkv)
    assert args[11] == pytest.approx(d ** -0.5 if wgmma else -(d ** -0.5))
    assert (args[3] == q.data_ptr()) == (row == d and not wgmma)
    if wgmma:
        assert torch.equal(qs, -q)
    assert out.shape == (b, h, s, d) and out.dtype == dtype


@pytest.mark.parametrize("dtype,group,d,plan", [
    (torch.float32, 8, 512, (64, 64)), (torch.bfloat16, 71, 257, (8, 512)),
    (torch.float16, 1, 1024, (64, 64)), (torch.bfloat16, 4, 320, (64, 64))])
def test_decode_wrapper_above_256(dtype, group, d, plan):
    """The library gets the head dim, the caches and q as they are (no
    copy), and split_plan's decode_wide plan: about two blocks an SM,
    counting a block per batch of 8 q heads (4 sequences x 9 batches at
    71 heads: 8 chunks of 512 rows), chunks a multiple of 64 and at most
    512 rows; the partials sized for every q head and chunk."""
    b, s = 4, 4096
    q = torch.zeros((b, group, d), dtype=dtype)
    k = torch.zeros((b, 1, s, d), dtype=dtype)
    v = torch.zeros((b, 1, s, d), dtype=dtype)
    lengths = torch.full((b,), s, dtype=torch.int32)
    decode_ops._check_cuda(q, k, v, lengths)
    lib = FakeDecodeLib()
    out = decode_ops._launch(lib, q, k, v, lengths, d ** -0.5, device=0, stream=0,
                             sms=H100_SMS)
    (args,) = lib.calls
    assert args[2] == d and (args[3], args[4], args[5]) == (q.data_ptr(), k.data_ptr(),
                                                            v.data_ptr())
    assert decode_ops.split_plan(s, b, H100_SMS, group, d, dtype) == plan
    assert args[10:16] == (b, 1, group, s, *plan)
    assert args[9] - args[8] == b * group * plan[0] * d * 4
    assert out.shape == q.shape and out.dtype == dtype
    assert decode_ops.split_plan(64, b, H100_SMS, group, d, dtype) == (1, 64)
    assert decode_ops.split_plan(1 << 16, 1, 1, group, d, dtype)[1] == decode_ops.WIDE_CHUNK
