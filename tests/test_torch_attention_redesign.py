"""The redesigned attention kernels' contracts, checked on the CPU.

* The bf16 flash rule of ``chip_smoke.py`` (a tensor-core kernel's error
  against the plain version at most twice that of the reference's chunked
  bf16 route): a torch emulation of the kernel's rounding (bf16 q and k,
  float32 scores, p rounded to bf16) passes it, and the same emulation
  with its causal mask shifted by one key, or its window off by one,
  fails it at the mask-probe inputs; at D = 128, and at each head layout
  whose bf16 flash runs on the tensor cores (Yi-6B 32/4 at D = 128,
  qwen3-32b 64/8 at 80, h2o-danube-3-4b 32/8 at 120, musicgen-medium
  24/24 and 32/4 at 64, granite-34b 48/1 at 128, recurrentgemma-9b 16/1
  and 16/4 at 256).
* The decode kernel's split-S plan: a torch emulation of the split and
  combine (``split_combine`` below, which mirrors decode_split or
  decode_group, and decode_combine) equals ``decode_attention_ref`` within
  1e-6 and the Pallas kernel in interpret mode within 1e-5, at lengths 0,
  1, at the chunk edges and S, for groups 1, 8 and 48 at D = 32 and 16 at
  D = 256.  The plan (``split_plan``) aligns its chunks, covers the cache
  with no empty chunk at full length, and, for bf16 groups above 8
  (decode_group), keeps the partials within the cache's bytes and its
  blocks within one an SM; Yi-6B's, granite-34b's and recurrentgemma-9b's
  plans are pinned, and ``decode_kernel`` names the kernel the plan is
  for.
* The decode wrapper hands the (B,) lengths to the kernel as they are.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import attention_ref

torch.set_num_threads(1)  # small tensors: extra threads only contend

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

H100_SMS = 132
DECODE_CU = decode_ops.SOURCE.read_text()


# ------------------------------------------------------------ flash rule
def emulate_kernel(q, k, v, *, causal, window, shift=0, widen=0):
    """The wgmma kernel's rounding in torch: q.k^T of the bf16 inputs in
    float32, the scale on the float32 scores, p rounded to bf16 for p.v,
    the denominator over the float32 p.  ``shift`` lets each row see that
    many keys past the diagonal, ``widen`` that many more window keys."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, s, d).float()
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * d ** -0.5
    rows = torch.arange(s)[:, None]
    cols = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= cols <= rows + shift
    if window is not None:
        mask &= cols > rows - window - widen
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgqt,bktd->bkgqd", p.to(torch.bfloat16).float(), v.float())
    out = out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, s, d).to(q.dtype)


def probe(s, window, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return chip_smoke.mask_probe(torch, s, window=window, h=4, hkv=1, d=128,
                                 dtype=torch.bfloat16, generator=gen)


def rule(q, k, v, got, *, causal, window):
    want = attention_ref(q, k, v, causal=causal, window=window)
    yard = chip_smoke.flash_yardstick(q, k, v, causal=causal, window=window)
    return chip_smoke.flash_bf16_close(torch, got, want, yard)


@pytest.mark.parametrize("s,window", [(512, None), (512, 256), (200, None)])
def test_flash_rule_accepts_the_kernels_rounding_on_random_inputs(s, window):
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for shape in ((1, 4, s, 128), (1, 1, s, 128),
                                                 (1, 1, s, 128)))
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=window),
                     causal=True, window=window)
    assert ok, stats


@pytest.mark.parametrize("window", [None, 256])
def test_flash_rule_accepts_the_kernels_rounding_at_the_probes(window):
    q, k, v = probe(512, window)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=window),
                     causal=True, window=window)
    assert ok, stats


def test_flash_rule_rejects_a_causal_mask_shifted_by_one_key():
    q, k, v = probe(512, None)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=None, shift=1),
                     causal=True, window=None)
    assert not ok and stats[0] >= 32, stats  # a leak moves outputs by whole units


def test_flash_rule_rejects_a_window_off_by_one():
    q, k, v = probe(512, 256)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=256, widen=1),
                     causal=True, window=256)
    assert not ok and stats[0] >= 32, stats


def test_mask_probes_make_masked_keys_dominant():
    """Without the mask the probes would decide every row: the plain
    version without a causal mask is far from the one with it."""
    q, k, v = probe(512, None)
    masked = attention_ref(q, k, v, causal=True).float()
    unmasked = attention_ref(q, k, v, causal=False).float()
    assert float((masked - unmasked).abs().max()) >= 64


#: (D, H, Hkv) of each config whose bf16 flash runs flash_wgmma: Yi-6B,
#: qwen3-32b, h2o-danube-3-4b, musicgen-medium (24/24), granite-34b (MQA
#: 48/1), recurrentgemma-9b (MQA 16/1 at D = 256), and D = 64 at 32/4 and
#: D = 256 at 16/4, the other layouts chip_smoke.py checks them at
WGMMA_CONFIGS = [(128, 32, 4), (80, 64, 8), (120, 32, 8), (64, 24, 24), (64, 32, 4),
                 (128, 48, 1), (256, 16, 1), (256, 16, 4)]
#: a small S for the configs' head counts; the probes' tile edges still
#: fall inside (0, 63, 64, 127, 128, 129, 255)
SMALL_S = 256


def probe_at(d, h, hkv, window, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return chip_smoke.mask_probe(torch, SMALL_S, window=window, h=h, hkv=hkv, d=d,
                                 dtype=torch.bfloat16, generator=gen)


@pytest.mark.parametrize("d,h,hkv", WGMMA_CONFIGS)
@pytest.mark.parametrize("s,causal,window", [(SMALL_S, True, None), (SMALL_S, False, None),
                                             (200, True, 64)])
def test_flash_rule_accepts_the_kernels_rounding_at_each_head_dim(d, h, hkv, s, causal,
                                                                  window):
    rng = np.random.default_rng(d + s)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(torch.bfloat16) for shape in ((1, h, s, d), (1, hkv, s, d),
                                                 (1, hkv, s, d)))
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=causal, window=window),
                     causal=causal, window=window)
    assert ok, stats


@pytest.mark.parametrize("d,h,hkv", WGMMA_CONFIGS)
@pytest.mark.parametrize("window", [None, 128])
def test_flash_rule_accepts_the_kernels_rounding_at_the_probes_at_each_head_dim(
        d, h, hkv, window):
    q, k, v = probe_at(d, h, hkv, window)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=window),
                     causal=True, window=window)
    assert ok, stats


@pytest.mark.parametrize("d,h,hkv", WGMMA_CONFIGS)
def test_flash_rule_rejects_a_shifted_causal_mask_at_each_head_dim(d, h, hkv):
    q, k, v = probe_at(d, h, hkv, None)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=None, shift=1),
                     causal=True, window=None)
    assert not ok and stats[0] >= 32, stats


@pytest.mark.parametrize("d,h,hkv", WGMMA_CONFIGS)
def test_flash_rule_rejects_a_window_off_by_one_at_each_head_dim(d, h, hkv):
    q, k, v = probe_at(d, h, hkv, 128)
    ok, stats = rule(q, k, v, emulate_kernel(q, k, v, causal=True, window=128, widen=1),
                     causal=True, window=128)
    assert not ok and stats[0] >= 32, stats


# ---------------------------------------------------------- decode split
def split_combine(q, k_cache, v_cache, lengths, *, n_splits, chunk, scale):
    """decode_split and decode_combine in torch, float32: per chunk of
    ``chunk`` rows a (m, l, acc) over the rows below the walk bound n
    (min(length, S), or S at length 0, whose scores are -1e30), an empty
    partial (m = -inf) for a chunk at or past n, then the merge."""
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    out = torch.empty((b, h, d), dtype=torch.float32)
    for bi in range(b):
        length = int(lengths[bi])
        n = min(length, s) if length > 0 else s
        for kh in range(hkv):
            qh = q[bi, kh * group:(kh + 1) * group].float()  # (G, D)
            parts = []
            for c in range(n_splits):
                c0, c1 = c * chunk, min((c + 1) * chunk, n)
                if c0 >= n:
                    parts.append((torch.full((group,), -torch.inf), None, None))
                    continue
                kc = k_cache[bi, kh, c0:c1].float()
                vc = v_cache[bi, kh, c0:c1].float()
                sc = (qh @ kc.T) * scale
                if length <= 0:
                    sc = torch.full_like(sc, -1e30)
                m = sc.amax(dim=-1)
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(dim=-1), p @ vc))
            m_all = torch.stack([x[0] for x in parts]).amax(dim=0)
            num = torch.zeros((group, d))
            den = torch.zeros((group,))
            for m, l, acc in parts:
                if l is None:
                    continue
                w = torch.exp(m - m_all)
                num += w[:, None] * acc
                den += w * l
            out[bi, kh * group:(kh + 1) * group] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def decode_inputs(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("h,hkv,d", [pytest.param(4, 4, 32, id="4-4"),
                                     pytest.param(8, 1, 32, id="8-1"),
                                     pytest.param(48, 1, 32, id="48-1"),
                                     pytest.param(16, 1, 256, id="16-1-256")])
def test_split_combine_equals_plain_and_pallas(h, hkv, d):
    b, s = 3, 512
    n_splits, chunk = decode_ops.split_plan(s, b * hkv, H100_SMS, h // hkv, d)
    assert n_splits > 1 and chunk % decode_ops.CHUNK_ALIGN == 0
    q, k, v = decode_inputs(b, h, hkv, s, d, seed=h)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = d ** -0.5
    for lens in ([0, 1, s], [chunk - 1, chunk, chunk + 1]):
        lengths = np.array(lens, np.int32)
        got = split_combine(tq, tk, tv, torch.from_numpy(lengths),
                            n_splits=n_splits, chunk=chunk, scale=scale)
        want = decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths), scale=scale)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
        pallas = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lengths), block_s=128, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,n_blocks", [(4096, 16), (4096, 4), (1024, 48), (200, 16),
                                        (64, 1), (4096, 512), (8192, 1)])
def test_split_plan_covers_the_cache_without_empty_chunks(s, n_blocks):
    n_splits, chunk = decode_ops.split_plan(s, n_blocks, H100_SMS)
    assert chunk % decode_ops.CHUNK_ALIGN == 0
    assert (n_splits - 1) * chunk < s <= n_splits * chunk  # none empty at full length
    # about two blocks an SM, unless the cache has too few tiles
    assert n_splits * n_blocks >= min(2 * H100_SMS, n_blocks * -(-s // 64)) // 2


def test_split_plan_of_the_main_shape():
    """B=4, Hkv=4, S=4096 on 132 SMs: 16 chunks of 256 rows, 256 blocks."""
    assert decode_ops.split_plan(4096, 16, H100_SMS) == (16, 256)
    assert decode_ops.split_plan(4096, 16, H100_SMS, 8, 128) == (16, 256)  # group 8


def test_split_plan_of_the_wide_groups():
    """granite-34b (B=4, MQA 48/1 x 128, S=4096): 32 chunks of 128 rows,
    128 blocks, 6.39 MB of partials written and read against 8.39 MB of
    cache.  recurrentgemma-9b (B=1, MQA 16/1 x 256, S=4096): 64 chunks of
    64 rows, 2.11 MB against 4.19 MB.  float32 at the same groups keeps
    decode_split's plan."""
    assert decode_ops.split_plan(4096, 4, H100_SMS, 48, 128) == (32, 128)
    assert decode_ops.split_plan(4096, 1, H100_SMS, 16, 256) == (64, 64)
    assert 2 * decode_ops.partial_bytes(4, 48, 128, 32) == 6_389_760
    assert 2 * decode_ops.partial_bytes(1, 16, 256, 64) == 2_113_536
    assert decode_ops.split_plan(4096, 4, H100_SMS, 48, 128, torch.float32) == (64, 64)
    assert decode_ops.split_plan(4096, 1, H100_SMS, 16, 256, torch.float32) == (64, 64)


#: (dtype, group, head dim, kernel); the ids are those the cases had
#: before the kernels took a type (decode_group<D, MT> for bf16 alone)
DECODE_NAMES = [
    (torch.bfloat16, 48, 128, "decode_group<bf16, 128, 3>", "decode_group<128, 3>"),
    (torch.bfloat16, 24, 128, "decode_group<bf16, 128, 2>", "decode_group<128, 2>"),
    (torch.bfloat16, 16, 256, "decode_group<bf16, 256, 1>", "decode_group<256, 1>"),
    (torch.bfloat16, 64, 256, "decode_group<bf16, 256, 4>", "decode_group<256, 4>"),
    (torch.bfloat16, 9, 80, "decode_group<bf16, 80, 1>", "decode_group<80, 1>"),
    (torch.bfloat16, 8, 128, "decode_split<bf16, 128>", None),
    (torch.bfloat16, 1, 64, "decode_split<bf16, 64>", None),
    (torch.float32, 48, 128, "decode_split<f32, 128>", None),
    (torch.float32, 16, 256, "decode_split<f32, 256>", None)]


@pytest.mark.parametrize("dtype,group,d,name", [
    pytest.param(dt, g, d, name, id=f"dtype{i}-{g}-{d}-{old or name}")
    for i, (dt, g, d, name, old) in enumerate(DECODE_NAMES)])
def test_decode_kernel_names_the_launched_kernel(dtype, group, d, name):
    """decode_kernel follows the .cu's dispatch (bf16 and float16 groups
    above kNarrowGroup to decode_group<T, D, MT>, MT = ceil(slice / 16)),
    names the kernel as chip_smoke's ptxas report does, and split_plan
    takes the kernel's plan."""
    assert decode_ops.decode_kernel(dtype, group, d) == name
    # the Itanium mangling of the instantiation nvcc emits, as ptxas names it
    typ = {torch.bfloat16: "13__nv_bfloat16", torch.float16: "6__half", torch.float32: "f"}
    args = (f"I{typ[dtype]}Li{d}ELi{-(-group // 16)}E" if name.startswith("decode_group")
            else f"I{typ[dtype]}Li{d}E")
    mangled = f"_ZN12_GLOBAL__N_112{name.split('<')[0]}{args}EEvPK13__nv_bfloat16"
    assert chip_smoke.kernel_label(mangled) == name
    assert "const int mt = (slice + 15) / 16;" in DECODE_CU
    n_splits, chunk = decode_ops.split_plan(4096, 4, H100_SMS, group, d, dtype)
    wide = name.startswith("decode_group")
    assert chunk % (decode_ops.GROUP_ROWS if wide else decode_ops.CHUNK_ALIGN) == 0
    assert (4 * n_splits <= H100_SMS) if wide else (4 * n_splits >= H100_SMS)


WIDE_PLAN_SHAPES = [(s, nb, g, d) for s in (64, 200, 1000, 4096, 8192, 32768)
                    for nb, g in ((1, 16), (4, 48), (2, 64), (8, 9), (64, 16))
                    for d in (32, 80, 128, 256)]


@pytest.mark.parametrize("s,n_blocks,group,d", WIDE_PLAN_SHAPES)
def test_wide_group_plan_bounds(s, n_blocks, group, d):
    """decode_group's plan over shapes: chunks a multiple of GROUP_ROWS,
    the cache covered with no empty chunk at full length, at most one
    block an SM (or one chunk), and the float32 partials, written and
    read, within the k and v caches' bytes."""
    n_splits, chunk = decode_ops.split_plan(s, n_blocks, H100_SMS, group, d)
    assert chunk % decode_ops.GROUP_ROWS == 0 and chunk % decode_ops.CHUNK_ALIGN == 0
    assert (n_splits - 1) * chunk < s <= n_splits * chunk
    assert n_splits == 1 or n_blocks * n_splits <= H100_SMS
    b, hkv = n_blocks, 1
    parts = 2 * decode_ops.partial_bytes(b, hkv * group, d, n_splits)
    assert parts <= b * hkv * s * d * 2 * 2


@pytest.mark.parametrize("group,d", [(48, 128), (16, 256), (16, 80)])
def test_hi_lo_p_keeps_p_v_in_float32(group, d):
    """decode_group's p.v on the tensor cores: p split into bf16 hi + lo
    (hi = p rounded, lo = p - hi rounded), each times the bf16 v exactly,
    summed in float32, is float32's p.v to about 2^-16 of the output's
    scale, far inside the one bf16 ulp that close_enough allows; p rounded
    to one bf16 alone is not (it is what the split avoids)."""
    gen = torch.Generator().manual_seed(group + d)
    rows = 64 * 8  # eight 64-row steps of one chunk
    scores = torch.randn(group, rows, generator=gen) * 3
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    v = torch.randn(rows, d, generator=gen).to(torch.bfloat16)
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    want = p.double() @ v.double()
    got = hi.float() @ v.float() + lo.float() @ v.float()
    one = hi.float() @ v.float()
    scale = want.abs().amax()
    assert float((got.double() - want).abs().amax() / scale) < 2 ** -15
    assert float((one.double() - want).abs().amax() / scale) > 2 ** -12


# ------------------------------------------------------ decode wrapper
class FakeLib:
    def __init__(self):
        self.calls = []

    def decode_attention_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("s", [4096, 64])
def test_decode_wrapper_passes_lengths_unchanged(s):
    b, h, hkv, d = 4, 32, 4, 128
    q = torch.zeros((b, h, d), dtype=torch.bfloat16)
    k = torch.zeros((b, hkv, s, d), dtype=torch.bfloat16)
    lengths = torch.tensor([1, 25, s - 1, 0], dtype=torch.int32)
    decode_ops._check_cuda(q, k, k, lengths)  # (B,) int32 passes the checks
    lib = FakeLib()
    out = decode_ops._launch(lib, q, k, k, lengths, 0.125, device=0, stream=0, sms=H100_SMS)
    assert len(lib.calls) == 1  # one call into the library, no copy of the lengths
    args = lib.calls[0]
    assert args[6] == lengths.data_ptr()  # the caller's (B,) tensor itself
    assert out.dtype == q.dtype and out.shape == q.shape  # q's dtype: no cast after
    n_splits, chunk = decode_ops.split_plan(s, b * hkv, H100_SMS)
    assert args[10:16] == (b, hkv, h // hkv, s, n_splits, chunk)
    if n_splits == 1:
        assert args[8] == 0  # no partials without a combine


def test_decode_wrapper_rejects_per_head_or_wide_lengths():
    """Lengths are one per sequence: (B * H,) per-head copies and 2-D
    tensors are refused; any integer dtype of shape (B,) is taken."""
    q = torch.zeros((2, 8, 32))
    k = torch.zeros((2, 2, 64, 32))
    with pytest.raises(ValueError):
        decode_ops._check_cuda(q, k, k, torch.zeros((16,), dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_ops._check_cuda(q, k, k, torch.zeros((2, 4), dtype=torch.int32))
    decode_ops._check_cuda(q, k, k, torch.zeros((2,), dtype=torch.int64))


@pytest.mark.parametrize("group,ok", [(1, True), (48, True), (decode_ops.MAX_GROUP, True),
                                      (decode_ops.MAX_GROUP * 2, False)])
def test_decode_wrapper_group_limit(group, ok):
    """Every group passes the wrapper; ``ok``: the group fits one block
    (MAX_GROUP heads), else it is cut into slices of at most MAX_GROUP, a
    block each (128: two of 64)."""
    q = torch.zeros((1, group, 32))
    k = torch.zeros((1, 1, 64, 32))
    lengths = torch.ones((1,), dtype=torch.int32)
    decode_ops._check_cuda(q, k, k, lengths)
    n_slices, width = decode_ops.group_slices(group)
    assert (n_slices == 1) == ok and width <= decode_ops.MAX_GROUP
    if not ok:
        assert (n_slices, width) == (2, 64)


def test_decode_wrapper_at_granite_shape():
    """granite-34b's decode (B=4, 48/1 x 128, bf16): the library gets the
    group and the wide-group plan, and partials sized for it."""
    b, h, hkv, s, d = 4, 48, 1, 4096, 128
    q = torch.zeros((b, h, d), dtype=torch.bfloat16)
    k = torch.zeros((b, hkv, s, d), dtype=torch.bfloat16)
    lengths = torch.full((b,), s, dtype=torch.int32)
    lib = FakeLib()
    decode_ops._launch(lib, q, k, k, lengths, 0.125, device=0, stream=0, sms=H100_SMS)
    args = lib.calls[0]
    assert args[10:16] == (b, hkv, 48, s, 32, 128)
    assert args[9] - args[8] == b * h * 32 * d * 4  # acc, then (m, l)


def test_decode_partials_hold_acc_then_ml():
    """A split call passes float32 partials: acc (B * H * n_splits rows of
    D) and, right after it, (m, l) of each of those rows."""
    b, h, hkv, s, d = 2, 8, 2, 4096, 64
    q = torch.zeros((b, h, d), dtype=torch.bfloat16)
    k = torch.zeros((b, hkv, s, d), dtype=torch.bfloat16)
    lengths = torch.tensor([5, 4096], dtype=torch.int32)
    lib = FakeLib()
    decode_ops._launch(lib, q, k, k, lengths, 0.125, device=0, stream=0, sms=H100_SMS)
    args = lib.calls[0]
    n_splits = decode_ops.split_plan(s, b * hkv, H100_SMS)[0]
    assert n_splits > 1 and args[8] != 0
    assert args[9] - args[8] == b * h * n_splits * d * 4


# ------------------------------------------------------- ptxas report
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea711flash_wgmmaILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__8c2aef73_18_flash_attention_cu_23f0aea711flash_wgmmaILi256EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 233 registers, used 16 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__19acd4fc_19_decode_attention_cu_3848999b12decode_groupILi128ELi3EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 104 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__19acd4fc_19_decode_attention_cu_3848999b12decode_splitIfLi120EEEvPKT_S3_S3_PKiPS1_Pf' for 'sm_90a'
    56 bytes stack frame, 56 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 56 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN52_GLOBAL__N__48c8a485_19_fused_filter_agg_cu_6f2cae1123fused_filter_agg_kernelIifEEvPKiPKT_PKT0_xx' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 3088 bytes smem
"""


def test_ptxas_report_names_every_kernel_with_its_registers_and_spills():
    """chip_smoke's phase 1 line: each kernel of ptxas's -v report by a
    readable name (template arguments as numbers and bf16 / f32 / i32),
    its registers and its spill bytes."""
    report = chip_smoke.ptxas_report({"a": PTXAS_LOG})
    assert report == {
        "flash_wgmma<256>": {"registers": 233, "spill_stores": 0, "spill_loads": 0},
        "decode_group<128, 3>": {"registers": 104, "spill_stores": 0, "spill_loads": 0},
        "decode_split<f32, 120>": {"registers": 128, "spill_stores": 56, "spill_loads": 56},
        "fused_filter_agg_kernel<i32, f32>": {"registers": 48, "spill_stores": 0,
                                              "spill_loads": 0},
    }
