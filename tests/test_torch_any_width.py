"""``flash_wgmma_any`` on the CPU: the widths it is compiled for, its
narrow loader's arithmetic and its staging geometry, against the CUDA
source (the kernel itself runs only on the card; ``chip_smoke.py`` phase 5
holds it to the plain version there).

* The dispatch: ``launch_16bit`` in flash_attention.cu sends every bf16 and
  float16 row of 33 to 255 elements off the compiled widths to the
  ``_any`` kernel at the row rounded up to a multiple of 32, as
  ``ops.width`` and ``ops.kernel_label`` say; the wrapper passes rows of
  33 to 192 as they are (the C entry point takes them whatever their
  bytes) and pads wider rows whose bytes are not a multiple of 16.
* The narrow loader's rewrite (``relayout``), emulated word by word as the
  kernel does it (a thread a row or part of one, four 4-byte words a chunk
  after the one before, a byte permute where the row starts half a word
  in, the mask past the row), over a staging buffer
  that starts at any even byte: the swizzled tile it writes holds the rows
  with zeros past the row and past S.
* The staging buffers: as many as fit beside each width's layout (4 at 64,
  2 at 96, 128, 160 and 192, 1 at 224 and 256), each a tile's raw rows;
  the narrow loader is compiled where two fit, up to ``ops.NARROW_MOST``.
* The consumers' refills through the two buffers: each tile is copied
  once, a refill ahead of its rewrite, into a buffer its last copy has
  left, and the parities the kernel waits for are those of the copies'
  order.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops

torch.set_num_threads(1)

FLASH_CU = flash_ops.SOURCE.read_text()
SMEM_LIMIT = 232_448
ANY = (64, 96, 128, 160, 192, 224, 256)


def cu_int(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", FLASH_CU).group(1))


def dispatch_16bit(ld: int) -> str:
    """The kernel ``launch_16bit`` picks for a row of ld, read off its
    chain of conditions in the source."""
    body = re.search(r"cudaError_t launch_16bit\(.*?\n}\n", FLASH_CU, re.S).group(0)
    chain = re.findall(r"(?::|=)\s*(ld [<>=]+ \d+)?\s*\?\s*(launch_\w+<[^>]*>)|:\s+(launch_\w+<[^>]*>);",
                       body)
    for cond, kernel, last in chain:
        if last:
            return last
        if eval(cond, {}, {"ld": ld}):  # noqa: S307 - the repo's own source
            return kernel
    raise AssertionError(ld)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_the_dispatch_runs_the_row_rounded_up_to_32(dtype):
    assert flash_ops.NARROW_MOST == 192
    for ld in range(33, 257):
        # no padded copy up to 192; above, only rows of whole 16-byte pieces
        row = ld if ld <= 192 or ld % 8 == 0 else -(-ld // 8) * 8
        assert flash_ops.row_elems(dtype, ld) == row
        assert flash_ops.narrow_row(dtype, ld) == (ld <= 192)
        kernel = dispatch_16bit(row)
        label = flash_ops.kernel_label(dtype, ld)
        if row in flash_ops.HEAD_DIMS:
            assert kernel == f"launch_wgmma<T, {row}, false>" and "_any" not in label
            continue
        width = -(-row // 32) * 32
        assert flash_ops.width(dtype, ld) == width
        assert kernel == f"launch_wgmma<T, {width}, true>", ld
        assert label == f"flash_wgmma_any<{flash_ops._SHORT[dtype]}, {width}>"
        # the widths whose softmax takes maxima over unscaled scores
        assert flash_ops.positive_only(dtype, ld) == (width in (64, 96, 160, 192, 224, 256))
    # the C entry point takes every narrow row, and refuses a float32 row
    # or a wider 16-bit one that is not whole 16-byte pieces (the wrapper
    # pads those); launch_wgmma refuses one where the loader is not compiled
    assert "const bool narrow = dtype != 0 && head_dim > 32 && head_dim <= 192;" in FLASH_CU
    assert "(head_dim * elem % 16 != 0 && !narrow)" in FLASH_CU
    assert "const bool narrow = kAny && WGeo<D>::narrow && ld % 8 != 0;" in FLASH_CU
    assert "(ld % 8 != 0 && !narrow)" in FLASH_CU


def test_float32_and_short_rows_still_pad():
    for d in (1, 7, 33, 100, 150, 250):
        assert flash_ops.row_elems(torch.float32, d) == -(-d // 4) * 4
        assert flash_ops.width(torch.float32, d) in flash_ops.TF32_ANY_WIDTHS + flash_ops.HEAD_DIMS
    for d in (1, 9, 31):  # flash_wgmma_any at 32 loads them by TMA
        assert flash_ops.row_elems(torch.bfloat16, d) == -(-d // 8) * 8
        assert flash_ops.kernel_name(torch.bfloat16, d) == "flash_wgmma"
        any_ = "" if d > 24 else "_any"  # 31 pads to the compiled width
        assert flash_ops.kernel_label(torch.bfloat16, d) == f"flash_wgmma{any_}<bf16, 32>"
    for d in (257, 300):  # the wide kernels load by TMA
        assert flash_ops.row_elems(torch.bfloat16, d) == -(-d // 8) * 8
    # one staging buffer at 224 and 256: those rows come padded, by TMA
    for d, row, label in ((193, 200, "flash_wgmma_any<f16, 224>"),
                          (210, 216, "flash_wgmma_any<f16, 224>"),
                          (250, 256, "flash_wgmma<f16, 256>")):
        assert flash_ops.row_elems(torch.float16, d) == row
        assert flash_ops.kernel_label(torch.float16, d) == label


def swizzled(rows: np.ndarray, keys: int, width: int, span: int) -> np.ndarray:
    """The tile the descriptors read, as 16-bit words: ``rows`` (keys x
    columns, zeros past them) in the 128-byte swizzle, spans of 64 columns
    ``span`` bytes apart."""
    out = np.zeros(-(-width // 64) * span // 2, np.uint16)
    for r in range(keys):
        for j in range(width // 8):
            chunk = rows[r, 8 * j:8 * j + 8]
            at = (j // 8) * span + r * 128 + (((j % 8) ^ (r % 8)) << 4)
            out[at // 2:at // 2 + 8] = chunk
    return out


def relayout_emulated(raw: bytes, skew: int, rows: int, ld: int, keys: int, width: int,
                      span: int, nt: int) -> np.ndarray:
    """``relayout`` of flash_attention.cu, word by word: ``nt`` threads,
    thread t the row t % keys and its part of the row's chunks, each chunk
    four 4-byte words after the one before it, byte-permuted where the row
    starts half a word in."""
    buf = raw + bytes(64)

    def word(addr):
        return int.from_bytes(buf[addr:addr + 4], "little")

    def perm(x, y, sel):  # __byte_perm
        b = x.to_bytes(4, "little") + y.to_bytes(4, "little")
        return int.from_bytes(bytes(b[(sel >> (4 * i)) & 7] for i in range(4)), "little")

    nc = width // 8
    per = -(-nc // (nt // keys))
    out = np.zeros(-(-width // 64) * span // 4, np.uint32)
    for t in range(nt):
        r, j0 = t % keys, (t // keys) * per
        elems = ld if r < rows else 0
        off = skew + 2 * r * ld + 16 * j0
        sel = 0x5432 if off & 2 else 0x3210
        a = off & ~3
        w0 = word(a) if elems > 8 * j0 else 0
        for j in range(j0, min(j0 + per, nc)):
            cnt = elems - 8 * j
            w = [0, 0, 0, 0]
            if cnt > 0:
                n = [word(a + 4 * (m + 1)) for m in range(4)]
                w = [perm(w0, n[0], sel)] + [perm(n[m - 1], n[m], sel) for m in range(1, 4)]
                w0 = n[3]
                if cnt < 8:
                    w = [0 if 2 * m >= cnt else (w[m] & 0xFFFF) if 2 * m + 1 >= cnt else w[m]
                         for m in range(4)]
            at = (j >> 3) * span + r * 128 + (((j & 7) ^ (r & 7)) << 4)
            out[at // 4:at // 4 + 4] = w
            a += 16
    return out.view(np.uint16)


@pytest.mark.parametrize("ld,width,keys,nt", [
    (33, 64, 128, 128), (63, 64, 128, 128), (65, 96, 128, 128), (95, 96, 128, 256),
    (100, 128, 128, 128), (127, 128, 128, 128), (150, 160, 64, 128), (161, 192, 64, 256),
    (201, 224, 64, 128), (250, 256, 64, 128), (255, 256, 64, 256), (95, 96, 64, 256),
    (90, 96, 128, 128), (90, 96, 64, 256), (170, 192, 64, 128), (170, 192, 64, 256)])
@pytest.mark.parametrize("skew", [0, 2, 6, 10, 14])
def test_the_narrow_relayout_writes_the_rows_swizzled(ld, width, keys, nt, skew, rng):
    """The staging buffer holds a tile's rows from byte ``skew`` on (the
    16-byte window around a head that starts at any even address); the
    rewrite gives the tile TMA would have loaded from a padded copy: the
    rows, zeros from column ld and from row ``rows`` (a ragged last tile)
    on, every chunk in its swizzled place."""
    rows = keys - 5  # a ragged tile: rows from here on are past S
    span = keys * 128
    vals = rng.integers(1, 2**16, size=(rows, ld)).astype(np.uint16)
    raw = bytes(rng.integers(0, 256, skew, dtype=np.uint8)) + vals.tobytes()
    raw += bytes(rng.integers(0, 256, (-len(raw)) % 16 + 16, dtype=np.uint8))  # the window's end
    full = np.zeros((keys, width), np.uint16)
    full[:rows, :ld] = vals
    got = relayout_emulated(raw, skew, rows, ld, keys, width, span, nt)
    assert np.array_equal(got, swizzled(full, keys, width, span))


def test_the_relayout_in_the_source_is_the_emulated_one():
    body = re.search(r"__device__ __forceinline__ void relayout\(.*?\n}\n", FLASH_CU, re.S).group(0)
    for line in ("constexpr int P = NT / KR, PER = (NC + P - 1) / P;",
                 "const int r = t % KR, j0 = (t / KR) * PER;",
                 "const uint32_t off = skew + 2u * (uint32_t)(r * ld) + 16u * j0;",
                 "const uint32_t sel = (off & 2u) ? 0x5432u : 0x3210u;",
                 "uint32_t a = x + (off & ~3u), w0 = 0u;",
                 "w[0] = __byte_perm(w0, n[0], sel);",
                 "for (int m = 1; m < 4; ++m) w[m] = __byte_perm(n[m - 1], n[m], sel);",
                 "w[m] = 2 * m >= cnt ? 0u : 2 * m + 1 >= cnt ? (w[m] & 0xFFFFu) : w[m];",
                 "dst + (j >> 3) * span + r * 128 + ((uint32_t)((j & 7) ^ (r & 7)) << 4)"):
        assert line in body, line


def geometry(d: int) -> dict:
    """WGeo<d> of flash_attention.cu, in Python: the layout's bytes, the
    staging buffers and the narrow loader's shared memory."""
    half, bq = 64, 128
    boxes = -(-d // half)
    keys = 64 if d > 128 else 128
    span = keys * half * 2
    ring = 4 if d <= 64 else 2
    self_load = d > 128 or d == 96  # no producer: the consumers refill
    used = 1024 + boxes * bq * 128 + 2 * ring * boxes * span + 8 * (1 + 3 * ring) + (
        4 * ring if self_load else 0)
    stage_at = (used - 1024 + 127) // 128 * 128
    xbytes = (keys * (d - 1) * 2 + 48 + 127) // 128 * 128
    fit = (SMEM_LIMIT - 1024 - stage_at - 24) // (xbytes + 8)
    nx = min(fit, 2 if self_load else 4)
    return dict(keys=keys, span=span, tile=boxes * span, used=used, xbytes=xbytes, nx=nx,
                smem=1024 + stage_at + nx * (xbytes + 8) + 24, self_load=self_load)


def test_the_staging_buffers_fit_beside_each_layout():
    assert cu_int("kSmemLimit") == SMEM_LIMIT
    for line in ("static constexpr int stage_at = (smem - 1024 + 127) / 128 * 128;",
                 "static constexpr int xbytes = (keys * (D - 1) * 2 + 48 + 127) / 128 * 128;",
                 "static constexpr int fit = (kSmemLimit - 1024 - stage_at - 24) / (xbytes + 8);",
                 "static constexpr int nx = fit > (self_load ? 2 : 4) ? (self_load ? 2 : 4) : fit;",
                 "static constexpr bool narrow = !r64 && nx >= 2;",
                 "static constexpr int narrow_smem = narrow ? 1024 + stage_at + nx * (xbytes + 8) "
                 "+ 24 : smem;"):
        assert line in FLASH_CU, line
    nx = {d: geometry(d)["nx"] for d in ANY}
    assert nx == {64: 4, 96: 2, 128: 2, 160: 2, 192: 2, 224: 1, 256: 1}
    # the loader is compiled where two buffers fit: up to the wrapper's widest
    assert max(d for d in ANY if nx[d] >= 2) == flash_ops.NARROW_MOST
    # the layout at the compiled widths is the one their kernels use
    # (kNarrowSmem, kWSmem, kWideSmem; the source asserts the same)
    assert [geometry(d)["used"] for d in (64, 128, 256)] == [148_584, 164_920, 197_696]
    assert "WGeo<256>::smem == kWideSmem" in FLASH_CU
    for d in ANY:
        g = geometry(d)
        assert g["smem"] <= SMEM_LIMIT
        # a buffer holds a tile's rows (any ld below d) with the window's
        # slack and the last chunk's second word
        assert g["keys"] * (d - 1) * 2 + 16 + 32 <= g["xbytes"]
        if g["self_load"]:  # the start-up stages raw tiles and q's halves in the ring
            assert g["xbytes"] <= g["tile"]


def two_buffer_refills(n: int):
    """The copies and rewrites of the narrow loader without a producer (R =
    2 stages, two staging buffers), in the order the start-up and the
    refills (``refill_narrow``, release j: kt = j, vt = j - 1) make them:
    ("copy" or "put", buffer, stream, tile, the parity waited for)."""
    r, ev = 2, [("copy", 0, "k", 0, None), ("put", 0, "k", 0, 0)]
    if n > 1:
        ev += [("copy", 0, "k", 1, None), ("put", 0, "k", 1, 1)]
    if n > 2:
        ev.append(("copy", 0, "k", 2, None))
    for j in range(n):
        kt, vt = j, j - 1
        if kt + r < n or (vt >= 0 and vt + r < n):  # place 2: buffer 0, k
            if kt + r < n:
                ev.append(("put", 0, "k", kt + r, (kt + r) & 1))
            if kt + r + 1 < n:
                ev.append(("copy", 0, "k", kt + r + 1, None))
            # place 1: buffer 1, v
            if vt >= 0 and vt + r < n:
                ev.append(("put", 1, "v", vt + r, (vt + r) & 1))
            if vt + r + 1 < n:
                ev.append(("copy", 1, "v", vt + r + 1, None))
    return ev


@pytest.mark.parametrize("n", range(1, 14))
def test_two_buffer_refills(n):
    """Each k and v tile from 2 on is rewritten once, from the copy of it
    a refill earlier; a buffer's next copy is issued only once its last
    was rewritten; and the parity each rewrite waits for is its copy's
    phase on the buffer's mbarrier (one a copy)."""
    copies = {0: [], 1: []}
    pending = {0: None, 1: None}
    put = []
    for kind, buf, stream, tile, parity in two_buffer_refills(n):
        if kind == "copy":
            assert pending[buf] is None, (n, buf, tile)  # the buffer is free
            pending[buf] = (stream, tile)
            copies[buf].append((stream, tile))
        else:
            assert pending[buf] == (stream, tile), (n, buf, tile)
            assert parity == (len(copies[buf]) - 1) & 1, (n, stream, tile)
            pending[buf] = None
            put.append((stream, tile))
    assert pending == {0: None, 1: None}  # no copy left unread
    assert sorted(put) == sorted([("k", m) for m in range(n)] +
                                 [("v", m) for m in range(2, n)])
    assert "mbar_wait(nw.bar_x, (kt + R) & 1);" in FLASH_CU
    assert "mbar_wait(nw.bar_x + 8, (vt + R) & 1);" in FLASH_CU
