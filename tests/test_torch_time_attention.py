"""tools/time_attention.py, checked on the CPU: its rows are chip_smoke's
(one table of the configs' attention shapes, ``ATTENTION_ROWS``), and the
script refuses to run without a CUDA device."""
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def test_the_rows_are_the_perf_tables():
    """The rows are the configs' head layouts on the main paths (granite-34b
    and recurrentgemma-9b among them), every one at a head dim both
    kernels take; the script reads them from chip_smoke and keeps no copy."""
    rows = chip_smoke.ATTENTION_ROWS
    assert rows["granite-34b"] == (48, 1, 128, None, 4)
    assert rows[chip_smoke.HYBRID_ARCH] == (16, 1, 256, 2048, 1)
    assert set(chip_smoke.FAMILY_ARCHS) | set(chip_smoke.FULL_ARCHS) <= set(rows)
    for h, hkv, d, window, b in rows.values():
        assert h % hkv == 0 and d in (64, 80, 120, 128, 256) and b in (1, 4)
        assert window is None or window > 0
    text = (ROOT / "tools" / "time_attention.py").read_text()
    assert "cs.ATTENTION_ROWS" in text and "def ptxas" not in text


def test_it_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "time_attention.py")],
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr and not proc.stdout.strip()


def test_the_float32_rows_are_chip_smokes():
    """The float32 rows (flash_tf32 and decode_split<f32, D>) are at the
    heads of chip_smoke's FLOAT32_ARCHS, Yi-6B's (phase 6h's path) first,
    and flash at head dim 32 at D32_HEADS; the script reads both from
    chip_smoke and names the kernel each row launched."""
    assert chip_smoke.FLOAT32_ARCHS[0] == "yi-6b"
    assert set(chip_smoke.FLOAT32_ARCHS) <= set(chip_smoke.ATTENTION_ROWS)
    assert chip_smoke.ATTENTION_ROWS[chip_smoke.FLOAT32_ARCHS[-1]][4] == 1  # B = 1 at 16/1 x 256
    h, hkv = chip_smoke.D32_HEADS
    assert h % hkv == 0
    text = (ROOT / "tools" / "time_attention.py").read_text()
    for name in ("cs.FLOAT32_ARCHS", "cs.D32_HEADS", "fops.kernel_name(dtype, d)",
                 "dops.decode_kernel(dtype, h // hkv, d)"):
        assert name in text


def test_the_wide_decode_rows_are_chip_smokes():
    """decode_wide's timed rows: 32/4 x WIDE_TIMED_DIM in all three dtypes,
    one whose last 128-column slice is partial (576) and one whose rows are
    not whole 16-byte pieces (515 bf16 elements), every one above head dim
    256 at B = 4; the script reads them from chip_smoke, keeps them under
    ``--only wide`` and prints decode_wide's SASS counts (HMMA among them)."""
    rows = chip_smoke.WIDE_TIMED_DECODE
    assert {name for h, hkv, d, name in rows if (h, hkv, d) == (32, 4, chip_smoke.WIDE_TIMED_DIM)} \
        == {"bfloat16", "float16", "float32"}
    assert all(d > 256 and h % hkv == 0 for h, hkv, d, _ in rows)
    assert any(d % 128 for _, _, d, name in rows if d * 2 % 16 == 0)
    assert any(d * 2 % 16 for _, _, d, name in rows if name != "float32")
    text = (ROOT / "tools" / "time_attention.py").read_text()
    for name in ("cs.WIDE_TIMED_DECODE", 'f"wide decode', 'r"decode_wide"', "cs.sass_counts"):
        assert name in text
    # the counts are chip_smoke's (HMMA among them)
    assert '"HMMA"' in (ROOT / "chip_smoke.py").read_text()
