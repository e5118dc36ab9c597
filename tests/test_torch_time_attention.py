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
