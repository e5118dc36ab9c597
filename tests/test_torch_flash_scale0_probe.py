"""tools/flash_scale0_probe.py, checked on the CPU: it draws phase 5's
scale-0 cases from a seed of its own, runs them under the bf16 flash rule,
and refuses to run on the card's default without one."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


probe = _load("flash_scale0_probe", ROOT / "tools" / "flash_scale0_probe.py")
chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")


def test_the_plain_version_meets_the_rule_at_every_case(capsys):
    """On the CPU the wrapper runs its plain version, so no case fails; the
    totals count every shape and mask of phase 5's scale cases a seed."""
    assert probe.main(["--seeds", "1", "--first", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    total = json.loads(lines[0])
    assert total == {"device": "cpu", "seeds": [3, 3], "failed": 0,
                     "cases": len(chip_smoke.SCALE_SHAPES) * len(chip_smoke.FLASH_MASKS)}


def test_phase5_and_the_probe_share_the_scale_cases():
    """Phase 5 draws its bf16 scale cases at SCALE_SHAPES and SCALE_LEN, the
    probe's shapes, and the cases it runs at scale 0 are among them."""
    text = (ROOT / "chip_smoke.py").read_text()
    assert "for d, h, hkv in SCALE_SHAPES:" in text
    assert 0.0 in chip_smoke.D64_SCALES and 0.0 in chip_smoke.D256_SCALES
    assert {d for d, _, _ in chip_smoke.SCALE_SHAPES} == {64, 256}


def test_it_fails_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "flash_scale0_probe.py")],
                          capture_output=True, text=True)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr and not proc.stdout.strip()
