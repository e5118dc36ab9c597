"""The port stands alone: no jax, nothing of ``repro``, no silent CPU.

* every ``repro_torch`` module imports in a fresh interpreter in which
  importing ``jax`` or ``repro`` raises;
* no source file of the port, and not ``chip_smoke.py``, names ``jax`` or
  ``repro`` in an import statement (``repro_torch`` excepted);
* the entry points, left at their default device, raise when no CUDA
  device exists instead of running on the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print(len(names))
'''


def test_every_module_imports_with_jax_and_repro_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30


def _forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}:{node.lineno}: {name}")
    return bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    assert _forbidden_imports(path) == []


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro.engine\nfrom jax import numpy\nimport repro_torch\n")
    assert len(_forbidden_imports(probe)) == 2


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")


def test_runner_default_device_raises_without_cuda(no_cuda, tmp_path):
    from repro_torch.catalog import Catalog
    from repro_torch.core import Runner
    from repro_torch.io import ObjectStore
    from repro_torch.table import TableFormat

    store = ObjectStore(tmp_path / "lake")
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(Catalog(store), TableFormat(store))
    assert Runner(Catalog(store), TableFormat(store), device="cpu").device.type == "cpu"


def test_columnar_default_device_raises_without_cuda(no_cuda):
    from repro_torch.engine import Columnar

    cols = {"a": np.arange(4, dtype=np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        Columnar.from_numpy(cols)
    with pytest.raises(RuntimeError, match="CUDA"):
        Columnar.from_arrays(cols)
    assert Columnar.from_numpy(cols, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
