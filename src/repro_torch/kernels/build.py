"""Build a kernel's CUDA source into a shared library and load it.

Each kernel's ``csrc/*.cu`` has a plain C interface, so ``nvcc`` compiles
it in seconds (no PyTorch headers) into ``build/kernels/`` at the root of
the checkout.  The library's
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The wrapper binds it
with ``ctypes``.  Nothing here runs when a module is imported: the build
happens at a kernel's first launch, or when a caller asks for it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

#: Hopper only: keep the "a" so wgmma/setmaxnreg stay available
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: ptxas's report (registers, shared memory, spills) and the build time
#: of each library built in this process, by source stem
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def load_library(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content) and load it."""
    source = Path(source).resolve()
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
        digest = hashlib.sha256(
            source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"{source.stem}-{digest}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True,
            )
            BUILD_SECONDS[source.stem] = time.perf_counter() - t0
            BUILD_LOG[source.stem] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[source] = lib
        return lib
