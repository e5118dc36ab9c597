"""The port stands alone: no jax, nothing of ``repro``, no silent CPU.

* every ``repro_torch`` module imports in a fresh interpreter in which
  importing ``jax``, ``ml_dtypes`` or ``repro`` raises;
* no source file of the port, nor ``chip_smoke.py``, ``tools/`` or the
  example editions (``examples/torch_*.py``), names ``jax``,
  ``ml_dtypes`` or ``repro`` in an import statement (``repro_torch``
  excepted);
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
SOURCES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "tools").glob("*.py"))
           + sorted((ROOT / "examples").glob("torch_*.py")))

_BLOCKED_IMPORT = r'''
import importlib, pkgutil, sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "ml_dtypes", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not leaked, leaked
print(" ".join(names))
'''


def test_every_module_imports_with_jax_and_repro_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 30
    assert {"repro_torch.train.step", "repro_torch.train.checkpoint", "repro_torch.train.loop",
            "repro_torch.data.tokens", "repro_torch.distribution.compression",
            "repro_torch.utils.tree", "repro_torch.launch.train",
            "repro_torch.models.moe", "repro_torch.configs.shapes",
            "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.configs.internvl2_2b",
            "repro_torch.configs.musicgen_medium", "repro_torch.models.rglru",
            "repro_torch.configs.recurrentgemma_9b", "repro_torch.models.xlstm",
            "repro_torch.models.mla", "repro_torch.configs.xlstm_350m",
            "repro_torch.configs.deepseek_v3_671b", "repro_torch.distribution.sharding",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.roofline"} <= names


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
            if name.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"):
                bad.append(f"{path.name}:{node.lineno}: {name}")
    return bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    assert _forbidden_imports(path) == []


def test_scan_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro.engine\nfrom jax import numpy\nimport repro_torch\n"
                     "import ml_dtypes\n")
    assert len(_forbidden_imports(probe)) == 3


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


def test_pipeline_run_default_device_raises_without_cuda(no_cuda, tmp_path):
    """``Runner(catalog, fmt, ServerlessExecutor(...))`` — the entry point
    of a pipeline run — raises at the default device instead of running
    the pipeline on the CPU; with ``device="cpu"`` the run goes through."""
    from repro_torch.catalog import Catalog
    from repro_torch.core import Runner
    from repro_torch.examples_data import TAXI_SCHEMA, build_taxi_pipeline, make_taxi_data
    from repro_torch.io import ObjectStore
    from repro_torch.runtime import ExecutorConfig, ServerlessExecutor
    from repro_torch.table import TableFormat

    store = ObjectStore(tmp_path / "lake")
    fmt, catalog = TableFormat(store, shard_rows=128), Catalog(store)
    snap = fmt.write("taxi_table", TAXI_SCHEMA, make_taxi_data(256, np.random.default_rng(0)))
    catalog.commit("main", {"taxi_table": fmt.manifest_key(snap)})
    with ServerlessExecutor(ExecutorConfig(max_workers=1)) as ex:
        with pytest.raises(RuntimeError, match="CUDA"):
            Runner(catalog, fmt, ex).run(build_taxi_pipeline(), cache=False)
        assert catalog.branches() == ["main"]  # nothing was started
        result = Runner(catalog, fmt, ex, device="cpu").run(build_taxi_pipeline(), cache=False)
        assert result.ok and result.checks == {"trips_expectation": True}


def test_columnar_default_device_raises_without_cuda(no_cuda):
    from repro_torch.engine import Columnar

    cols = {"a": np.arange(4, dtype=np.int32)}
    with pytest.raises(RuntimeError, match="CUDA"):
        Columnar.from_numpy(cols)
    with pytest.raises(RuntimeError, match="CUDA"):
        Columnar.from_arrays(cols)
    assert Columnar.from_numpy(cols, device="cpu").device.type == "cpu"


def test_serve_engine_default_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeConfig, ServeEngine

    model = LM(get_smoke_config("yi-6b")).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(model, None, ServeConfig(max_batch=1, max_len=8))
    engine = ServeEngine(model, None, ServeConfig(max_batch=1, max_len=8), device="cpu")
    assert engine.device.type == "cpu"


def test_params_from_numpy_default_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import params_from_numpy

    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({}, get_smoke_config("yi-6b"))


def test_host_mesh_default_device_raises_without_cuda(no_cuda):
    """``make_host_mesh()`` — the DTensor entry point — raises at the
    default device before it opens a process group; ``device="cpu"``
    makes a 1 x 1 gloo mesh, and ``close_host_mesh`` tears it down."""
    from repro_torch.launch.mesh import close_host_mesh, make_host_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert not torch.distributed.is_initialized()
    mesh = make_host_mesh(device="cpu")
    try:
        assert mesh.device_type == "cpu" and tuple(mesh.mesh.shape) == (1, 1)
    finally:
        close_host_mesh()
    assert not torch.distributed.is_initialized()


def test_time_serve_refuses_to_run_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "time_serve.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


def test_time_filter_agg_refuses_to_run_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "time_filter_agg.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_to_run_without_cuda(no_cuda):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_client_default_device_raises_without_cuda(no_cuda, tmp_path):
    """``Client(path)`` — the SDK's one construction path — raises at the
    default device before it touches the lake; ``device="cpu"`` goes
    through and runs queries and pipelines on the CPU."""
    import repro_torch
    from repro_torch.examples_data import TAXI_SCHEMA, make_taxi_data

    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.Client(tmp_path / "lake")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.Client.ephemeral()
    assert not (tmp_path / "lake").exists()
    with repro_torch.Client(tmp_path / "lake", shard_rows=128, device="cpu") as client:
        client.write_table("taxi_table", make_taxi_data(256, np.random.default_rng(0)),
                           schema=TAXI_SCHEMA)
        assert client.query("SELECT COUNT(*) AS n FROM taxi_table")["n"][0] == 256
        assert client.runner.device.type == "cpu"


def test_cli_default_device_exits_nonzero_without_cuda(no_cuda, tmp_path):
    from repro_torch.examples_data import TAXI_SCHEMA, make_taxi_data
    from repro_torch.api import Client

    lake = tmp_path / "lake"
    with Client(lake, device="cpu") as client:
        client.write_table("taxi_table", make_taxi_data(100, np.random.default_rng(0)),
                           schema=TAXI_SCHEMA)

    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.cli", *argv],
            capture_output=True, text=True, cwd=tmp_path, timeout=300,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        )

    query = ["query", "-q", "SELECT COUNT(*) AS n FROM taxi_table"]
    refused = cli("--lake", str(lake), *query)
    assert refused.returncode != 0
    assert "no CUDA device" in refused.stderr and "--device cpu" in refused.stderr
    assert refused.stdout == ""
    ran = cli("--device", "cpu", "--lake", str(lake), *query)
    assert ran.returncode == 0, ran.stderr
    assert "100" in ran.stdout


def _train_loop(root, device_kw):
    from repro_torch.catalog import Catalog
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenDataset, write_token_table
    from repro_torch.io import ObjectStore
    from repro_torch.models import LM
    from repro_torch.table import TableFormat
    from repro_torch.train import TrainLoop, TrainLoopConfig

    store = ObjectStore(root)
    catalog, fmt = Catalog(store), TableFormat(store, shard_rows=128)
    key = write_token_table(fmt, catalog, "corpus", np.arange(400) % 64)
    ds = TokenDataset(fmt, key, batch_size=2, seq_len=8)
    return TrainLoop(LM(get_smoke_config("yi-6b")), ds, catalog, branch="train",
                     config=TrainLoopConfig(total_steps=2, checkpoint_every=10), **device_kw)


def test_train_loop_default_device_raises_without_cuda(no_cuda, tmp_path):
    """``TrainLoop`` at the default device raises before it trains or
    touches a branch; with ``device="cpu"`` it trains and commits."""
    with pytest.raises(RuntimeError, match="CUDA"):
        _train_loop(tmp_path / "a", {})
    loop = _train_loop(tmp_path / "b", {"device": "cpu"})
    assert loop.run()["steps_run"] == 2
    assert loop.ckpt.latest_step(branch="train") == 2


def test_checkpoint_restore_default_device_raises_without_cuda(no_cuda, tmp_path):
    import torch as _torch

    from repro_torch.catalog import Catalog
    from repro_torch.io import ObjectStore
    from repro_torch.train import CheckpointManager

    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path)))
    mgr.save({"w": _torch.ones(3)}, branch="main", step=1)
    like = {"w": _torch.empty(3, device="meta")}
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(like, branch="main")
    restored, step = mgr.restore(like, branch="main", device="cpu")
    assert step == 1 and restored["w"].device.type == "cpu"


def test_launch_train_default_device_exits_nonzero_without_cuda(no_cuda, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b", "--smoke",
         "--steps", "2", "--lake", str(tmp_path / "lake")],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "device='cpu'" in proc.stderr
    assert not (tmp_path / "lake").exists()
