"""The port's training loop, and a model carried out of the lake, on the CPU.

Mirrors the JAX package's loop tests (``tests/test_train.py``) and the
two examples that make training a lakehouse pipeline: train → commit the
checkpoint to a branch → audit → promote (``examples/train_lm.py``), then
check the model out and serve it (``examples/serve_lm.py``), across the
two packages: a checkpoint one commits, the other resumes or serves.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.catalog import Catalog as JaxCatalog
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import TokenDataset as JaxTokenDataset
from repro.data.tokens import write_token_table as jax_write_token_table
from repro.io import ObjectStore as JaxStore
from repro.models import LM as JaxLM
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.table import TableFormat as JaxTableFormat
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train import TrainLoop as JaxTrainLoop
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import TrainStepConfig as JaxStepConfig
from repro.utils.tree import flatten_with_paths as jax_flatten
from repro_torch.catalog import Catalog
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenDataset, write_token_table
from repro_torch.io import ObjectStore
from repro_torch.models import LM, params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.table import TableFormat
from repro_torch.train import CheckpointManager, TrainLoop, TrainLoopConfig, TrainStepConfig
from repro_torch.utils.tree import flatten_with_paths
from torch_parity import F32, assert_mostly_close

ROOT = Path(__file__).resolve().parents[1]
#: the corpus of the JAX loop tests: a tiled random phrase (learnable)
CORPUS = np.tile(np.random.default_rng(0).integers(0, 64, 256), 10)


def port_loop(root, total_steps, *, ckpt_every=5, sched_steps=15, cfg=None, async_ckpt=False,
              max_final_loss=float("inf"), step_kw=None, branch="train_branch"):
    """The JAX ``_setup_loop`` in the port: a token table in the lake at
    ``root`` (written once), a loop on ``branch`` on the CPU."""
    store = ObjectStore(root)
    catalog, fmt = Catalog(store), TableFormat(store, shard_rows=128)
    key = (catalog.table_key("corpus") if "corpus" in catalog.tables()
           else write_token_table(fmt, catalog, "corpus", CORPUS))
    ds = TokenDataset(fmt, key, batch_size=2, seq_len=16, seed=0)
    step = TrainStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=sched_steps,
                           **(step_kw or {}))
    config = TrainLoopConfig(total_steps=total_steps, checkpoint_every=ckpt_every, log_every=100,
                             async_checkpoint=async_ckpt, max_final_loss=max_final_loss, step=step)
    return TrainLoop(LM(cfg or get_smoke_config("yi_6b")), ds, catalog, branch=branch,
                     config=config, device="cpu")


def jax_loop(root, total_steps, *, ckpt_every=5, sched_steps=15, cfg=None, step_kw=None,
             branch="train_branch"):
    store = JaxStore(root)
    catalog, fmt = JaxCatalog(store), JaxTableFormat(store, shard_rows=128)
    key = (catalog.table_key("corpus") if "corpus" in catalog.tables()
           else jax_write_token_table(fmt, catalog, "corpus", CORPUS))
    ds = JaxTokenDataset(fmt, key, batch_size=2, seq_len=16, seed=0)
    step = JaxStepConfig(peak_lr=1e-3, warmup_steps=2, total_steps=sched_steps, **(step_kw or {}))
    config = JaxLoopConfig(total_steps=total_steps, checkpoint_every=ckpt_every, log_every=100,
                           async_checkpoint=False, step=step)
    return JaxTrainLoop(JaxLM(cfg or jax_smoke_config("yi_6b")), ds, catalog, branch=branch,
                        config=config)


def manifest_of(loop, branch="train_branch"):
    """A branch's checkpoint manifest: each leaf's blob key (its content
    address), the step and the meta."""
    key = loop.catalog.table_key(loop.ckpt._artifact(), branch=branch)
    return json.loads(loop.catalog.store.get(key))


def test_loop_restart_is_bitwise_exact(tmp_path):
    """Uninterrupted run == run killed at step 10 and resumed: every
    leaf equal, and so every leaf's content key in the final manifests."""
    full_loop = port_loop(tmp_path / "a", total_steps=15)
    full = full_loop.run()
    port_loop(tmp_path / "b", total_steps=10).run()  # "crashes" after 10 steps
    resumed_loop = port_loop(tmp_path / "b", total_steps=15)
    resumed = resumed_loop.run()
    assert full["steps_run"] == 15 and resumed["steps_run"] == 5  # resumed from step 10
    a = flatten_with_paths((full["params"], full["state"]))
    b = flatten_with_paths((resumed["params"], resumed["state"]))
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ma, mb = manifest_of(full_loop), manifest_of(resumed_loop)
    assert ma["leaves"] == mb["leaves"] and ma["step"] == mb["step"] == 15
    assert full["losses"][10:] == resumed["losses"]


def test_loop_async_checkpoint(tmp_path):
    loop = port_loop(tmp_path, total_steps=6, ckpt_every=3, async_ckpt=True)
    out = loop.run()
    assert out["steps_run"] == 6
    assert loop.ckpt.latest_step(branch="train_branch") == 6
    log = [c.message for c in loop.catalog.log("train_branch")]
    assert log[:3] == ["checkpoint step=6", "checkpoint step=6 (async)",
                       "checkpoint step=3 (async)"]


def test_failed_audit_is_recorded_and_leaves_main_untouched(tmp_path):
    """Above ``max_final_loss`` the audit fails: the final checkpoint
    records it on the working branch, and main, which only ``promote``
    writes, keeps no checkpoint."""
    loop = port_loop(tmp_path, total_steps=4, max_final_loss=0.0)
    main_before = loop.catalog.head("main").commit_id
    out = loop.run()
    assert out["audit_ok"] is False and np.isfinite(out["final_loss"])
    manifest = manifest_of(loop)
    assert manifest["meta"] == {"final_loss": out["final_loss"], "audit_ok": False}
    assert loop.catalog.head("main").commit_id == main_before
    assert loop.ckpt.latest_step(branch="main") is None
    passing = port_loop(tmp_path, total_steps=6, max_final_loss=1e9)
    out = passing.run()  # resumes from step 4 on the same branch
    assert out["audit_ok"] is True and out["steps_run"] == 2
    passing.promote("main")
    assert passing.ckpt.latest_step(branch="main") == 6


def test_loop_runs_on_the_jax_layout_and_reduces_loss(tmp_path):
    out = port_loop(tmp_path, total_steps=15, sched_steps=15).run()
    assert out["losses"][-1] < out["losses"][0]
    paths = flatten_with_paths((out["params"], out["state"]))
    assert tuple(paths["0/seg0/b0/attn/wq/w"].shape) == (2, 64, 64)
    assert int(paths["1/step"]) == 15 and int(out["state"]["opt"]["count"]) == 15


def test_training_with_the_flash_kernel_is_refused(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("yi_6b"), use_flash_kernel=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        port_loop(tmp_path, total_steps=2, cfg=cfg).run()


# ------------------------------------------------------------ across packages
F32_COMPUTE = dict(compute_cast=None)


def test_cross_package_resume_matches_jax(tmp_path):
    """JAX trains 3 steps and commits; the port resumes that checkpoint, on
    the lake the JAX package wrote, to step 6; the result matches JAX's own
    6 steps (float32 compute: ``assert_mostly_close`` with F32, an update
    bounded by lr a step)."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"), compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("yi_6b"), compute_dtype=torch.float32)
    jax_loop(tmp_path / "mixed", total_steps=3, ckpt_every=100, cfg=jcfg,
             step_kw=F32_COMPUTE).run()
    port = port_loop(tmp_path / "mixed", total_steps=6, ckpt_every=100, cfg=pcfg,
                     step_kw=F32_COMPUTE)
    mixed = port.run()
    assert mixed["steps_run"] == 3
    own = jax_loop(tmp_path / "jax", total_steps=6, ckpt_every=100, cfg=jcfg,
                   step_kw=F32_COMPUTE).run()
    got = flatten_with_paths((mixed["params"], mixed["state"]))
    want = jax_flatten((own["params"], own["state"]))
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v).astype(np.float32)
        top = np.abs(v).max()
        if k.startswith("0/"):
            assert_mostly_close(got[k].numpy(), v, rtol=F32, atol=F32 * 1e-3 * 6,
                                bound=2 * 1e-3 * 6, key=k)
        else:
            assert_mostly_close(got[k].float().numpy(), v, rtol=F32, atol=F32 * top,
                                bound=2e-2 * top, key=k)
    np.testing.assert_allclose(mixed["losses"], own["losses"][3:], rtol=F32)
    assert port.ckpt.latest_step(branch="train_branch") == 6


def test_checked_out_jax_model_serves_jax_greedy_tokens(tmp_path):
    """``examples/serve_lm.py`` across packages: the JAX ``TrainLoop``
    trains and commits to main; the port checks the params out of main,
    builds its ``LM`` with ``params_from_numpy`` and serves with its
    ``ServeEngine`` on the CPU; the greedy tokens equal those of the JAX
    ``ServeEngine`` on the same checkpoint (float32 compute)."""
    jcfg = dataclasses.replace(jax_smoke_config("yi_6b"), compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("yi_6b"), compute_dtype=torch.float32)
    jax_loop(tmp_path, total_steps=12, ckpt_every=6, sched_steps=12, cfg=jcfg,
             step_kw=F32_COMPUTE, branch="main").run()

    jm = JaxLM(jcfg)
    like = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    (jparams,), jstep = JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)),
                                             prefix="models/yi-smoke").restore((like,),
                                                                              branch="main")
    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/yi-smoke")
    (params,), step = mgr.restore((LM(pcfg).init_params(None),), branch="main", device="cpu")
    assert step == jstep == 12
    model = params_from_numpy(params, pcfg, device="cpu")

    prompts = [[5, 6, 7], [100, 101], [200], [1, 2, 3, 4]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=8) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=8) for p in prompts]
    JaxServeEngine(jm, jparams, JaxServeConfig(max_batch=3, max_len=64)).generate(jreqs)
    ServeEngine(model, None, ServeConfig(max_batch=3, max_len=64), device="cpu").generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 8 for r in preqs)


def test_params_round_trip_between_the_tree_and_the_serving_lm():
    from repro_torch.models import params_to_numpy

    cfg = get_smoke_config("yi_6b")
    tree = LM(cfg).init_params(torch.Generator().manual_seed(1))
    model = params_from_numpy(tree, cfg, device="cpu")
    back = params_to_numpy(model)
    flat = flatten_with_paths(tree)
    assert list(flatten_with_paths(back)) == list(flat)
    for k, v in flatten_with_paths(back).items():
        # matmul weights and the table come back through the bf16 cast
        want = flat[k].to(torch.bfloat16).float() if k.endswith(("/w", "/table")) else flat[k]
        assert np.array_equal(v, want.numpy()), k
    rebuilt = params_from_numpy(back, cfg, device="cpu")
    for (k, a), (_, b) in zip(model.state_dict().items(), rebuilt.state_dict().items()):
        assert torch.equal(a, b), k
    # the served copy shares nothing with the tree it came from
    next(iter(flat.values())).add_(1.0)
    assert torch.equal(model.state_dict()["embed.table"], rebuilt.state_dict()["embed.table"])


def test_launch_train_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b", "--smoke",
         "--device", "cpu", "--steps", "6", "--lake", str(tmp_path / "lake")],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert "yi-smoke: 6 steps" in proc.stdout and "audit_ok=True" in proc.stdout
    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path / "lake")), prefix="models/yi-smoke")
    assert mgr.latest_step(branch="train") == 6
