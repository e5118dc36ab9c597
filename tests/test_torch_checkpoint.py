"""The port's checkpoints are the JAX package's, both ways, on the CPU.

A checkpoint is a manifest of ``{leaf path: blob key}`` committed to a
catalog branch.  Both packages must write the same leaf paths, shapes,
dtypes and blob bytes (so the same values get the same content keys),
read each other's checkpoints, reject a shape mismatch, and carry
bfloat16 leaves (Adafactor's ``m``) without ``ml_dtypes`` in the port.
"""
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.catalog import Catalog as JaxCatalog
from repro.configs import get_smoke_config as jax_smoke_config
from repro.io import ObjectStore as JaxStore
from repro.io.serialization import array_to_bytes
from repro.models import LM as JaxLM
from repro.train import CheckpointManager as JaxCheckpointManager
from repro.train.step import TrainStepConfig as JaxStepConfig
from repro.train.step import make_train_state as jax_make_state
from repro.utils.tree import flatten_with_paths as jax_flatten
from repro_torch.catalog import Catalog
from repro_torch.configs import get_smoke_config
from repro_torch.io import ObjectStore
from repro_torch.io.serialization import bytes_to_tensor, tensor_to_bytes
from repro_torch.models import LM
from repro_torch.train import CheckpointManager, TrainStepConfig
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils.tree import flatten_with_paths, tree_leaves, tree_map

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_tree():
    """(params, Adafactor train state) of the JAX smoke Yi-6B, after one
    step's worth of non-zero moments so no leaf is trivially zero."""
    jm = JaxLM(jax_smoke_config("yi_6b"))
    params = jm.init(jax.random.PRNGKey(0))
    state = jax_make_state(jm, params, JaxStepConfig(optimizer="adafactor"))
    rng = np.random.default_rng(0)
    state["opt"]["m"] = jax.tree_util.tree_map(
        lambda m: jnp.asarray(rng.standard_normal(m.shape), jnp.bfloat16), state["opt"]["m"])
    state["step"] = jnp.int32(5)
    return params, state


def port_like(optimizer="adafactor"):
    """The port's own (params, state) structure on the meta device."""
    model = LM(get_smoke_config("yi_6b"))
    params = model.init_params(None)
    return params, make_train_state(model, params, TrainStepConfig(optimizer=optimizer))


def jax_bytes(x):
    return array_to_bytes(np.asarray(x))


def test_jax_checkpoint_restores_in_the_port_with_equal_bytes(tmp_path, jax_tree):
    mgr = JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi")
    jax_key = mgr.save(jax_tree, branch="main", step=5)
    like = port_like()
    port = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/yi")
    assert port.latest_step(branch="main") == 5
    restored, step = port.restore(like, branch="main", device="cpu")
    assert step == 5
    want = jax_flatten(jax_tree)
    got = flatten_with_paths(restored)
    assert list(got) == list(want)  # the same paths, in the same order
    assert sum(t.dtype == torch.bfloat16 for t in got.values()) == len(jax_flatten(
        jax_tree[1]["opt"]["m"]))
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert tensor_to_bytes(got[k]) == jax_bytes(v), k
    # the port writing the same values writes the same blobs
    port_key = port.save(restored, branch="main", step=5)
    store = ObjectStore(tmp_path)
    jm, pm = (json.loads(store.get(k)) for k in (jax_key, port_key))
    assert jm["leaves"] == pm["leaves"]
    assert set(pm) == set(jm) == {"leaves", "step", "saved_at", "meta"}


def test_port_checkpoint_restores_in_jax_with_equal_bytes(tmp_path, jax_tree):
    model = LM(get_smoke_config("yi_6b"))
    params = model.init_params(torch.Generator().manual_seed(3))
    state = make_train_state(model, params, TrainStepConfig(optimizer="adafactor"))
    gen = torch.Generator().manual_seed(4)
    for m in tree_leaves(state["opt"]["m"]):
        m.copy_(torch.randn(m.shape, generator=gen))
    port = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/yi")
    port.save((params, state), branch="main", step=9)
    jmgr = JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi")
    like = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jax_tree)
    restored, step = jmgr.restore(like, branch="main")
    assert step == 9
    got = flatten_with_paths((params, state))
    want = jax_flatten(restored)
    assert list(got) == list(want)
    for k, v in want.items():
        assert jax_bytes(v) == tensor_to_bytes(got[k]), k
        assert str(v.dtype) == str(got[k].dtype).split(".")[-1], k


def test_params_only_restore_from_a_full_checkpoint(tmp_path, jax_tree):
    """Checking a model out restores its params alone, ``(params_like,)``,
    out of a ``(params, state)`` checkpoint, in both packages."""
    JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi").save(
        jax_tree, branch="main", step=5)
    params_like = port_like()[0]
    (params,), step = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/yi").restore(
        (params_like,), branch="main", device="cpu")
    assert step == 5
    for k, v in jax_flatten(jax_tree[0]).items():
        assert np.array_equal(flatten_with_paths(params)[k].numpy(), np.asarray(v)), k
    jlike = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jax_tree[0])
    (jparams,), _ = JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi").restore(
        (jlike,), branch="main")
    assert len(jax_flatten(jparams)) == len(flatten_with_paths(params))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shape_mismatch_rejected_in_both(tmp_path, writer):
    """A yi-smoke checkpoint restored into granite-smoke's shapes is
    refused by both packages, whichever wrote it."""
    if writer == "jax":
        params = JaxLM(jax_smoke_config("yi_6b")).init(jax.random.PRNGKey(0))
        JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/t").save(
            params, branch="main", step=1)
    else:
        params = LM(get_smoke_config("yi_6b")).init_params(torch.Generator().manual_seed(0))
        CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/t").save(
            params, branch="main", step=1)
    other_port = LM(get_smoke_config("granite_34b")).init_params(None)
    with pytest.raises((ValueError, KeyError)):
        CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/t").restore(
            other_port, branch="main", device="cpu")
    other_jax = JaxLM(jax_smoke_config("granite_34b")).init(jax.random.PRNGKey(0))
    with pytest.raises((ValueError, KeyError)):
        JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/t").restore(
            other_jax, branch="main")


def test_shape_mismatch_names_the_leaf(tmp_path):
    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/t")
    mgr.save({"w": torch.zeros(3, 4)}, branch="main", step=1)
    with pytest.raises(ValueError, match="shape mismatch at w"):
        mgr.restore({"w": torch.empty(4, 3, device="meta")}, branch="main", device="cpu")
    with pytest.raises(KeyError, match="missing leaves"):
        mgr.restore({"v": torch.empty(3, 4, device="meta")}, branch="main", device="cpu")


def test_checkpoint_roundtrip_and_latest_step(tmp_path):
    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/test")
    assert mgr.latest_step(branch="main") is None
    params = LM(get_smoke_config("yi_6b")).init_params(torch.Generator().manual_seed(0))
    mgr.save(params, branch="main", step=7)
    restored, step = mgr.restore(tree_map(lambda t: t.to("meta"), params), branch="main",
                                 device="cpu")
    assert step == 7 and mgr.latest_step(branch="main") == 7
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_bf16_blob_is_the_jax_format():
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    blob = tensor_to_bytes(x)
    assert blob == array_to_bytes(np.asarray(jnp.asarray(x.float().numpy(), jnp.bfloat16)))
    back = bytes_to_tensor(blob)
    assert back.dtype == torch.bfloat16 and torch.equal(back, x)
    zero_d = torch.tensor(7, dtype=torch.int32)
    assert tensor_to_bytes(zero_d) == array_to_bytes(np.int32(7))
    assert bytes_to_tensor(tensor_to_bytes(zero_d)).shape == ()


_NO_ML_DTYPES = r'''
import sys
sys.modules["ml_dtypes"] = None  # importing it now raises
import torch
from repro_torch.catalog import Catalog
from repro_torch.io import ObjectStore
from repro_torch.io.serialization import bytes_to_tensor, tensor_to_bytes
from repro_torch.train import CheckpointManager
from repro_torch.utils.tree import flatten_with_paths

blob = open(sys.argv[2], "rb").read()  # a bf16 blob the JAX package wrote
x = bytes_to_tensor(blob)
assert x.dtype == torch.bfloat16 and tensor_to_bytes(x) == blob
y = torch.linspace(-3, 3, 12).to(torch.bfloat16).reshape(3, 4)
assert torch.equal(bytes_to_tensor(tensor_to_bytes(y)), y)
mgr = CheckpointManager(Catalog(ObjectStore(sys.argv[1])), prefix="models/yi")
like = {"m": torch.empty(x.shape, dtype=torch.bfloat16, device="meta")}
got, step = mgr.restore(like, branch="main", device="cpu")
assert torch.equal(got["m"], x) and step == 3
mgr.save({"m": y}, branch="main", step=4)
assert "ml_dtypes" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
'''


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """In a process where importing ``ml_dtypes`` raises, the port reads a
    bf16 checkpoint the JAX package wrote and writes one the JAX package
    reads back."""
    m = jnp.asarray(np.random.default_rng(1).standard_normal((4, 6)), jnp.bfloat16)
    JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi").save(
        {"m": m}, branch="main", step=3)
    (tmp_path / "blob").write_bytes(array_to_bytes(np.asarray(m)))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_NO_ML_DTYPES), str(tmp_path),
         str(tmp_path / "blob")],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    like = {"m": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)}
    got, step = JaxCheckpointManager(JaxCatalog(JaxStore(tmp_path)), prefix="models/yi").restore(
        like, branch="main")
    want = torch.linspace(-3, 3, 12).to(torch.bfloat16).reshape(3, 4).float().numpy()
    assert step == 4 and np.array_equal(np.asarray(got["m"], np.float32), want)


def test_save_async_commits_the_values_before_an_in_place_step(tmp_path):
    """``save_async`` copies every leaf to the host before it returns: the
    step that follows updates the tensors in place (on the CPU a tensor's
    numpy view shares its memory), and the committed checkpoint still
    holds the values of the moment the save was asked for."""
    model = LM(get_smoke_config("yi_6b"))
    params = model.init_params(torch.Generator().manual_seed(0))
    cfg = TrainStepConfig(peak_lr=1e-2, warmup_steps=0)  # a full-size first step
    state = make_train_state(model, params, cfg)
    before = {k: v.clone() for k, v in flatten_with_paths((params, state)).items()}
    mgr = CheckpointManager(Catalog(ObjectStore(tmp_path)), prefix="models/yi")

    slow_put = mgr.catalog.store.put

    def put(data):  # hold the writer so the step runs first
        time.sleep(0.002)
        return slow_put(data)

    mgr.catalog.store.put = put
    thread = mgr.save_async((params, state), branch="main", step=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)).astype(np.int32))
    make_train_step(model, cfg)(params, state, {"tokens": tokens})
    thread.join(timeout=120)
    assert not thread.is_alive()
    after = flatten_with_paths((params, state))
    assert not torch.equal(after["0/embed/table"], before["0/embed/table"])  # it stepped
    assert int(after["1/step"]) == 1
    like = tree_map(lambda t: t.to("meta"), (params, state))
    restored, step = mgr.restore(like, branch="main", device="cpu")
    assert step == 0
    for k, v in flatten_with_paths(restored).items():
        assert torch.equal(v, before[k]), k
