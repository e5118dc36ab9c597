"""The port's sharding rules against the JAX package's.

* the cases of ``tests/test_sharding.py`` (the rule table's choices and
  fallbacks) on the port's ``DEFAULT_RULES``;
* every parameter of every arch at full size, under both profiles and on
  four meshes: the port's spec of each serving-``LM`` leaf (one module a
  layer) equals the JAX spec of its stacked leaf with the leading None
  dropped, and the port's JAX-layout tree (``LM.init_params``) gets the
  JAX specs exactly;
* ``batch_shardings`` and ``state_shardings`` over every arch × shape;
* the specs the four ``constrain_*`` functions choose, over drawn shapes
  and mesh sizes, and their exact no-op without a mesh;
* ``to_placements`` on a real 1 × 1 ``DeviceMesh`` (gloo, world size 1):
  a tensor placed by a rule's spec round-trips, and a registered mesh
  redistributes a DTensor at a constraint.

Shapes come from meta tensors (the port) and ``jax.eval_shape`` (JAX):
nothing at full size is allocated.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline CI: deterministic fallback shim
    from tests._hypothesis_compat import given, settings
    from tests._hypothesis_compat import strategies as st

from repro.configs import get_config as jax_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import input_specs as jax_input_specs
from repro.distribution import sharding as jsh
from repro.models.lm import LM as JaxLM
from repro.utils.tree import flatten_with_paths as jax_flatten

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.distribution import sharding as tsh
from repro_torch.distribution.sharding import DEFAULT_RULES, P
from repro_torch.launch.mesh import close_host_mesh, make_host_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.models.lm import layer_plan
from repro_torch.utils.tree import flatten_with_paths

torch.set_num_threads(1)

#: (data, model) or (pod, data, model) sizes of the four meshes
MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "8x1": {"data": 8, "model": 1},
    "1x1": {"data": 1, "model": 1},
}


class FakeMesh:
    """Just enough mesh interface for spec_for (shape lookup)."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _jax_mesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _spec(named_sharding):
    return tuple(named_sharding.spec)


# ------------------------------------ tests/test_sharding.py's rule cases
def test_attention_params_column_row_parallel():
    mesh = FakeMesh(data=16, model=16)
    spec = DEFAULT_RULES.spec_for("seg0/b0/attn/wq/w", (88, 4096, 4096), mesh)
    assert spec == P(None, "data", "model")  # stacked dim unsharded
    spec = DEFAULT_RULES.spec_for("seg0/b0/attn/wo/w", (88, 4096, 4096), mesh)
    assert spec == P(None, "model", "data")
    # the serving LM's per-layer leaf: the same spec without the stacked dim
    spec = DEFAULT_RULES.spec_for("blocks/5/attn/wq/w", (4096, 4096), mesh)
    assert spec == P("data", "model") == ("data", "model")


def test_experts_prefer_ep_then_fall_back_to_tp():
    mesh = FakeMesh(data=16, model=16)
    spec = DEFAULT_RULES.spec_for("seg1/b0/moe/experts/gate", (58, 256, 7168, 2048), mesh)
    assert spec == P(None, "model", "data", None)
    spec = DEFAULT_RULES.spec_for("seg0/b0/moe/experts/gate", (24, 60, 2048, 1408), mesh)
    assert spec == P(None, None, "data", "model")


def test_vocab_sharding_falls_back_when_indivisible():
    mesh = FakeMesh(data=16, model=16)
    assert DEFAULT_RULES.spec_for("embed/table", (129280, 7168), mesh) == P("model", "data")
    assert DEFAULT_RULES.spec_for("embed/table", (92553, 2048), mesh) == P(None, "data")


def test_norms_replicated():
    mesh = FakeMesh(data=16, model=16)
    assert DEFAULT_RULES.spec_for("seg0/b0/norm1/scale", (24, 4096), mesh) == P()


def test_kv_heads_small_dims():
    mesh = FakeMesh(data=16, model=16)
    spec = DEFAULT_RULES.spec_for("seg0/b0/attn/wk/w", (88, 6144, 128), mesh)
    assert spec == P(None, "data", "model")


def test_production_mesh_is_abstract():
    assert make_production_mesh().shape == MESHES["16x16"]
    assert make_production_mesh(multi_pod=True).shape == MESHES["2x16x16"]
    assert list(make_production_mesh(multi_pod=True).shape) == ["pod", "data", "model"]


# ------------------------------------------------- full-size parity sweeps
_JAX_PARAMS = {}


def _jax_params(arch):
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = jax_flatten(
            jax.eval_shape(JaxLM(jax_config(arch)).init, jax.random.PRNGKey(0)))
    return _JAX_PARAMS[arch]


def _jax_path(cfg, name):
    """The JAX tree's path of the serving LM's parameter ``name``, and
    whether that leaf is stacked on a layer dim."""
    parts = name.split(".")
    if parts[0] == "blocks":
        si, i, _, _ = layer_plan(cfg)[int(parts[1])]
        return "/".join([f"seg{si}", f"b{i}", *parts[2:]]), True
    return "/".join(parts), False


@pytest.mark.parametrize("profile", ["default", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_on_every_leaf(arch, profile):
    cfg = get_config(arch)
    jparams = _jax_params(arch)
    model = LM(cfg)
    tree = flatten_with_paths(model.init_params(None))
    assert {p: tuple(t.shape) for p, t in tree.items()} == \
        {p: tuple(l.shape) for p, l in jparams.items()}
    trules, jrules = tsh.RULE_PROFILES[profile], jsh.RULE_PROFILES[profile]
    for mesh_name, sizes in MESHES.items():
        jmesh = FakeMesh(**sizes)
        want = {p: tuple(jrules.spec_for(p, l.shape, jmesh)) for p, l in jparams.items()}
        # the JAX-layout tree: the JAX specs exactly
        got_tree = flatten_with_paths(
            tsh.param_shardings(trules, FakeMesh(**sizes), model.init_params(None)))
        assert {p: tuple(s) for p, s in got_tree.items()} == want, mesh_name
        # the serving LM: a layer's spec is its stacked leaf's without dim 0
        got = tsh.param_shardings(trules, FakeMesh(**sizes), model)
        assert len(got) == sum(1 for n, _ in model.named_parameters())
        for name, spec in got.items():
            path, stacked = _jax_path(cfg, name)
            expect = want[path][1:] if stacked and want[path] else want[path]
            assert tuple(spec) == expect, (mesh_name, name, spec, want[path])


def _outcome(fn):
    """``fn()``, or "duplicate" where it names a mesh axis twice (JAX's
    ``state_shardings`` does under the fsdp profile at decode: its
    ``NamedSharding`` raises, the port's ``PartitionSpec`` too)."""
    try:
        return fn()
    except Exception as e:  # JAX's DuplicateSpecError is private; the port's a ValueError
        if "duplicate entries" not in str(e):
            raise
        return "duplicate"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_state_specs_equal_jax(arch):
    """``batch_shardings`` over ``input_specs`` and ``state_shardings``
    over ``init_decode_state`` for every shape, both profiles, four
    meshes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jmodel = LM(cfg), JaxLM(jcfg)
    for shape_name, shape in SHAPES.items():
        jshape = JAX_SHAPES[shape_name]
        batch = flatten_with_paths(input_specs(cfg, shape))
        jbatch = jax_input_specs(jcfg, jshape)
        assert {p: tuple(t.shape) for p, t in batch.items()} == \
            {p: tuple(l.shape) for p, l in jax_flatten(jbatch).items()}
        state = jstate = None
        if shape.kind == "decode":
            state = model.init_decode_state(shape.global_batch, max_len=shape.seq_len)
            jstate = jax.eval_shape(
                lambda: jmodel.init_decode_state(jshape.global_batch, max_len=jshape.seq_len))
        for profile in ("default", "fsdp"):
            trules, jrules = tsh.RULE_PROFILES[profile], jsh.RULE_PROFILES[profile]
            for sizes in MESHES.values():
                jmesh = _jax_mesh(sizes)
                got = flatten_with_paths(tsh.batch_shardings(trules, FakeMesh(**sizes),
                                                             input_specs(cfg, shape)))
                want = jax_flatten(jsh.batch_shardings(jrules, jmesh, jbatch))
                assert {p: tuple(s) for p, s in got.items()} == \
                    {p: _spec(s) for p, s in want.items()}, (shape_name, sizes)
                if state is None:
                    continue
                got = _outcome(lambda: {p: tuple(s) for p, s in flatten_with_paths(
                    tsh.state_shardings(trules, FakeMesh(**sizes), state)).items()})
                want = _outcome(lambda: {p: _spec(s) for p, s in jax_flatten(
                    jsh.state_shardings(jrules, jmesh, jstate)).items()})
                assert got == want, (shape_name, profile, sizes)


# --------------------------------------------------- activation constraints
_CONSTRAIN = ("constrain_batch", "constrain_moe_buffer", "constrain_heads", "constrain_logits")


def _jax_choice(fn, shape, sizes, rules, monkeypatch):
    """The spec JAX's ``fn`` pins an activation of ``shape`` to (None: it
    returns its input), read off the sharding it hands the constraint."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: s)
    jsh.set_activation_mesh(_jax_mesh(sizes), batch_axes=rules.batch_axes,
                            tp_axis=rules.tp_axis, seq_shard=rules.seq_shard)
    try:
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        out = getattr(jsh, fn)(x)
    finally:
        jsh.set_activation_mesh(None)
        monkeypatch.undo()
    return None if out is x else _spec(out)


def _port_choice(fn, shape, sizes, rules):
    tsh.set_activation_mesh(FakeMesh(**sizes), batch_axes=rules.batch_axes,
                            tp_axis=rules.tp_axis, seq_shard=rules.seq_shard)
    try:
        x = torch.empty(shape, device="meta")
        with tsh.recording_constraints() as records:
            out = getattr(tsh, fn)(x)
        assert out is x  # a plain tensor stays as it is
    finally:
        tsh.set_activation_mesh(None)
    if not records:
        return None
    (rec,) = records
    assert rec["shape"] == tuple(shape) and rec["bytes"] == x.numel() * 4
    return tuple(rec["spec"])


@given(
    dims=st.lists(st.sampled_from([1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 60, 64]),
                  min_size=1, max_size=5),
    mesh=st.sampled_from(sorted(MESHES)),
    profile=st.sampled_from(["default", "fsdp"]),
)
@settings(max_examples=60, deadline=None)
def test_constrain_specs_equal_jax(dims, mesh, profile):
    sizes = MESHES[mesh]
    mp = pytest.MonkeyPatch()
    for fn in _CONSTRAIN:
        want = _jax_choice(fn, tuple(dims), sizes, jsh.RULE_PROFILES[profile], mp)
        got = _port_choice(fn, tuple(dims), sizes, tsh.RULE_PROFILES[profile])
        assert got == want, (fn, dims, mesh, profile)


@pytest.mark.parametrize("fn", _CONSTRAIN)
def test_constrain_without_a_mesh_returns_the_same_object(fn):
    tsh.set_activation_mesh(None)
    x = torch.randn(32, 16, 8, 4)
    with tsh.recording_constraints() as records:
        assert getattr(tsh, fn)(x) is x
    assert records == []


def test_models_pin_activations_where_jax_does():
    """A forward of a tiny MoE LM under a registered mesh records the JAX
    call sites' constraints: batch at block boundaries, the four MoE
    buffers, heads in the chunked attention, the logits."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    model = LM(cfg)
    tokens = torch.empty((4, 2048), dtype=torch.int32, device="meta")
    tsh.set_activation_mesh(FakeMesh(data=2, model=2))
    try:
        with tsh.recording_constraints() as records:
            model(tokens)
    finally:
        tsh.set_activation_mesh(None)
    fns = [r["fn"] for r in records]
    layers = cfg.n_layers
    assert fns.count("moe_buffer") == 4 * layers
    assert fns.count("heads") == 3 * layers  # 2048 > the chunk of 1024
    assert fns.count("logits") == 1
    # embeddings, before each block, each unit's end, each MoE combine
    assert fns.count("batch") == 1 + 2 * layers + layers


# ------------------------------------------------- DTensor on a real mesh
@pytest.fixture
def host_mesh():
    mesh = make_host_mesh(device="cpu")
    yield mesh
    close_host_mesh()
    assert not torch.distributed.is_initialized()


def test_to_placements_round_trips_on_a_host_mesh(host_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    assert host_mesh.mesh_dim_names == ("data", "model")
    g = torch.Generator().manual_seed(0)
    for path, shape in (("blocks/0/attn/wq/w", (64, 96)), ("blocks/0/attn/wo/w", (96, 64)),
                        ("blocks/0/norm1/scale", (64,))):
        spec = DEFAULT_RULES.spec_for(path, shape, host_mesh)
        placements = tsh.to_placements(spec, host_mesh)
        x = torch.randn(shape, generator=g)
        d = distribute_tensor(x, host_mesh, placements)
        assert isinstance(d, DTensor) and tuple(d.placements) == tuple(placements)
        assert torch.equal(d.to_local(), x) and torch.equal(d.full_tensor(), x)
    assert tsh.to_placements(P(("data", "model"), None), host_mesh) == [Shard(0), Shard(0)]
    assert tsh.to_placements(P(None, "model"), host_mesh) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="pod"):
        tsh.to_placements(P("pod"), host_mesh)


def test_a_registered_mesh_redistributes_a_dtensor(host_mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.randn(4, 8, 16)
    d = distribute_tensor(x, host_mesh, [Replicate(), Replicate()])
    tsh.set_activation_mesh(host_mesh)
    try:
        out = tsh.constrain_logits(d)
    finally:
        tsh.set_activation_mesh(None)
    assert tuple(out.placements) == (Replicate(), Shard(2))
    assert torch.equal(out.full_tensor(), x)


def test_host_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert not torch.distributed.is_initialized()


def test_fake_mesh_namespace_is_enough():
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 2})
    assert DEFAULT_RULES.spec_for("blocks/0/mlp/down/w", (8, 6), mesh) == P("model", None)
    assert np.prod(list(tsh.mesh_shape(mesh).values())) == 8
