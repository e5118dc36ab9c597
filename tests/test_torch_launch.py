"""The port's planner (``repro_torch.launch.{mesh,dryrun,roofline}``)
against the JAX package's launch layer.

* the cases of ``tests/test_launch_utils.py`` on the port's modules: the
  ring formulas (:func:`dryrun.wire_bytes` held to the JAX
  ``parse_collectives`` on HLO lines), ``extrapolate``, ``model_flops``,
  the MoE's active fraction, cells and skips, input specs, aliases;
* ``active_params`` and ``model_flops`` exactly equal to JAX's for every
  arch and shape;
* the optimizer state's specs (``state_shardings_like_params``) equal to
  JAX's for every arch at full size, both profiles;
* ``lower_cell`` on tiny configs at a one-device mesh: its byte fields
  equal to the JAX ``lower_cell``'s (XLA's compile on the CPU), for
  cells that cover every kind, the block kinds, the MTP head and
  codebooks (the optimizer state's bytes at full size, every arch).
  Its FLOPs beside XLA's: the port counts
  matmul-class ops (``FlopCounterMode``), XLA every elementwise op too,
  so at these tiny widths the ratio port / XLA is 0.45–0.62 for decode
  (norms, RoPE and the softmax weigh most beside B = 2 rows of
  products) and 0.86–1.23 for train and prefill (the xLSTM's float32
  chunk scan is where the port counts more: it takes the in-chunk
  products over the whole chunk); the band held is [0.4, 1.3].  Its
  bytes beside XLA's (``bytes accessed``): the port sums eager ops'
  traffic with no fusion (more at prefill and train), and writes a
  decode step's cache rows by index where the JAX step rewrites the
  whole cache through a one-hot (less at decode); the band held is
  [0.2, 2.5];
* the CLIs in subprocesses, writing only ``results/torch_*``;
* the roofline on the H100 SXM's figures, and no TPU figure in the port.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # offline CI: deterministic fallback shim
    from tests._hypothesis_compat import given, settings
    from tests._hypothesis_compat import strategies as st

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import WorkloadShape as JaxShape
from repro.distribution import sharding as jsh
from repro.models.lm import LM as JaxLM
from repro.utils.tree import flatten_with_paths as jax_flatten

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, resolve
from repro_torch.configs.shapes import SHAPES, WorkloadShape, cells, input_specs
from repro_torch.distribution import sharding as tsh
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.train.step import make_train_state
from repro_torch.utils.tree import flatten_with_paths

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _jax_launch():
    """The JAX package's dryrun and roofline modules.  Importing them sets
    ``XLA_FLAGS`` for 512 host devices; the backend is brought up first,
    so this process keeps its one device, and the variable is restored."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
        from repro.launch import roofline as jr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd, jr


# ------------------------------------------ tests/test_launch_utils.py
_HLO = """
  %ag = f32[4096,256]{1,0} all-gather(%x), channel_id=1, replica_groups=[32,16]<=[512], dimensions={0}
  %ar = bf16[1024]{0} all-reduce(%y), replica_groups=[16,32]<=[512], to_apply=%sum
  %rs = f32[64,64]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(%w), source_target_pairs={{0,1}}
  %other = f32[10]{0} add(%a, %b)
"""


def test_wire_bytes_equal_parse_collectives_on_hlo():
    jd, _ = _jax_launch()
    want = jd.parse_collectives(_HLO)
    for op, result, n in (("all-gather", 4096 * 256 * 4, 16), ("all-reduce", 1024 * 2, 32),
                          ("reduce-scatter", 64 * 64 * 4, 4), ("collective-permute", 8 * 8 * 2, 1)):
        assert want[op]["result_bytes"] == result
        assert dryrun.wire_bytes(op, result, n) == pytest.approx(want[op]["wire_bytes"])
    assert want["all-to-all"]["count"] == 0
    np.testing.assert_allclose(dryrun.wire_bytes("all-gather", 4096 * 256 * 4, 16),
                               4096 * 256 * 4 * 15 / 16)
    np.testing.assert_allclose(dryrun.wire_bytes("reduce-scatter", 64 * 64 * 4, 4),
                               64 * 64 * 4 * 3)
    with pytest.raises(ValueError):
        dryrun.wire_bytes("broadcast", 1, 2)


@given(
    op=st.sampled_from(["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                        "collective-permute"]),
    dims=st.lists(st.integers(1, 64), min_size=1, max_size=3),
    dtype=st.sampled_from([("f32", 4), ("bf16", 2), ("s32", 4), ("s8", 1)]),
    n=st.sampled_from([1, 2, 4, 16, 32]),
)
@settings(max_examples=40, deadline=None)
def test_wire_bytes_equal_parse_collectives_drawn(op, dims, dtype, n):
    jd, _ = _jax_launch()
    name, size = dtype
    groups = f"replica_groups=[{512 // n},{n}]<=[512]"
    line = f"  %c = {name}[{','.join(map(str, dims))}]{{0}} {op}(%x), {groups}\n"
    want = jd.parse_collectives(line)[op]
    result = int(np.prod(dims)) * size
    assert want["count"] == 1 and want["result_bytes"] == result
    assert dryrun.wire_bytes(op, result, n) == pytest.approx(want["wire_bytes"])


def test_extrapolate_linear_depth():
    var = {
        "counts": [10, 3],
        "v0": {"flops": 100.0},
        "v1": {"flops": 130.0},  # +30 per unit of segment 0
        "v2": {"flops": 120.0},  # +20 per unit of segment 1
    }
    # 100 + 9*30 + 2*20 = 410
    assert roofline.extrapolate(var, "flops") == pytest.approx(410.0)
    _, jr = _jax_launch()
    assert roofline.extrapolate(var, "flops") == jr.extrapolate(var, "flops")


def test_model_flops_train_vs_decode():
    cfg = get_config("yi_6b")
    train = roofline.model_flops(cfg, SHAPES["train_4k"], "train")
    decode = roofline.model_flops(cfg, SHAPES["decode_32k"], "decode")
    assert train / decode == pytest.approx(
        3 * SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len
        / SHAPES["decode_32k"].global_batch
    )


def test_moe_active_params_fraction():
    total, active = roofline.active_params(get_config("deepseek_v3_671b"))
    assert 600e9 < total < 750e9  # ~671B
    assert 30e9 < active < 60e9  # ~37B active
    t2, a2 = roofline.active_params(get_config("yi_6b"))
    assert t2 == a2  # dense: all params active


def test_cells_and_skips():
    live, skipped = cells({a: get_config(a) for a in ARCH_IDS})
    assert len(live) == 33  # 10*3 + 3 long_500k
    assert len(skipped) == 7
    skipped_archs = {a for a, s, _ in skipped}
    assert "h2o_danube_3_4b" not in skipped_archs  # SWA runs long_500k
    assert "xlstm_350m" not in skipped_archs
    assert "recurrentgemma_9b" not in skipped_archs


def test_input_specs_shapes():
    cfg = get_config("musicgen_medium")
    spec = input_specs(cfg, SHAPES["train_4k"])
    assert spec["tokens"].shape == (256, 4096, 4)  # codebooks
    vlm = get_config("internvl2_2b")
    spec = input_specs(vlm, SHAPES["train_4k"])
    assert spec["tokens"].shape == (256, 4096 - 256)
    assert spec["patch_embeds"].shape == (256, 256, 2048)
    dec = input_specs(cfg, SHAPES["decode_32k"])
    assert dec["tokens"].shape == (128, 1, 4)
    assert dec["lengths"].shape == (128,)


def test_registry_aliases():
    assert resolve("yi-6b") == "yi_6b"
    assert resolve("deepseek-v3-671b") == "deepseek_v3_671b"
    with pytest.raises(KeyError):
        resolve("gpt-5")
    assert len(ARCH_IDS) == 10


# ------------------------------------------------------- exact parity
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_jax(arch):
    _, jr = _jax_launch()
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert roofline.active_params(cfg) == jr.active_params(jcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape, shape.kind) == \
            jr.model_flops(jcfg, JAX_SHAPES[name], shape.kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_optimizer_state_specs_equal_jax(arch):
    jd, _ = _jax_launch()
    from repro.train.step import make_train_state as jax_train_state

    cfg, jcfg = get_config(arch), jax_config(arch)
    model, jmodel = LM(cfg), JaxLM(jcfg)
    params = model.init_params(None)
    state = make_train_state(model, params, dryrun._train_step_cfg(arch))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    jstate = jax.eval_shape(lambda p: jax_train_state(jmodel, p, jd._train_step_cfg(arch)),
                            jparams)
    got_shapes = {p: tuple(t.shape) for p, t in flatten_with_paths(state).items()}
    assert got_shapes == {p: tuple(l.shape) for p, l in jax_flatten(jstate).items()}
    # the dry-run's state_bytes_global: the JAX dry-run's tree_size_bytes
    from repro.utils.tree import tree_size_bytes as jax_bytes
    from repro_torch.utils.tree import tree_size_bytes

    assert tree_size_bytes(state) == jax_bytes(jstate)
    assert tree_size_bytes(params) == jax_bytes(jparams)
    for profile in ("default", "fsdp"):
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            jmesh = jax.sharding.AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
            got = dryrun.state_shardings_like_params(tsh.RULE_PROFILES[profile], mesh,
                                                     params, state)
            want = jd.state_shardings_like_params(jsh.RULE_PROFILES[profile], jmesh,
                                                  jparams, jstate)
            assert {p: tuple(s) for p, s in flatten_with_paths(got).items()} == \
                {p: tuple(s.spec) for p, s in jax_flatten(want).items()}, (profile, multi)


#: (arch, kind) of the tiny cells: every kind of Yi; deepseek's MTP head
#: and musicgen's lm_head, pruned when serving; the xLSTM's time loops
#: (decode reads no lengths) and the RG-LRU when serving.  A train step
#: reads every leaf (the optimizer updates each), so its arguments are the
#: state's bytes, which ``test_optimizer_state_specs_equal_jax`` holds at
#: full size for every arch; the other train steps take XLA 3-13 s each
#: to compile here
_TINY_CELLS = [("yi_6b", "train"), ("yi_6b", "prefill"), ("yi_6b", "decode"),
               ("deepseek_v3_671b", "prefill"), ("deepseek_v3_671b", "decode"),
               ("musicgen_medium", "decode"), ("xlstm_350m", "prefill"),
               ("xlstm_350m", "decode"), ("recurrentgemma_9b", "prefill"),
               ("recurrentgemma_9b", "decode")]


@pytest.mark.parametrize("arch, kind", _TINY_CELLS)
def test_lower_cell_bytes_equal_jax_on_a_tiny_cell(arch, kind):
    """Every segment at one unit, so XLA's cost analysis (which counts a
    scan body once) sees the whole model and its FLOPs compare."""
    jd, jr = _jax_launch()
    seq, batch = 64, 2
    jcfg = jr._variant_config(jax_smoke(arch), [1] * len(jax_smoke(arch).segments))
    cfg = roofline.variant_config(get_smoke_config(arch),
                                  [1] * len(get_smoke_config(arch).segments))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    try:
        want = jd.lower_cell(arch, JaxShape("tiny", seq, batch, kind), jmesh, cfg_override=jcfg)
    finally:
        jsh.set_activation_mesh(None)
    got = dryrun.lower_cell(arch, WorkloadShape("tiny", seq, batch, kind),
                            AbstractMesh({"data": 1, "model": 1}), cfg_override=cfg)
    for key in ("param_bytes_global", "state_bytes_global", "decode_state_bytes_global",
                "optimizer", "kind", "shape", "mesh"):
        assert got.get(key) == want.get(key), key
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    assert set(got) >= set(want)
    flops = got["flops_per_device"] / want["flops_per_device"]
    moved = got["bytes_per_device"] / want["bytes_per_device"]
    print(f"{arch} {kind}: port / XLA FLOPs {flops:.3f}, bytes {moved:.3f}")
    assert 0.4 <= flops <= 1.3, flops
    assert 0.2 <= moved <= 2.5, moved
    assert all(c["wire_bytes"] == 0 for c in got["collectives"].values())


def test_time_loops_extrapolate_exactly():
    """An xLSTM cell counted at S = 64 and 128 and taken to S gives what a
    direct count at S gives (S = 256: four chunks, 256 sLSTM steps)."""
    cfg = get_smoke_config("xlstm_350m")
    mesh = AbstractMesh({"data": 1, "model": 1})
    shape = WorkloadShape("s256", 256, 2, "prefill")
    got = dryrun.lower_cell("xlstm_350m", shape, mesh, cfg_override=cfg)
    direct = dryrun._count_step(cfg, shape, dryrun._train_step_cfg("xlstm_350m"))
    assert got["flops_per_device"] == direct.flops
    assert got["bytes_per_device"] == direct.bytes


def test_depth_variants_extrapolate_exactly():
    """Two segments of several units (deepseek's smoke config: 1 dense MLA
    layer, 2 MoE), counted by variants, equal a count of every layer."""
    cfg = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                              segments=((("mla_dense",), 2), (("mla_moe",), 3)), n_layers=5)
    mesh = AbstractMesh({"data": 2, "model": 2})
    for kind in ("train", "decode"):
        shape = WorkloadShape("tiny", 32, 4, kind)
        got = dryrun.lower_cell("deepseek_v3_671b", shape, mesh, cfg_override=cfg)
        tsh.set_activation_mesh(mesh)
        try:
            direct = dryrun._count_step(cfg, shape, dryrun._train_step_cfg("deepseek_v3_671b"))
        finally:
            tsh.set_activation_mesh(None)
        assert got["flops_per_device"] * 4 == pytest.approx(direct.flops, rel=1e-12)
        assert got["bytes_per_device"] * 4 == pytest.approx(direct.bytes, rel=1e-12)
        assert got["collectives"]["all-to-all"]["count"] > 0  # the EP boundary


def test_kernel_route_counts_attention_once():
    """With ``use_flash_kernel`` the kernels count as one op each: a
    forward moves fewer bytes than the reference route's S x S chunks,
    with the causal half of the products."""
    base = dataclasses.replace(get_smoke_config("yi_6b"), max_decode_len=2048)
    mesh = AbstractMesh({"data": 1, "model": 1})
    shape = WorkloadShape("fwd", 2048, 1, "prefill")
    ref = dryrun.lower_cell("yi_6b", shape, mesh, cfg_override=base)
    ker = dryrun.lower_cell("yi_6b", shape, mesh,
                            cfg_override=dataclasses.replace(base, use_flash_kernel=True))
    assert ker["route"] == "kernel" and ref["route"] == "reference"
    assert ker["bytes_per_device"] < ref["bytes_per_device"]
    assert ker["flops_per_device"] < ref["flops_per_device"]
    # the stand-ins are gone afterwards
    import repro_torch.kernels.flash_attention as fl
    from repro_torch.kernels.flash_attention import ops

    assert fl.flash_attention is ops.flash_attention


def test_serve_figures_bound_the_weights():
    for arch in ("h2o_danube_3_4b", "qwen3_32b"):
        rec = dryrun.lower_cell(arch, WorkloadShape("fwd", 2048, 1, "prefill"),
                                AbstractMesh({"data": 1, "model": 1}))
        weights = sum(p.numel() * p.element_size() for p in LM(get_config(arch)).parameters())
        assert rec["serve_param_bytes_global"] == weights
        assert weights < rec["serve_init_peak_bytes"] < 1.1 * weights


# ------------------------------------------------------------- roofline
def test_roofline_uses_the_h100_figures():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)
    port = ROOT / "src" / "repro_torch"
    tpu = re.compile(r"(?<![\w.])(197e12|819e9|50e9)\b|\bv5e\b")
    for path in [*port.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not tpu.search(path.read_text()), path


def test_cell_report_terms_and_table():
    rec = dryrun.lower_cell("yi_6b", SHAPES["decode_32k"], make_production_mesh())
    r = roofline.cell_report(rec, get_config("yi_6b"), SHAPES["decode_32k"])
    assert r["chips"] == 256
    assert r["terms_s"]["compute"] == rec["flops_per_device"] / 989e12
    assert r["terms_s"]["memory"] == rec["bytes_per_device"] / 3.35e12
    wire = sum(c["wire_bytes"] for c in rec["collectives"].values())
    assert wire > 0 and r["terms_s"]["collective"] == wire / 450e9
    assert r["bound_s"] == max(r["terms_s"].values())
    assert r["dominant"] == max(r["terms_s"], key=r["terms_s"].get)
    assert r["model_flops"] == 2.0 * roofline.active_params(get_config("yi_6b"))[1] * 128
    report = roofline.build_report({"yi_6b/decode_32k/single": rec,
                                    "yi_6b/long_500k/single": {"skipped": "x"}}, path=None)
    table = roofline.markdown_table(report)
    assert "| yi_6b/decode_32k/single | 256 |" in table and "skipped" in table


def test_clis_write_only_the_ports_results():
    results = ROOT / "results"
    jax_file = results / "dryrun.json"
    before = jax_file.read_bytes() if jax_file.exists() else None
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
         "--shape", "decode_32k", "--mesh", "single", "--force"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "ok=" in run.stdout and "failed=0" in run.stdout
    rec = json.loads((results / "torch_dryrun.json").read_text())["yi_6b/decode_32k/single"]
    assert rec["ok"] and rec["mesh"] == {"data": 16, "model": 16}
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--arch", "yi-6b"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    assert "yi_6b/decode_32k/single" in run.stdout
    assert "yi_6b/decode_32k/single" in json.loads((results / "torch_roofline.json").read_text())
    assert (results / "torch_roofline.md").exists()
    assert (jax_file.read_bytes() if jax_file.exists() else None) == before
