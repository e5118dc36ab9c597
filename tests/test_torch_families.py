"""The MoE, vision-language and audio families in the port against the
JAX package, on the CPU: qwen2-moe-a2.7b (``moe_attn`` blocks),
internvl2-2b (a prefix of image patch embeddings) and musicgen-medium
(four parallel codebooks), each at its smoke size.

Both packages compute with the same weights: the JAX ``init`` draws them
and ``params_from_numpy`` carries them into the port.  Batches come from
``make_batch`` of each package with the same numpy seed.  The JAX kernel
route runs its Pallas kernels in interpret mode; the port's kernel route
on CPU tensors takes the kernels' plain versions.

Tolerances, as ``tests/test_torch_models.py`` and
``tests/test_torch_train.py`` state them: float32 compute within 1e-4
(float32 sums in another order, over two layers), gradients within
``F32`` (``tests/torch_parity.py``) of each leaf's largest gradient.  In bf16 (the configs'
default) the forward's logits agree on average within 2e-2; the
qwen2-moe router computes in float32 in both packages from bf16 hidden
states that round at other places, so no bf16 check holds its largest
difference.  Greedy tokens through ``ServeEngine`` are equal.
"""
import dataclasses
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import shapes as jax_shapes
from repro.models import LM as JaxLM
from repro.serve import Request as JaxRequest
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.utils import tree as jax_tree
from repro_torch.configs import get_config, get_smoke_config, shapes
from repro_torch.models import LM, params_from_numpy, params_to_numpy
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.utils import tree as port_tree
from torch_parity import F32, to_torch

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2_moe_a2_7b", "internvl2_2b", "musicgen_medium")
B, S = 2, 24


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol=1e-4):
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def pair(arch, flag, jdt=jnp.float32, tdt=torch.float32):
    jcfg = dataclasses.replace(jax_smoke_config(arch), use_flash_kernel=flag, compute_dtype=jdt)
    pcfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=flag, compute_dtype=tdt)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, tree, params_from_numpy(tree, pcfg, device="cpu")


def batches(arch, seq=S, seed=1):
    """The same batch from both packages' make_batch."""
    jb = jax_shapes.make_batch(jax_smoke_config(arch), batch=B, seq=seq,
                               rng=np.random.default_rng(seed))
    pb = shapes.make_batch(get_smoke_config(arch), batch=B, seq=seq,
                           rng=np.random.default_rng(seed), device="cpu")
    return jb, pb


CASES = [(a, flag) for a in FAMILIES for flag in (False, True)]


# ------------------------------------------------------------ forward, decode
@pytest.mark.parametrize("arch,flag", CASES)
def test_forward_matches_jax(arch, flag):
    jmodel, params, _, port = pair(arch, flag)
    jb, pb = batches(arch)
    want = jax.jit(jmodel.forward)(params, jb["tokens"], patch_embeds=jb.get("patch_embeds"))
    got = port(pb["tokens"], patch_embeds=pb.get("patch_embeds"))
    assert tuple(got.shape) == want.shape
    close(got, want)


@pytest.mark.parametrize("arch,flag", CASES)
def test_decode_with_a_length_mix_matches_jax(arch, flag):
    """Three steps at lengths (0, 5) and on: a fresh slot beside one with a
    prefix in its cache.  An MoE block routes the batch as one group."""
    jmodel, params, _, port = pair(arch, flag)
    _, pb = batches(arch)
    tokens = pb["tokens"]
    state_j = jmodel.init_decode_state(B, max_len=32)
    state_p = port.init_decode_state(B, max_len=32)
    assert jax.tree_util.tree_map(lambda a: a.shape, state_j) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), state_p)
    step = jax.jit(jmodel.decode_step)
    lengths = np.array([0, 5], np.int32)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        want, state_j = step(params, state_j, jnp.asarray(tok.numpy()), jnp.asarray(lengths))
        got, state_p = port.decode_step(state_p, tok, torch.from_numpy(lengths))
        assert tuple(got.shape) == want.shape
        close(got, want)
        lengths = lengths + 1
    close(state_p["seg0"]["b0"]["k"], state_j["seg0"]["b0"]["k"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_forward_matches_jax_on_average(arch):
    jmodel, params, _, port = pair(arch, True, jnp.bfloat16, torch.bfloat16)
    jb, pb = batches(arch)
    want = jax.jit(jmodel.forward)(params, jb["tokens"], patch_embeds=jb.get("patch_embeds"))
    got = port(pb["tokens"], patch_embeds=pb.get("patch_embeds"))
    assert got.dtype == torch.bfloat16
    assert float(np.abs(as_f32(got) - as_f32(want)).mean()) <= 2e-2


# -------------------------------------------------------------------- loss
def jax_loss_and_grads(jmodel, params, batch):
    def loss(p):
        return jmodel.loss(p, batch)

    (value, metrics), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return metrics, {k: np.asarray(v) for k, v in jax_tree.flatten_with_paths(grads).items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax(arch):
    """The loss (cross-entropy over every codebook, after the patch
    prefix, plus the MoE's balance and z losses in ``aux``) and its
    gradients on the JAX params tree, with a loss mask."""
    jmodel, params, tree, _ = pair(arch, False)
    jb, pb = batches(arch)
    mask = (np.random.default_rng(2).random((B, S)) < 0.8).astype(np.float32)
    jb["loss_mask"], pb["loss_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    want, want_grads = jax_loss_and_grads(jmodel, params, jb)
    port = LM(dataclasses.replace(get_smoke_config(arch), compute_dtype=torch.float32))
    masters = port_tree.tree_map(lambda x: x.requires_grad_(True), to_torch(tree))
    total, metrics = port.loss(masters, pb)
    flat = port_tree.flatten_with_paths(masters)
    # musicgen's lm_head is never read: no gradient (JAX's is zeros)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        flat.values(), torch.autograd.grad(total, list(flat.values()), allow_unused=True))]
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[name].detach()), float(want[name]),
                                   rtol=1e-5, atol=1e-6)
    aux = float(metrics["aux"].detach())
    assert aux > 0 if arch == "qwen2_moe_a2_7b" else aux == 0.0
    assert list(flat) == list(want_grads)
    for path, g in zip(flat, grads):
        # float32 sums in another order: within F32 of the leaf's largest gradient
        scale = np.abs(want_grads[path]).max()
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=0, atol=F32 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_on_the_kernel_route_matches_jax_without_gradients(arch):
    jmodel, params, tree, _ = pair(arch, True)
    jb, pb = batches(arch)
    want = jmodel.loss(params, jb)[1]
    port = LM(dataclasses.replace(get_smoke_config(arch), use_flash_kernel=True,
                                  compute_dtype=torch.float32))
    with torch.no_grad():
        got = port.loss(to_torch(tree), pb)[1]
    for name in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="no backward"):
        port.loss(to_torch(tree), pb)


# --------------------------------------------------- the families' extras
def test_musicgen_reads_out_every_codebook_and_keeps_the_unused_head():
    """(B, S, K, V) logits from K heads; JAX also builds an ``lm_head``
    (untied, with codebooks) that it never reads: the port keeps the leaf,
    so trees round-trip, and it changes no logit."""
    jmodel, params, tree, port = pair("musicgen_medium", False)
    cfg = port.cfg
    _, pb = batches("musicgen_medium")
    logits = port(pb["tokens"])
    assert tuple(logits.shape) == (B, S, cfg.n_codebooks, cfg.vocab)
    assert "lm_head.w" in port.state_dict() and "heads.cb3.w" in port.state_dict()
    back = params_to_numpy(port)
    assert list(port_tree.flatten_with_paths(back)) == list(jax_tree.flatten_with_paths(params))
    for path, leaf in port_tree.flatten_with_paths(back).items():
        np.testing.assert_array_equal(leaf, port_tree.flatten_with_paths(tree)[path], path)
    with torch.no_grad():
        port.lm_head["w"].normal_()
    assert torch.equal(port(pb["tokens"]), logits)
    # each codebook's logits come from its own head
    with torch.no_grad():
        port.heads["cb2"]["w"].zero_()
    again = port(pb["tokens"])
    assert torch.equal(again[:, :, [0, 1, 3]], logits[:, :, [0, 1, 3]])
    assert bool((again[:, :, 2] == 0).all())


def test_internvl2_prepends_the_patches_and_reads_out_the_text():
    jmodel, params, _, port = pair("internvl2_2b", False)
    jb, pb = batches("internvl2_2b")
    cfg = port.cfg
    assert tuple(pb["patch_embeds"].shape) == (B, cfg.num_patches, cfg.d_model)
    with_patches = port(pb["tokens"], patch_embeds=pb["patch_embeds"])
    text_only = port(pb["tokens"])
    assert tuple(with_patches.shape) == (B, S, cfg.vocab)
    assert float((with_patches - text_only).abs().max()) > 1e-2  # the text attends to them
    close(text_only, jax.jit(jmodel.forward)(params, jb["tokens"]))
    # the text's first position sees every patch and itself, as in JAX
    moved = pb["patch_embeds"].clone()
    moved[:, 0] += 1
    changed = port(pb["tokens"], patch_embeds=moved)
    assert bool(((changed - with_patches).abs().amax(-1) > 0).all())


# ----------------------------------------------------------- shapes module
@pytest.mark.parametrize("arch", FAMILIES + ("yi_6b",))
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_equals_jax(arch, seed):
    jb, pb = batches(arch, seq=16, seed=seed)
    assert set(jb) == set(pb)
    np.testing.assert_array_equal(pb["tokens"].numpy(), np.asarray(jb["tokens"]))
    assert pb["tokens"].dtype == torch.int32
    if "patch_embeds" in jb:  # bf16 bits: both round float32 to nearest-even
        assert pb["patch_embeds"].dtype == torch.bfloat16
        np.testing.assert_array_equal(pb["patch_embeds"].view(torch.int16).numpy(),
                                      np.asarray(jb["patch_embeds"]).view(np.int16))


@pytest.mark.parametrize("arch", FAMILIES + ("yi_6b", "h2o_danube_3_4b"))
def test_input_specs_and_cells_equal_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in shapes.SHAPES.items():
        jshape = jax_shapes.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert shapes.shape_applicable(cfg, shape) == jax_shapes.shape_applicable(jcfg, jshape)
        got = shapes.input_specs(cfg, shape)
        want = jax_shapes.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k, spec in got.items():
            assert spec.is_meta  # no memory
            assert tuple(spec.shape) == want[k].shape
            assert str(spec.dtype).split(".")[-1] == str(want[k].dtype)
    assert shapes.cells({arch: cfg}) == jax_shapes.cells({arch: jcfg})


# --------------------------------------------------------- full size, meta
@pytest.mark.parametrize("arch", FAMILIES)
def test_full_size_configs_build_on_the_meta_device(arch):
    """``LM(get_config(arch))`` holds the published widths and depth on
    the meta device: the JAX tree's shapes (``jax.eval_shape``, no
    memory), leaf for leaf, in JAX's order."""
    cfg = get_config(arch)
    model = LM(cfg)
    assert model.device.type == "meta"
    want = jax_tree.flatten_with_paths(
        jax.eval_shape(JaxLM(jax_get_config(arch)).init, jax.random.PRNGKey(0)))
    got = port_tree.flatten_with_paths(model.init_params(None))
    assert list(got) == list(want)
    assert all(tuple(got[k].shape) == want[k].shape for k in want)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(v.shape)) for v in want.values())
    expected = {"qwen2_moe_a2_7b": 14.31e9, "internvl2_2b": 1.89e9, "musicgen_medium": 1.84e9}
    assert abs(n - expected[arch]) < 0.01e9


# ------------------------------------------------------------ the refusals
def test_serve_engine_refuses_codebooks_in_both_packages():
    jmodel, params, _, port = pair("musicgen_medium", False)
    with pytest.raises(NotImplementedError, match="single-codebook"):
        JaxServeEngine(jmodel, params, JaxServeConfig(max_batch=2, max_len=16))
    with pytest.raises(NotImplementedError, match="single-codebook"):
        ServeEngine(port, None, ServeConfig(max_batch=2, max_len=16), device="cpu")


@pytest.mark.parametrize("max_batch", [1, 2])
def test_serve_engine_refuses_recurrent_slots_in_both_packages(max_batch):
    """Recurrent kinds with max_batch != 1 (the port's LM has no such
    kinds yet: a stand-in with the config is enough, the check comes
    first)."""
    jcfg = jax_smoke_config("xlstm_350m")
    jmodel = JaxLM(jcfg)
    stand_in = types.SimpleNamespace(cfg=jcfg)
    if max_batch == 1:  # accepted by both (the port stops later, at the stand-in)
        JaxServeEngine(jmodel, jmodel.init(jax.random.PRNGKey(0)),
                       JaxServeConfig(max_batch=1, max_len=16))
        with pytest.raises(AttributeError):
            ServeEngine(stand_in, None, ServeConfig(max_batch=1, max_len=16), device="cpu")
        return
    with pytest.raises(NotImplementedError, match="max_batch=1"):
        JaxServeEngine(jmodel, None, JaxServeConfig(max_batch=max_batch, max_len=16))
    with pytest.raises(NotImplementedError, match="max_batch=1"):
        ServeEngine(stand_in, None, ServeConfig(max_batch=max_batch, max_len=16), device="cpu")


def launch(pkg, module, *args):
    cpu = ["--device", "cpu"] if pkg == "repro_torch" else []
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch.{module}", *args, "--smoke", *cpu],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
@pytest.mark.parametrize("module,arch,message", [
    ("serve", "musicgen-medium", "codebook serving demo not wired"),
    ("train", "musicgen-medium", "multimodal frontends are stubs"),
    ("train", "internvl2-2b", "multimodal frontends are stubs"),
])
def test_launchers_refuse_what_the_jax_launchers_refuse(pkg, module, arch, message):
    proc = launch(pkg, module, "--arch", arch)
    assert proc.returncode == 1 and message in proc.stderr, proc.stderr[-2000:]


def test_serve_launcher_serves_the_moe_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b
    --smoke --device cpu``."""
    proc = launch("repro_torch", "serve", "--arch", "qwen2-moe-a2.7b", "--prompts", "2",
                  "--new-tokens", "3")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["req0", "req1"]


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("flag", [False, True], ids=["reference", "kernel"])
def test_qwen2_moe_greedy_tokens_equal_jax(flag):
    """Three requests on two slots in float32: the idle slot's token 0
    takes part in the folded routing in both engines, and the tokens are
    equal."""
    jmodel, params, _, port = pair("qwen2_moe_a2_7b", flag)
    prompts = [[5, 6, 200], [9, 8, 7, 3], [11]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(max_batch=2, max_len=32)).generate(jreqs)
    ServeEngine(port, None, ServeConfig(max_batch=2, max_len=32), device="cpu").generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 5 for r in preqs)


def test_internvl2_serves_text_like_jax():
    jmodel, params, _, port = pair("internvl2_2b", False)
    prompts = [[5, 6], [1, 2, 3]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=4) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=4) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(max_batch=2, max_len=16)).generate(jreqs)
    ServeEngine(port, None, ServeConfig(max_batch=2, max_len=16), device="cpu").generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
