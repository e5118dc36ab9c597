"""The MoE, vision-language, audio and hybrid families in the port against
the JAX package, on the CPU: qwen2-moe-a2.7b (``moe_attn`` blocks),
internvl2-2b (a prefix of image patch embeddings), musicgen-medium (four
parallel codebooks) and recurrentgemma-9b (``rec`` RG-LRU blocks beside
local attention, window 16 in the smoke config), each at its smoke size.

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

recurrentgemma's decode kernel branch has no window (as in the JAX
package): past 16 positions its two routes part, each equal to its JAX
branch.
"""
import dataclasses
import subprocess
import sys
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
FAMILIES = ("qwen2_moe_a2_7b", "internvl2_2b", "musicgen_medium", "recurrentgemma_9b")
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
    flat_p = port_tree.flatten_with_paths(state_p)
    for path, leaf in jax_tree.flatten_with_paths(state_j).items():
        close(flat_p[path], leaf)  # KV caches, and the rec blocks' h and conv


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
    expected = {"qwen2_moe_a2_7b": 14.31e9, "internvl2_2b": 1.89e9, "musicgen_medium": 1.84e9,
                "recurrentgemma_9b": 9.40e9}
    assert abs(n - expected[arch]) < 0.01e9
    if arch == "recurrentgemma_9b":
        assert n == 9_396_088_832  # 38 layers at full width: nothing cut on the card


# ------------------------------------------------------------ the refusals
def test_serve_engine_refuses_codebooks_in_both_packages():
    jmodel, params, _, port = pair("musicgen_medium", False)
    with pytest.raises(NotImplementedError, match="single-codebook"):
        JaxServeEngine(jmodel, params, JaxServeConfig(max_batch=2, max_len=16))
    with pytest.raises(NotImplementedError, match="single-codebook"):
        ServeEngine(port, None, ServeConfig(max_batch=2, max_len=16), device="cpu")


@pytest.mark.parametrize("max_batch", [1, 2])
def test_serve_engine_refuses_recurrent_slots_in_both_packages(max_batch):
    """xlstm-350m's ``mlstm`` and ``slstm`` blocks keep a recurrent state:
    both engines refuse more than one slot, and with one they serve the
    same greedy tokens from the same weights, each request's state zeroed
    on admission."""
    jmodel, params, _, port = pair("xlstm_350m", False)
    scfg = dict(max_batch=max_batch, max_len=16)
    if max_batch > 1:
        with pytest.raises(NotImplementedError, match="max_batch=1"):
            JaxServeEngine(jmodel, None, JaxServeConfig(**scfg))
        with pytest.raises(NotImplementedError, match="max_batch=1"):
            ServeEngine(port, None, ServeConfig(**scfg), device="cpu")
        return
    prompts = [[5, 6, 200], [9, 8, 7, 3], [11]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(**scfg)).generate(jreqs)
    engine = ServeEngine(port, None, ServeConfig(**scfg), device="cpu")
    engine.generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 5 for r in preqs)
    # admission zeroes every state leaf of the slot: C, n, m; c, n, h, m
    leaves = {(blk, k): v for blk, b in engine.state["seg0"].items() for k, v in b.items()}
    assert sorted(k for _, k in leaves) == ["C", "c", "h", "m", "m", "n", "n"]
    assert all(float(v.abs().sum()) > 0 for v in leaves.values())
    engine._reset_slot(0)
    assert all(float(v.abs().sum()) == 0 for v in leaves.values())


def test_serve_engine_serves_deepseek_on_several_slots_as_jax():
    """deepseek's MLA cache is gated by ``lengths`` like a KV cache, so
    both engines serve it on several slots; an MoE block routes the slot
    table as one group in both.  Same greedy tokens from the same weights,
    and admission zeroes the slot's ``c_kv`` and ``k_rope``."""
    jmodel, params, _, port = pair("deepseek_v3_671b", False)
    scfg = dict(max_batch=3, max_len=32)
    prompts = [[5, 6, 200], [9, 8, 7, 3], [11], [40, 41]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=4) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=4) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(**scfg)).generate(jreqs)
    engine = ServeEngine(port, None, ServeConfig(**scfg), device="cpu")
    engine.generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 4 for r in preqs)
    caches = [c for seg in engine.state.values() for b in seg.values() for c in b.items()]
    assert sorted({k for k, _ in caches}) == ["c_kv", "k_rope"]
    assert all(tuple(v.shape[:2]) == (v.shape[0], 3) for _, v in caches)
    assert all(float(v[:, 1].abs().sum()) > 0 for _, v in caches)
    engine._reset_slot(1)
    assert all(float(v[:, 1].abs().sum()) == 0 for _, v in caches)
    assert all(float(v[:, 0].abs().sum()) > 0 for _, v in caches)


@pytest.mark.parametrize("max_batch", [1, 2, 4])
def test_serve_engine_refuses_recurrentgemma_slots_in_both_packages(max_batch):
    """recurrentgemma's ``rec`` blocks keep a recurrent state: both engines
    refuse more than one slot, and with one they serve the same greedy
    tokens, each request's state zeroed on admission."""
    jmodel, params, _, port = pair("recurrentgemma_9b", False)
    scfg = dict(max_batch=max_batch, max_len=32)
    if max_batch > 1:
        with pytest.raises(NotImplementedError, match="max_batch=1"):
            JaxServeEngine(jmodel, params, JaxServeConfig(**scfg))
        with pytest.raises(NotImplementedError, match="max_batch=1"):
            ServeEngine(port, None, ServeConfig(**scfg), device="cpu")
        return
    prompts = [[5, 6, 200], [9, 8, 7, 3], [11]]
    jreqs = [JaxRequest(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    preqs = [Request(prompt=np.array(p, np.int32), max_new_tokens=5) for p in prompts]
    JaxServeEngine(jmodel, params, JaxServeConfig(**scfg)).generate(jreqs)
    ServeEngine(port, None, ServeConfig(**scfg), device="cpu").generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == 5 for r in preqs)


@pytest.mark.parametrize("flag", [False, True], ids=["reference", "kernel"])
def test_recurrentgemma_decode_window_divergence_kept_branch_by_branch(flag):
    """Decode past the smoke config's window of 16 (max_decode_len 64):
    the kernel branch attends to the whole prefix and the reference
    branch to the window, as in the JAX package (attention.py:271-282).
    Each port branch equals its JAX branch at every step, and after the
    window the two branches part."""
    steps = 24
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (B, steps)).astype(np.int32)
    logits = {}
    for route in (False, True):
        jmodel, params, _, port = pair("recurrentgemma_9b", route)
        cfg = port.cfg
        assert (cfg.window, cfg.max_decode_len) == (16, 64)
        state_j = jmodel.init_decode_state(B)
        state_p = port.init_decode_state(B)
        step = jax.jit(jmodel.decode_step)
        out = []
        for t in range(steps):
            lengths = np.full((B,), t, np.int32)
            want, state_j = step(params, state_j, jnp.asarray(tokens[:, t:t + 1]),
                                 jnp.asarray(lengths))
            got, state_p = port.decode_step(state_p, torch.from_numpy(tokens[:, t:t + 1]),
                                            torch.from_numpy(lengths))
            if route == flag:
                close(got, want)
            out.append(as_f32(got)[:, 0])
        logits[route] = np.stack(out, 1)
    inside = np.abs(logits[True][:, :16] - logits[False][:, :16]).max()
    past = np.abs(logits[True][:, 17:] - logits[False][:, 17:]).max()
    assert inside <= 1e-4 < 1e-2 < past  # equal inside the window, apart past it


def launch(pkg, module, *args):
    cpu = ["--device", "cpu"] if pkg == "repro_torch" else []
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.launch.{module}", *args, "--smoke", *cpu],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
    )


def test_serve_launcher_serves_recurrentgemma_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b
    --smoke --device cpu``: one slot, as the JAX launcher gives it."""
    proc = launch("repro_torch", "serve", "--arch", "recurrentgemma-9b", "--prompts", "2",
                  "--new-tokens", "3")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["req0", "req1"]


@pytest.mark.parametrize("arch", ["xlstm-350m", "deepseek-v3-671b"])
def test_serve_launcher_serves_xlstm_and_deepseek_on_the_cpu(arch):
    """``python -m repro_torch.launch.serve --arch <arch> --smoke --device
    cpu``: xlstm (recurrent) on one slot, deepseek (MLA caches) on two."""
    proc = launch("repro_torch", "serve", "--arch", arch, "--prompts", "3",
                  "--new-tokens", "3")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["req0", "req1", "req2"]


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
