"""The port's LM stack against the JAX package's, on the CPU.

Both packages compute with the same weights: the JAX ``init`` draws them
and ``params_from_numpy`` carries them into the port.  Inputs come from
numpy seeds.  The JAX kernel route runs its Pallas kernels in interpret
mode (as its own call sites do); the port's kernel route on CPU tensors
takes the kernels' plain versions.

Tolerances: 1e-4 with ``compute_dtype=float32`` (float32 sums in another
order, compounded over a few layers); 2e-2 in bfloat16, as
tests/test_arch_smoke.py uses for decode-vs-forward (bf16 rounds at other
places in the two frameworks).  Through a whole LM the bf16 rounding
compounds: each package's bf16 logits then differ from the float32 logits
by up to 0.06 at these shapes, more than the two differ from each other.
There the check is the mean difference (2e-2), and that the port's bf16
logits are no farther from the float32 logits than JAX's, within 1.5x.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.configs import resolve
from repro_torch.configs.shapes import make_batch
from repro_torch.models import LM, params_from_numpy
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)


def tree_to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


# ------------------------------------------------------------- common.py
def test_rmsnorm_rope_and_mlps_match_jax(rng):
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    close(port_common.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
          jax_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), 1e-5)
    # shared (S,) and per-sequence (B, S) positions; first half against second
    for pos in (np.arange(5), rng.integers(0, 100, (2, 5))):
        close(port_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
              jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos)), 1e-5)
    p = jax.tree_util.tree_map(np.asarray, jax_common.init_swiglu(jax.random.PRNGKey(0), 16, 32))
    h = rng.standard_normal((2, 4, 16)).astype(np.float32)
    for name in ("swiglu", "geglu"):
        close(getattr(port_common, name)(tree_to_torch(p), torch.from_numpy(h),
                                         compute_dtype=torch.float32),
              getattr(jax_common, name)(jax.tree_util.tree_map(jnp.asarray, p),
                                        jnp.asarray(h), compute_dtype=jnp.float32), 1e-5)


# ---------------------------------------------------------- attention.py
ATTN_CFGS = {
    "gqa": dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16),
    "mqa_qknorm": dict(d_model=64, n_heads=4, n_kv_heads=1, d_head=16, qk_norm=True),
    "window": dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, window=8),
}


def attn_pair(name, flag, dtype, chunk=1024):
    jdt, tdt, tol = DTYPES[dtype]
    kw = ATTN_CFGS[name]
    jcfg = jax_attn.AttentionConfig(**kw, use_flash_kernel=flag, chunk=chunk, compute_dtype=jdt)
    pcfg = port_attn.AttentionConfig(**kw, use_flash_kernel=flag, chunk=chunk, compute_dtype=tdt)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_attn.init_attention(jax.random.PRNGKey(1), jcfg))
    return jcfg, pcfg, jax.tree_util.tree_map(jnp.asarray, params), tree_to_torch(params), tol


#: every config on both routes in float32, the GQA one in bf16 too
ATTN_CASES = [(n, flag, "f32") for n in sorted(ATTN_CFGS) for flag in (False, True)] + [
    ("gqa", False, "bf16"), ("gqa", True, "bf16")]


@pytest.mark.parametrize("name,flag,dtype", ATTN_CASES)
def test_attend_train_and_prefill_match_jax(name, flag, dtype, rng):
    jcfg, pcfg, jp, pp, tol = attn_pair(name, flag, dtype)
    b, s = 2, 32
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    pos = np.arange(s)
    close(port_attn.attend_train(pp, pcfg, torch.from_numpy(x), torch.from_numpy(pos)),
          jax_attn.attend_train(jp, jcfg, jnp.asarray(x), jnp.asarray(pos)), tol)
    cache = port_attn.init_cache(pcfg, b, 48, dtype=pcfg.compute_dtype)
    got, got_cache = port_attn.prefill(pp, pcfg, torch.from_numpy(x), torch.from_numpy(pos), cache)
    want, want_cache = jax_attn.prefill(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                        jax_attn.init_cache(jcfg, b, 48, dtype=jcfg.compute_dtype))
    close(got, want, tol)
    close(got_cache["k"], want_cache["k"], tol)
    close(got_cache["v"], want_cache["v"], tol)


@pytest.mark.parametrize("name,flag,dtype", ATTN_CASES)
def test_decode_step_matches_jax(name, flag, dtype, rng):
    """Ragged lengths, one of them at max_len: that write is dropped."""
    jcfg, pcfg, jp, pp, tol = attn_pair(name, flag, dtype)
    b, s_max = 3, 24
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    k = rng.standard_normal((b, jcfg.n_kv_heads, s_max, 16)).astype(np.float32)
    v = rng.standard_normal((b, jcfg.n_kv_heads, s_max, 16)).astype(np.float32)
    lengths = np.array([0, 13, s_max], np.int32)
    jc = {"k": jnp.asarray(k).astype(jcfg.compute_dtype),
          "v": jnp.asarray(v).astype(jcfg.compute_dtype)}
    pc = {"k": torch.from_numpy(k).to(pcfg.compute_dtype),
          "v": torch.from_numpy(v).to(pcfg.compute_dtype)}
    want, want_cache = jax_attn.decode_step(jp, jcfg, jnp.asarray(x), jc, jnp.asarray(lengths))
    got, got_cache = port_attn.decode_step(pp, pcfg, torch.from_numpy(x), pc,
                                           torch.from_numpy(lengths))
    close(got, want, tol)
    assert got_cache["k"] is pc["k"]  # updated in place
    close(got_cache["k"], want_cache["k"], tol)
    close(got_cache["v"], want_cache["v"], tol)
    np.testing.assert_array_equal(as_f32(got_cache["k"][2]), as_f32(jc["k"][2]))


def test_sdpa_chunked_matches_jax_and_keeps_its_rounding(rng):
    """Chunked online softmax with padding (t=40, chunk 16), bf16."""
    q = rng.standard_normal((1, 4, 40, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 40, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 40, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    for window in (None, 7):
        got = port_attn._sdpa_chunked(tq, tk, tv, causal=True, window=window, chunk=16)
        want = jax_attn._sdpa_chunked(jq, jk, jv, causal=True, window=window, chunk=16)
        close(got, want, 1e-5)  # float32 outputs from the same bf16 products
    with pytest.raises(AssertionError):
        port_attn._sdpa_chunked(tq, tk, tv, causal=False, window=None, chunk=16)


# ------------------------------------------------------------------ lm.py
def lm_pair(arch, flag, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_smoke_config(arch), use_flash_kernel=flag, compute_dtype=jdt)
    pcfg = dataclasses.replace(get_smoke_config(arch), use_flash_kernel=flag, compute_dtype=tdt)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = params_from_numpy(tree, pcfg, device="cpu")
    f32 = None  # the float32 yardstick of a bf16 comparison
    if dtype == "bf16":
        f32 = params_from_numpy(
            tree, dataclasses.replace(pcfg, compute_dtype=torch.float32), device="cpu")
    return jmodel, params, port, f32


def close_lm(got, want, ref):
    """``close`` at 1e-4 in float32; in bf16 (``ref``: the float32 result)
    the mean difference and the distance to float32, as the module says."""
    if ref is None:
        return close(got, want, 1e-4)
    got, want, ref = as_f32(got), as_f32(want), as_f32(ref)
    assert np.abs(got - want).mean() <= 2e-2
    assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max()


CASES = [(a, flag, "f32") for a in PORTED for flag in (False, True)] + [
    ("yi_6b", False, "bf16"), ("yi_6b", True, "bf16")]


@pytest.mark.parametrize("arch,flag,dtype", CASES)
def test_lm_forward_and_decode_match_jax(arch, flag, dtype):
    """Tokens (and a VLM's patch embeddings) from ``make_batch``: (2, 24),
    or (2, 24, K) with codebooks."""
    jmodel, params, port, f32 = lm_pair(arch, flag, dtype)
    batch = make_batch(port.cfg, batch=2, seq=24, rng=np.random.default_rng(1), device="cpu")
    tokens, patches = batch["tokens"], batch.get("patch_embeds")
    close_lm(port(tokens, patch_embeds=patches),
             jax.jit(jmodel.forward)(params, jnp.asarray(tokens.numpy()),
                                     patch_embeds=None if patches is None
                                     else jnp.asarray(patches.float().numpy(), jnp.bfloat16)),
             None if f32 is None else f32(tokens, patch_embeds=patches))

    state_j = jmodel.init_decode_state(2, max_len=32)
    state_p = port.init_decode_state(2, max_len=32)
    state_f = None if f32 is None else f32.init_decode_state(2, max_len=32)
    assert jax.tree_util.tree_map(lambda a: a.shape, state_j) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), state_p)
    step = jax.jit(jmodel.decode_step)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    for t in range(3):
        tok = tokens[:, t:t + 1]
        want, state_j = step(params, state_j, jnp.asarray(tok.numpy()),
                             jnp.asarray(lengths.numpy()))
        got, state_p = port.decode_step(state_p, tok, lengths)
        ref = None if f32 is None else f32.decode_step(state_f, tok, lengths)[0]
        close_lm(got, want, ref)
        lengths = lengths + 1
    if f32 is None:  # every block's state: KV caches, a rec block's h and conv
        for seg, blocks in state_j.items():
            for blk, leaves in blocks.items():
                for name, leaf in leaves.items():
                    close(state_p[seg][blk][name], leaf, 1e-4)


def test_init_draws_the_jax_shapes_and_scales():
    cfg = get_smoke_config("granite_34b")  # MQA, tied head
    jshapes = jax.eval_shape(JaxLM(jax_smoke_config("granite_34b")).init, jax.random.PRNGKey(0))
    port = LM(cfg).init(torch.Generator().manual_seed(0))
    sd = port.state_dict()
    assert "lm_head.w" not in sd
    assert tuple(sd["embed.table"].shape) == jshapes["embed"]["table"].shape
    wq = jshapes["seg0"]["b0"]["attn"]["wq"]["w"].shape  # (layers, d, H*Dh)
    assert len(port.blocks) == wq[0]
    assert tuple(sd["blocks.2.attn.wq.w"].shape) == wq[1:]
    assert sd["blocks.0.attn.wq.w"].dtype == cfg.compute_dtype  # stored cast
    assert sd["blocks.0.norm1.scale"].dtype == cfg.param_dtype
    std = float(sd["blocks.1.mlp.down.w"].float().std())
    assert abs(std - cfg.d_ff**-0.5) < 0.1 * cfg.d_ff**-0.5


def test_meta_structure_takes_shared_weights():
    """LM(cfg) costs no memory; assign=True shares another LM's tensors."""
    cfg = get_smoke_config("yi_6b")
    a = LM(cfg).init(torch.Generator().manual_seed(0))
    b = LM(dataclasses.replace(cfg, use_flash_kernel=True))
    assert b.device.type == "meta"
    b.load_state_dict(a.state_dict(), assign=True)
    assert b.blocks[0]["attn"]["wq"]["w"].data_ptr() == a.blocks[0]["attn"]["wq"]["w"].data_ptr()
    tokens = torch.arange(6)[None]
    torch.testing.assert_close(a(tokens), b(tokens), rtol=2e-2, atol=2e-2)


def test_configs_match_the_jax_package_and_refuse_the_rest():
    from repro.configs import get_config as jax_get_config

    for arch in PORTED:
        for port_cfg, jax_cfg in ((get_config(arch), jax_get_config(arch)),
                                  (get_smoke_config(arch), jax_smoke_config(arch))):
            for f in dataclasses.fields(port_cfg):
                if f.name not in ("param_dtype", "compute_dtype", "family"):
                    assert getattr(port_cfg, f.name) == getattr(jax_cfg, f.name), (arch, f.name)
            assert port_cfg.family.value == jax_cfg.family.value
    for arch in ("xlstm-350m", "deepseek_v3_671b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    # recurrentgemma-9b is served now (RG-LRU blocks): the published config
    rg = get_config("recurrentgemma-9b")
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.head_dim, rg.d_ff,
            rg.vocab, rg.window) == (38, 4096, 16, 1, 256, 12288, 256000, 2048)
    assert rg.segments == ((("rec", "rec", "attn_geglu"), 12), (("rec", "rec"), 1))
    with pytest.raises(KeyError):
        resolve("gpt-2")
    yi = get_config("yi-6b")
    assert (yi.n_layers, yi.d_model, yi.n_heads, yi.n_kv_heads, yi.d_ff, yi.vocab) == \
        (32, 4096, 32, 4, 11008, 64000)


def test_unported_block_kinds_raise():
    from repro.configs import get_smoke_config as jsc
    from repro_torch.models.lm import LMConfig, ModelFamily

    xl = jsc("xlstm_350m")
    cfg = LMConfig(name=xl.name, family=ModelFamily.SSM, n_layers=xl.n_layers,
                   d_model=xl.d_model, n_heads=xl.n_heads, n_kv_heads=xl.n_kv_heads,
                   d_ff=xl.d_ff, vocab=xl.vocab, segments=xl.segments)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg)
