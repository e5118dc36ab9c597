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

from repro.configs import all_configs as jax_all_configs
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import resolve as jax_resolve
from repro.models import LM as JaxLM
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.configs import resolve
from repro_torch.configs.shapes import make_batch
from repro_torch.models import LM, params_from_numpy, params_to_numpy
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
            for f in ("param_dtype", "compute_dtype"):
                assert str(getattr(port_cfg, f)).split(".")[-1] == \
                    jnp.dtype(getattr(jax_cfg, f)).name, (arch, f)
    # xlstm-350m and deepseek-v3-671b are served now: their published rows
    xl = get_config("xlstm-350m")
    assert (xl.n_layers, xl.d_model, xl.n_heads, xl.n_kv_heads, xl.d_ff, xl.vocab,
            xl.tie_embeddings, xl.param_dtype) == (24, 1024, 4, 4, 0, 50304, True, torch.float32)
    assert xl.segments == ((("mlstm", "slstm"), 12),)
    ds = get_config("deepseek_v3_671b")
    assert (ds.n_layers, ds.d_model, ds.n_heads, ds.n_kv_heads, ds.vocab, ds.d_ff,
            ds.dense_d_ff, ds.moe_d_ff) == (61, 7168, 128, 128, 129280, 2048, 18432, 2048)
    assert (ds.num_experts, ds.top_k, ds.num_shared_experts, ds.mtp, ds.tie_embeddings,
            ds.param_dtype) == (256, 8, 1, True, False, torch.bfloat16)
    assert ds.segments == ((("mla_dense",), 3), (("mla_moe",), 58))
    m = ds.mla_config()
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim) == \
        (1536, 512, 128, 64, 128)
    # recurrentgemma-9b is served (RG-LRU blocks): the published config
    rg = get_config("recurrentgemma-9b")
    assert (rg.n_layers, rg.d_model, rg.n_heads, rg.n_kv_heads, rg.head_dim, rg.d_ff,
            rg.vocab, rg.window) == (38, 4096, 16, 1, 256, 12288, 256000, 2048)
    assert rg.segments == ((("rec", "rec", "attn_geglu"), 12), (("rec", "rec"), 1))
    for name in ("gpt-2", "xlstm-7b"):
        with pytest.raises(KeyError):
            resolve(name)
        with pytest.raises(KeyError):
            jax_resolve(name)
    assert sorted(PORTED) == sorted(jax_all_configs())  # every arch of the JAX package
    yi = get_config("yi-6b")
    assert (yi.n_layers, yi.d_model, yi.n_heads, yi.n_kv_heads, yi.d_ff, yi.vocab) == \
        (32, 4096, 32, 4, 11008, 64000)


@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
@pytest.mark.parametrize("kind", ["ssm", "mla", "attn_moe"])
def test_unknown_block_kinds_raise(pkg, kind):
    """A block kind neither package knows is a ``ValueError`` in both:
    the JAX package's at init, the port's at construction (``LM(cfg)``
    builds its structure on the meta device)."""
    from repro.models.lm import LMConfig as JaxLMConfig
    from repro.models.lm import ModelFamily as JaxFamily
    from repro_torch.models.lm import LMConfig, ModelFamily

    if pkg == "repro":
        cfg = JaxLMConfig(name="unknown", family=JaxFamily.SSM, n_layers=2, d_model=16,
                          n_heads=2, n_kv_heads=2, d_ff=32, vocab=32,
                          segments=((("attn", kind), 1),))
        with pytest.raises(ValueError, match=f"unknown block kind '{kind}'"):
            JaxLM(cfg).init(jax.random.PRNGKey(0))
    else:
        cfg = LMConfig(name="unknown", family=ModelFamily.SSM, n_layers=2, d_model=16,
                       n_heads=2, n_kv_heads=2, d_ff=32, vocab=32,
                       segments=((("attn", kind), 1),))
        with pytest.raises(ValueError, match=f"unknown block kind '{kind}'"):
            LM(cfg)


@pytest.mark.parametrize("arch", ["xlstm_350m", "deepseek_v3_671b"])
def test_every_block_kind_and_the_mtp_head_build(arch):
    """``LM`` builds the xLSTM kinds (no norm2, no FFN), both MLA kinds
    (dense FFN of ``dense_d_ff``, the MoE) and the MTP head, with the JAX
    init's leaves: the smoke config drawn, the published one on the meta
    device."""
    cfg = get_smoke_config(arch)
    model = LM(cfg).init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(JaxLM(jax_smoke_config(arch)).init, jax.random.PRNGKey(0))
    tree = params_to_numpy(model)
    assert jax.tree_util.tree_structure(jax.tree_util.tree_map(np.shape, tree)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda a: a.shape, want))
    assert jax.tree_util.tree_map(np.shape, tree) == jax.tree_util.tree_map(lambda a: a.shape, want)
    if arch == "xlstm_350m":
        assert list(model.blocks[0]) == ["norm1", "mix"] == list(model.blocks[1])
        assert "mtp" not in tree
    else:
        assert list(model.blocks[0]) == ["norm1", "attn", "norm2", "mlp"]
        assert list(model.blocks[1]) == ["norm1", "attn", "norm2", "moe"]
        assert tuple(model.blocks[0]["mlp"]["gate"]["w"].shape) == (cfg.d_model, cfg.dense_d_ff)
        assert list(model.mtp) == ["proj", "block", "norm"]
        assert list(model.mtp["block"]) == ["norm1", "attn", "norm2", "mlp"]
        assert tuple(model.mtp["proj"]["w"].shape) == (2 * cfg.d_model, cfg.d_model)
    full = LM(get_config(arch))
    assert full.device.type == "meta"
    n = sum(p.numel() for p in full.parameters())
    assert n == {"xlstm_350m": 429_245_440, "deepseek_v3_671b": 671_712_655_360}[arch]


def test_deepseek_loss_with_the_mtp_head_matches_jax():
    """``LM.loss`` of the deepseek smoke config (MLA, MoE, the MTP head)
    against JAX's on the same weights and batch, in float32 compute:
    ``ce``, ``aux`` (the MoE blocks'), ``mtp_ce`` and the total, with a
    loss mask (the MTP head takes the shifted mask's ``[:, 1:]``)."""
    jcfg = dataclasses.replace(jax_smoke_config("deepseek_v3_671b"), compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("deepseek_v3_671b"), compute_dtype=torch.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab, (2, 20)).astype(np.int32)
    mask = (rng.uniform(size=(2, 20)) > 0.3).astype(np.float32)
    for batch_mask in (None, mask):
        jbatch = {"tokens": jnp.asarray(tokens)}
        pbatch = {"tokens": torch.from_numpy(tokens)}
        if batch_mask is not None:
            jbatch["loss_mask"] = jnp.asarray(batch_mask)
            pbatch["loss_mask"] = torch.from_numpy(batch_mask)
        _, want = jax.jit(jmodel.loss)(params, jbatch)
        with torch.no_grad():
            _, got = LM(pcfg).loss(tree_to_torch(tree), pbatch)
        assert set(got) == set(want) == {"ce", "aux", "mtp_ce", "loss"}
        for name in want:
            close(got[name], want[name], 1e-4)
        assert float(got["mtp_ce"]) > 0
        np.testing.assert_allclose(
            float(got["loss"]), float(got["ce"] + got["aux"] + pcfg.mtp_loss_weight * got["mtp_ce"]),
            rtol=1e-6)


@pytest.mark.parametrize("arch", ["xlstm_350m", "deepseek_v3_671b"])
def test_weights_round_trip_carries_every_leaf_and_the_mtp_head(arch):
    """``params_from_numpy`` → ``params_to_numpy`` gives the JAX tree back
    leaf for leaf (float32 leaves exactly; the matmul weights the serving
    LM holds in bf16 as their bf16 values), ``mtp`` unstacked; and the
    served model computes with the carried numbers."""
    jcfg = jax_smoke_config(arch)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(5))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(tree, get_smoke_config(arch), device="cpu")
    back = params_to_numpy(model)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert list(flat_got) == list(flat_want)
    for path, want in flat_want.items():
        got = flat_got[path]
        assert got.shape == want.shape, path
        keys = [getattr(k, "key", None) for k in path]
        if "w" in keys or "experts" in keys or "table" in keys:  # held in bf16
            want = np.asarray(jnp.asarray(want, jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    if arch == "deepseek_v3_671b":
        assert back["mtp"]["block"]["attn"]["wkv_b"]["w"].shape == \
            tree["mtp"]["block"]["attn"]["wkv_b"]["w"].shape  # no layer axis
    again = params_from_numpy(back, get_smoke_config(arch), device="cpu")
    for (name, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
