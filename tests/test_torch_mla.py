"""Multi-head latent attention in the port (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla`` on the CPU.

Weights come from JAX's ``init_mla`` and go across as numpy; inputs are
numpy draws from fixed seeds.  Tolerances:

* the JAX package's own, where a test mirrors one of its tests:
  ``tests/test_mla.py`` (absorbed decode against the train path at
  rtol 2e-4, atol 2e-5; the cache's compression; ragged lengths) and
  ``tests/test_chunked_attention.py::test_mla_chunked_equals_dense``
  (rtol = atol = 3e-3);
* 1e-5 relative to the largest magnitude for each function against JAX in
  float32 compute (float32 sums in another order), and for the bf16
  chunked path, whose products take bf16 operands with float32 sums in
  both packages;
* the dense, chunked and decode paths at the smoke widths and at the
  default ranks (q 1536, kv 512, nope 128, rope 64, v 128) with 4 heads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as jax_mla
from repro_torch.models import mla

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

SMALL = dict(d_model=64, n_heads=4, q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
             qk_rope_dim=8, v_head_dim=16)
#: the smoke config's MLA: d_model 64, 4 heads, the default ranks
DEFAULT_RANKS = dict(d_model=64, n_heads=4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol=1e-5):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def pair(widths=SMALL, chunk=None, dtype="f32", seed=0):
    jdt, tdt = DTYPES[dtype]
    jcfg = jax_mla.MLAConfig(**widths, chunk=chunk, compute_dtype=jdt)
    pcfg = mla.MLAConfig(**widths, chunk=chunk, compute_dtype=tdt)
    jp = jax_mla.init_mla(jax.random.PRNGKey(seed), jcfg)
    pp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    return jcfg, pcfg, jp, pp


def inputs(rng, b, s, d=64):
    return rng.standard_normal((b, s, d)).astype(np.float32)


# ------------------------------------------------ mirrors of test_mla.py
def test_absorbed_decode_matches_train_attention(rng):
    """Token by token, the absorbed decode reproduces the train path's
    outputs (pure MLA, no MoE drops), at the JAX test's tolerance; and the
    port's decode equals JAX's decode at every step."""
    jcfg, cfg, jp, p = pair()
    b, s = 2, 7
    x = inputs(rng, b, s)
    full = mla.mla_train(p, cfg, torch.from_numpy(x), torch.arange(s))
    close(full, jax_mla.mla_train(jp, jcfg, jnp.asarray(x), jnp.arange(s)))
    cache = mla.init_mla_cache(cfg, b, 16, dtype=torch.float32)
    jcache = jax_mla.init_mla_cache(jcfg, b, 16, dtype=jnp.float32)
    for t in range(s):
        lengths = np.full((b,), t, np.int32)
        out, cache = mla.mla_decode_step(p, cfg, torch.from_numpy(x[:, t:t + 1]), cache,
                                         torch.from_numpy(lengths))
        jout, jcache = jax_mla.mla_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jcache,
                                               jnp.asarray(lengths))
        np.testing.assert_allclose(as_np(out[:, 0]), as_np(full[:, t]), rtol=2e-4, atol=2e-5)
        close(out, jout)
    close(cache["c_kv"], jcache["c_kv"])
    close(cache["k_rope"], jcache["k_rope"])


def test_cache_is_compressed():
    """The decode cache holds rank (dkv + rope) a token, not per-head K/V:
    at the deepseek config (512 + 64) against 2 x 128 x (128 + 64), 85x."""
    _, cfg, _, _ = pair()
    cache = mla.init_mla_cache(cfg, batch=1, max_len=10, dtype=torch.float32)
    jcache = jax_mla.init_mla_cache(pair()[0], batch=1, max_len=10, dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in jcache.items()}
    latent = cache["c_kv"].numel() + cache["k_rope"].numel()
    per_head_kv = 2 * cfg.n_heads * 10 * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    assert latent < per_head_kv / 2
    ds = mla.MLAConfig(d_model=7168, n_heads=128)
    ds_latent = ds.kv_lora_rank + ds.qk_rope_dim
    ds_mha = 2 * ds.n_heads * (ds.qk_nope_dim + ds.qk_rope_dim)
    assert ds_mha / ds_latent > 50 and ds_mha // ds_latent == 85


def test_decode_ragged_lengths(rng):
    """Sequences at different lengths stay independent; a write at
    max_len is dropped (the JAX one-hot is all zeros there)."""
    jcfg, cfg, jp, p = pair(seed=1)
    x = inputs(rng, 3, 1)
    lengths = np.array([0, 3, 8], np.int32)
    cache = mla.init_mla_cache(cfg, 3, 8, dtype=torch.float32)
    c_kv = cache["c_kv"]
    out, cache2 = mla.mla_decode_step(p, cfg, torch.from_numpy(x), cache,
                                      torch.from_numpy(lengths))
    assert cache2["c_kv"] is c_kv  # in place
    assert bool(torch.isfinite(out).all())
    # row 0 wrote at position 0; row 1 at position 3; row 2 nowhere
    assert float(c_kv[0, 0].abs().sum()) > 0 and float(c_kv[0, 3].abs().sum()) == 0
    assert float(c_kv[1, 3].abs().sum()) > 0 and float(c_kv[1, 0].abs().sum()) == 0
    assert float(c_kv[2].abs().sum()) == 0 and float(cache["k_rope"][2].abs().sum()) == 0
    jout, jcache = jax_mla.mla_decode_step(
        jp, jcfg, jnp.asarray(x), jax_mla.init_mla_cache(jcfg, 3, 8, dtype=jnp.float32),
        jnp.asarray(lengths))
    close(out, jout)
    close(c_kv, jcache["c_kv"])
    close(cache["k_rope"], jcache["k_rope"])


# ------------------------------- mirror of test_chunked_attention.py's MLA
def test_mla_chunked_equals_dense(rng):
    jcfg, dense_cfg, jp, p = pair()
    chunk_cfg = dataclasses.replace(dense_cfg, chunk=32)
    x = torch.from_numpy(inputs(rng, 2, 96))
    pos = torch.arange(96)
    a = mla.mla_train(p, dense_cfg, x, pos)
    b = mla.mla_train(p, chunk_cfg, x, pos)
    np.testing.assert_allclose(as_np(a), as_np(b), rtol=3e-3, atol=3e-3)


# ------------------------------------------------- each function vs JAX
@pytest.mark.parametrize("widths", [SMALL, DEFAULT_RANKS], ids=["small", "default_ranks"])
def test_init_draws_the_jax_shapes(widths):
    jcfg, cfg, jp, _ = pair(widths)
    meta = mla.init_mla(None, cfg)
    drawn = mla.init_mla(torch.Generator().manual_seed(0), cfg)
    assert list(meta) == list(jp) == list(drawn)
    for name, leaf in jp.items():
        key = "w" if "w" in leaf else "scale"
        assert tuple(meta[name][key].shape) == leaf[key].shape, name
    wo = drawn["wo"]["w"]
    assert abs(float(wo.std()) * wo.shape[0] ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_compress_and_expand_match_jax(positions, rng):
    jcfg, cfg, jp, p = pair(DEFAULT_RANKS)
    x = inputs(rng, 2, 5)
    pos = np.arange(5) if positions == "shared" else rng.integers(0, 50, (2, 5))
    want = jax_mla._compress(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = mla._compress(p, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):  # q_nope, q_rope, c_kv, k_rope
        close(g, w)
    for g, w in zip(mla._expand_kv(p, cfg, got[2]), jax_mla._expand_kv(jp, jcfg, want[2])):
        close(g, w)


def attend_inputs(rng, b=2, h=4, s=40, t=None, dn=16, dr=8, dv=16, dtype="f32"):
    t = t or s
    arrays = (rng.standard_normal((b, h, s, dn)), rng.standard_normal((b, h, s, dr)),
              rng.standard_normal((b, h, t, dn)), rng.standard_normal((b, 1, t, dr)),
              rng.standard_normal((b, h, t, dv)))
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a.astype(np.float32)).to(tdt) for a in arrays])


def test_attend_dense_matches_jax(rng):
    jcfg, cfg, _, _ = pair()
    jargs, targs = attend_inputs(rng)
    rows = np.arange(40)
    want = jax_mla._attend(jcfg, *jargs, causal_rows=jnp.asarray(rows),
                           visible_cols=jnp.asarray(rows))
    got = mla._attend(cfg, *targs, causal_rows=torch.from_numpy(rows),
                      visible_cols=torch.from_numpy(rows))
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("s", [96, 100, 20])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attend_chunked_matches_jax(s, dtype, rng):
    """Chunk 32: S = 96 (three whole chunks), 100 (padded to 128) and 20
    (one padded chunk); in bf16 the products round where JAX's do."""
    jcfg, cfg, _, _ = pair(dtype=dtype)
    jargs, targs = attend_inputs(rng, s=s, dtype=dtype)
    want = jax_mla._attend_chunked(jcfg, *jargs, chunk=32)
    got = mla._attend_chunked(cfg, *targs, chunk=32)
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("s,chunk", [(24, None), (24, 32), (96, 32), (100, 32)])
def test_mla_train_matches_jax_on_both_branches(s, chunk, rng):
    """The chunked branch only when chunk is set and S > chunk: (24, 32)
    takes the dense one."""
    jcfg, cfg, jp, p = pair(DEFAULT_RANKS, chunk=chunk)
    x = inputs(rng, 2, s)
    want = jax.jit(lambda p, x: jax_mla.mla_train(p, jcfg, x, jnp.arange(s)))(jp, jnp.asarray(x))
    close(mla.mla_train(p, cfg, torch.from_numpy(x), torch.arange(s)), want)


def test_mla_decode_step_matches_jax_in_bf16(rng):
    """The compute dtype rounds q_eff, w and ctx where the reference does:
    the port's bf16 decode is within bf16 rounding of JAX's."""
    jcfg, cfg, jp, p = pair(DEFAULT_RANKS, dtype="bf16", seed=2)
    b, s_max = 2, 12
    cache = mla.init_mla_cache(cfg, b, s_max, dtype=torch.bfloat16)
    jcache = jax_mla.init_mla_cache(jcfg, b, s_max, dtype=jnp.bfloat16)
    lengths = np.array([0, 4], np.int32)
    for _ in range(5):
        x = inputs(rng, b, 1)
        out, cache = mla.mla_decode_step(p, cfg, torch.from_numpy(x).to(torch.bfloat16), cache,
                                         torch.from_numpy(lengths))
        jout, jcache = jax_mla.mla_decode_step(jp, jcfg, jnp.asarray(x, jnp.bfloat16), jcache,
                                               jnp.asarray(lengths))
        got, want = as_np(out), as_np(jout)
        assert np.abs(got - want).mean() <= 2e-2 * np.abs(want).mean()
        lengths = lengths + 1
    c_got, c_want = as_np(cache["c_kv"]), as_np(jcache["c_kv"])
    assert np.abs(c_got - c_want).max() <= 2 ** -6 * np.abs(c_want).max()
