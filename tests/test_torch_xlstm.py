"""The xLSTM blocks of the port (``repro_torch.models.xlstm``) against the
JAX package's ``repro.models.xlstm`` on the CPU.

Inputs and weights are drawn with numpy (or JAX's init, carried across as
numpy) from fixed seeds and handed to both.  Tolerances:

* 1e-4 relative to the largest magnitude, in float32 compute: the chunk
  scan's products and the sLSTM's gate products sum in another order (the
  port computes the input's gates for every step in one product before
  the loop; JAX one step at a time);
* 2e-2 for the smoke model's decode against its forward, the JAX
  package's own tolerance for this config (``tests/test_arch_smoke.py``).

Cases:

* ``_mlstm_chunk_scan`` at S in {24, 64, 192} (one chunk shorter than 64,
  one whole chunk, three chunks), and its refusal of an S that is not a
  multiple of min(64, S), in both packages;
* ``mlstm_block``, ``mlstm_decode_step`` (state in place), ``_slstm_cell``,
  ``slstm_block`` and ``slstm_decode_step`` (state in place);
* a decode run from the zero state equals the blocks' positions;
* the LM: the smoke model's decode against its forward, and both
  packages' decode of the same weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import LM as JaxLM
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_numpy
from repro_torch.models import xlstm

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

TOL = 1e-4
D, H = 32, 2


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, want, tol=TOL):
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


def cfg_pair(dtype="f32"):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jax_xlstm.XLSTMConfig(d_model=D, n_heads=H, compute_dtype=jdt),
            xlstm.XLSTMConfig(d_model=D, n_heads=H, compute_dtype=tdt))


def block_pair(init, seed=0):
    jcfg, pcfg = cfg_pair()
    jp = getattr(jax_xlstm, init)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, pcfg, jp, to_torch(jp)


# ------------------------------------------------------------- chunk scan
def scan_inputs(s, seed=0, b=2, h=2, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    log_f = np.log(1 / (1 + np.exp(-rng.standard_normal((b, h, s)) - 2))).astype(np.float32)
    log_i = rng.standard_normal((b, h, s)).astype(np.float32)
    return q, k, v, log_f, log_i


@pytest.mark.parametrize("s", [24, 64, 192])
def test_chunk_scan_matches_jax(s):
    args = scan_inputs(s, seed=s)
    want = jax.jit(jax_xlstm._mlstm_chunk_scan)(*map(jnp.asarray, args))
    got = xlstm._mlstm_chunk_scan(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("s", [96, 130])
def test_chunk_scan_refuses_a_ragged_last_chunk_in_both_packages(s):
    args = scan_inputs(s)
    with pytest.raises(AssertionError):
        jax_xlstm._mlstm_chunk_scan(*map(jnp.asarray, args))
    with pytest.raises(AssertionError):
        xlstm._mlstm_chunk_scan(*map(torch.from_numpy, args))


def test_chunk_scan_is_the_recurrence():
    """Against the per-step stabilized recurrence (the decode step's
    arithmetic, in numpy float64): the chunked form computes the same
    function."""
    q, k, v, log_f, log_i = scan_inputs(128, seed=3)
    got = as_np(xlstm._mlstm_chunk_scan(*map(torch.from_numpy, (q, k, v, log_f, log_i))))
    b, h, s, d = q.shape
    C, n, m = np.zeros((b, h, d, d)), np.zeros((b, h, d)), np.zeros((b, h))
    want = np.zeros((b, h, s, d))
    for t in range(s):
        m_new = np.maximum(m + log_f[..., t], log_i[..., t])
        f_w, i_w = np.exp(m + log_f[..., t] - m_new), np.exp(log_i[..., t] - m_new)
        kt, vt, qt = k[:, :, t], v[:, :, t], q[:, :, t]
        C = C * f_w[..., None, None] + np.einsum("bhd,bhv->bhdv", kt * i_w[..., None], vt)
        n = n * f_w[..., None] + kt * i_w[..., None]
        num = np.einsum("bhd,bhdv->bhv", qt, C) / np.sqrt(d)
        den = np.maximum(np.abs(np.einsum("bhd,bhd->bh", qt, n)) / np.sqrt(d), np.exp(-m_new))
        want[:, :, t] = num / den[..., None]
        m = m_new
    close(got, want, tol=1e-4)


# ------------------------------------------------------------------ inits
@pytest.mark.parametrize("init", ["init_mlstm", "init_slstm"])
def test_init_draws_the_jax_shapes_and_scales(init):
    jcfg, pcfg, jp, _ = block_pair(init)
    meta = getattr(xlstm, init)(None, pcfg)
    drawn = getattr(xlstm, init)(torch.Generator().manual_seed(0), pcfg)
    assert list(meta) == list(jp) == list(drawn)
    for name, leaf in jp.items():
        key = "w" if "w" in leaf else "scale"
        assert tuple(meta[name][key].shape) == leaf[key].shape, name
        assert meta[name][key].device.type == "meta"
        assert drawn[name][key].dtype == torch.float32
    assert torch.equal(drawn["norm"]["scale"], torch.ones_like(drawn["norm"]["scale"]))
    # the down projection's scale, as in JAX
    down = drawn["down"]["w"]
    assert abs(float(down.std()) * down.shape[0] ** 0.5 - 1) < 0.15


# ------------------------------------------------------------------ mLSTM
@pytest.mark.parametrize("s", [8, 64, 128])
def test_mlstm_block_matches_jax(s):
    jcfg, pcfg, jp, pp = block_pair("init_mlstm")
    x = np.random.default_rng(s).standard_normal((2, s, D)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_xlstm.mlstm_block(p, jcfg, x))(jp, jnp.asarray(x))
    close(xlstm.mlstm_block(pp, pcfg, torch.from_numpy(x)), want)


def test_mlstm_decode_step_matches_jax_and_updates_in_place():
    jcfg, pcfg, jp, pp = block_pair("init_mlstm", 1)
    rng = np.random.default_rng(3)
    jstate = jax_xlstm.init_mlstm_state(jcfg, 2)
    pstate = xlstm.init_mlstm_state(pcfg, 2)
    assert {k: v.shape for k, v in jstate.items()} == {k: tuple(v.shape) for k, v in pstate.items()}
    bufs = dict(pstate)
    step = jax.jit(lambda p, x, st: jax_xlstm.mlstm_decode_step(p, jcfg, x, st))
    for _ in range(6):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, jstate = step(jp, jnp.asarray(x), jstate)
        got, pstate = xlstm.mlstm_decode_step(pp, pcfg, torch.from_numpy(x), pstate)
        close(got, want)
        for name in ("C", "n", "m"):
            close(pstate[name], jstate[name])
    assert all(pstate[k] is bufs[k] for k in bufs)  # in place


def test_mlstm_decode_run_equals_the_block():
    """Token by token from the zero state, the decode step gives the
    chunked block's output at every position, in both packages."""
    jcfg, pcfg, jp, pp = block_pair("init_mlstm", 2)
    s = 16
    x = np.random.default_rng(4).standard_normal((1, s, D)).astype(np.float32)
    full = xlstm.mlstm_block(pp, pcfg, torch.from_numpy(x))
    jfull = np.asarray(jax_xlstm.mlstm_block(jp, jcfg, jnp.asarray(x)))
    state, jstate = xlstm.init_mlstm_state(pcfg, 1), jax_xlstm.init_mlstm_state(jcfg, 1)
    for t in range(s):
        got, state = xlstm.mlstm_decode_step(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), state)
        want, jstate = jax_xlstm.mlstm_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        close(got[:, 0], full[:, t])
        close(want[:, 0], jfull[:, t])


# ------------------------------------------------------------------ sLSTM
def random_slstm_state(rng, b):
    return {"c": rng.standard_normal((b, D)), "n": rng.uniform(0.5, 2, (b, D)),
            "h": rng.standard_normal((b, D)), "m": rng.standard_normal((b, D))}


def test_slstm_cell_matches_jax():
    jcfg, pcfg, jp, pp = block_pair("init_slstm")
    rng = np.random.default_rng(5)
    state = {k: v.astype(np.float32) for k, v in random_slstm_state(rng, 3).items()}
    xt = rng.standard_normal((3, D)).astype(np.float32)
    want = jax_xlstm._slstm_cell(jp, jcfg, {k: jnp.asarray(v) for k, v in state.items()},
                                 jnp.asarray(xt))
    got = xlstm._slstm_cell(pp, pcfg, {k: torch.from_numpy(v) for k, v in state.items()},
                            torch.from_numpy(xt))
    assert list(got) == list(want)
    for name in want:
        close(got[name], want[name])


@pytest.mark.parametrize("s", [1, 9, 40])
def test_slstm_block_matches_jax(s):
    jcfg, pcfg, jp, pp = block_pair("init_slstm", 1)
    x = np.random.default_rng(s).standard_normal((2, s, D)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_xlstm.slstm_block(p, jcfg, x))(jp, jnp.asarray(x))
    close(xlstm.slstm_block(pp, pcfg, torch.from_numpy(x)), want)


def test_slstm_decode_step_matches_jax_and_updates_in_place():
    jcfg, pcfg, jp, pp = block_pair("init_slstm", 2)
    rng = np.random.default_rng(6)
    jstate = jax_xlstm.init_slstm_state(jcfg, 2)
    pstate = xlstm.init_slstm_state(pcfg, 2)
    assert {k: v.shape for k, v in jstate.items()} == {k: tuple(v.shape) for k, v in pstate.items()}
    bufs = dict(pstate)
    step = jax.jit(lambda p, x, st: jax_xlstm.slstm_decode_step(p, jcfg, x, st))
    for _ in range(6):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, jstate = step(jp, jnp.asarray(x), jstate)
        got, pstate = xlstm.slstm_decode_step(pp, pcfg, torch.from_numpy(x), pstate)
        close(got, want)
        for name in ("c", "n", "h", "m"):
            close(pstate[name], jstate[name])
    assert all(pstate[k] is bufs[k] for k in bufs)  # in place


def test_slstm_decode_run_equals_the_block():
    jcfg, pcfg, jp, pp = block_pair("init_slstm", 3)
    s = 10
    x = np.random.default_rng(7).standard_normal((1, s, D)).astype(np.float32)
    full = xlstm.slstm_block(pp, pcfg, torch.from_numpy(x))
    state = xlstm.init_slstm_state(pcfg, 1)
    for t in range(s):
        got, state = xlstm.slstm_decode_step(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), state)
        close(got[:, 0], full[:, t])


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_bf16_blocks_follow_jax_precision(block):
    """In bf16 compute both blocks round where JAX rounds: their mean
    difference from JAX is a small part of the output's scale."""
    _, _, jp, pp = block_pair(f"init_{block}", 4)
    jcfg, pcfg = cfg_pair("bf16")
    x = np.random.default_rng(8).standard_normal((2, 64, D)).astype(np.float32)
    fn = f"{block}_block"
    want = as_np(getattr(jax_xlstm, fn)(jp, jcfg, jnp.asarray(x, jnp.bfloat16)))
    got = as_np(getattr(xlstm, fn)(pp, pcfg, torch.from_numpy(x).to(torch.bfloat16)))
    assert np.abs(got - want).mean() <= 2e-2 * np.abs(want).mean()


# --------------------------------------------------------------------- LM
def smoke_pair():
    jcfg = jax_smoke_config("xlstm_350m")
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             get_smoke_config("xlstm_350m"), device="cpu")
    return jmodel, params, port


def test_smoke_model_decode_matches_its_forward():
    """Greedy decode logits equal the forward's at the same positions
    within the JAX package's tolerance for this config (2e-2), in bf16,
    as ``tests/test_arch_smoke.py::test_decode_matches_forward`` holds the
    JAX model."""
    jmodel, params, port = smoke_pair()
    seq = 8
    tokens = np.random.default_rng(0).integers(0, port.cfg.vocab, (1, seq)).astype(np.int32)
    full = port(torch.from_numpy(tokens))
    jfull = jmodel.forward(params, jnp.asarray(tokens))
    state = port.init_decode_state(1, max_len=32)
    for t in range(seq):
        logits, state = port.decode_step(state, torch.from_numpy(tokens[:, t:t + 1]),
                                         torch.tensor([t], dtype=torch.int32))
        np.testing.assert_allclose(as_np(logits[0, 0]), as_np(full[0, t]), rtol=2e-2, atol=2e-2)
    assert np.abs(as_np(full) - as_np(jfull)).mean() <= 2e-2


def test_lm_decode_state_is_the_jax_layout_and_matches_in_float32():
    jcfg = dataclasses.replace(jax_smoke_config("xlstm_350m"), compute_dtype=jnp.float32)
    pcfg = dataclasses.replace(get_smoke_config("xlstm_350m"), compute_dtype=torch.float32)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(2))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu")
    jstate, pstate = jmodel.init_decode_state(2, max_len=16), port.init_decode_state(2, max_len=16)
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jstate) == \
        jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), pstate)
    tokens = np.random.default_rng(1).integers(0, 256, (2, 5)).astype(np.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(5):
        lengths = np.full((2,), t, np.int32)
        want, jstate = step(params, jstate, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(lengths))
        got, pstate = port.decode_step(pstate, torch.from_numpy(tokens[:, t:t + 1]),
                                       torch.from_numpy(lengths))
        close(got, want)
    for blk in ("b0", "b1"):
        for name, leaf in jstate["seg0"][blk].items():
            close(pstate["seg0"][blk][name], leaf)
