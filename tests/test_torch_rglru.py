"""The RG-LRU block of the port (``repro_torch.models.rglru``) against the
JAX package's ``repro.models.rglru`` on the CPU.

Inputs and weights are drawn with numpy from fixed seeds and handed to
both.  Tolerance: ``F32`` (``tests/torch_parity.py``, 1e-5) relative to
the largest magnitude, the float32 rule of the other model tests: the
written-out scan combines in ``lax.associative_scan``'s order (on this
CPU it is bitwise equal to it), and the gates' float32 products and the
decode step's conv sum may round in another order.

* ``associative_scan`` against ``jax.lax.associative_scan`` at S in {1,
  2, 3, 7, 64, 257}: every branch of the recursion (even and odd
  lengths, the length-1 base), and autograd through it against JAX's
  gradient.
* ``rglru_block`` (the full sequence) and ``rglru_decode_step`` (one
  token, the state updated in place) against JAX, in float32 compute.
* A decode run, token by token from the zero state, equals the block's
  positions, as in the JAX package; the forward rounds the conv output to
  the compute dtype and the decode step does not, so in float32 compute
  the two agree within ``F32``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jax_rglru
from repro_torch.models import rglru
from torch_parity import F32

torch.set_num_threads(1)  # tiny tensors: extra threads only contend


def close(got, want, tol=F32):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def scan_inputs(s, seed=0, b=2, d=8):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (b, s, d)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return a, x


def jax_scan(a, x):
    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a1 * a2, a2 * b1 + b2

    return jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(x)), axis=1)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 257])
def test_scan_matches_lax_associative_scan(s):
    a, x = scan_inputs(s)
    want_a, want_h = jax_scan(a, x)
    got_a, got_h = rglru.associative_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert tuple(got_h.shape) == want_h.shape and got_h.dtype == torch.float32
    close(got_a, want_a)
    close(got_h, want_h)
    # and it is the recurrence h_t = a_t h_{t-1} + x_t
    h, seq = np.zeros_like(x[:, 0]), []
    for t in range(s):
        h = a[:, t] * h + x[:, t]
        seq.append(h)
    close(got_h, np.stack(seq, 1), tol=1e-4)


@pytest.mark.parametrize("s", [7, 64])
def test_scan_gradients_match_jax(s):
    """autograd through the written-out scan (``LM.loss`` differentiates
    it) against JAX's gradient of the same objective."""
    a, x = scan_inputs(s, seed=1)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jax_obj(a, x):
        return jnp.sum(jax_scan(a, x)[1] * w)

    want_da, want_dx = jax.grad(jax_obj, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(x))
    ta = torch.from_numpy(a).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (rglru.associative_scan(ta, tx)[1] * torch.from_numpy(w)).sum().backward()
    close(ta.grad, want_da)
    close(tx.grad, want_dx)


# ------------------------------------------------------------------ the block
D, DR = 16, 16


def block_pair(seed=0):
    """JAX's init of one block (float32 compute) and the same weights as
    the port's params (CPU tensors)."""
    jcfg = jax_rglru.RGLRUConfig(d_model=D, d_rnn=DR, compute_dtype=jnp.float32)
    pcfg = rglru.RGLRUConfig(d_model=D, d_rnn=DR, compute_dtype=torch.float32)
    jp = jax_rglru.init_rglru(jax.random.PRNGKey(seed), jcfg)
    pp = jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), jp)
    return jcfg, pcfg, jp, pp


def test_init_draws_the_jax_shapes_and_scales():
    jcfg, pcfg, jp, _ = block_pair()
    mine = rglru.init_rglru(torch.Generator().manual_seed(0),
                            rglru.RGLRUConfig(d_model=64, d_rnn=64))
    meta = rglru.init_rglru(None, pcfg)
    assert list(mine) == list(jp) == list(meta)
    for name, leaf in jp.items():
        want = leaf["w"].shape if isinstance(leaf, dict) else leaf.shape
        got = meta[name]["w"].shape if isinstance(leaf, dict) else meta[name].shape
        assert tuple(got) == want, name
    # a = sigmoid(Lambda)^8 spread in (0.9, 0.999)
    a = torch.sigmoid(mine["lam"]) ** 8
    assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 + 1e-6
    assert abs(float(mine["conv"].std()) - 0.1) < 0.03


@pytest.mark.parametrize("s", [1, 5, 33])
def test_block_matches_jax(s):
    jcfg, pcfg, jp, pp = block_pair()
    x = np.random.default_rng(s).standard_normal((2, s, D)).astype(np.float32)
    want = jax.jit(lambda p, x: jax_rglru.rglru_block(p, jcfg, x))(jp, jnp.asarray(x))
    got = rglru.rglru_block(pp, pcfg, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    close(got, want)


def test_decode_step_matches_jax_and_updates_in_place():
    jcfg, pcfg, jp, pp = block_pair(1)
    rng = np.random.default_rng(3)
    jstate = jax_rglru.init_rglru_state(jcfg, 2)
    pstate = rglru.init_rglru_state(pcfg, 2)
    assert {k: v.shape for k, v in jstate.items()} == \
        {k: tuple(v.shape) for k, v in pstate.items()}
    h_buf, conv_buf = pstate["h"], pstate["conv"]
    step = jax.jit(lambda p, x, st: jax_rglru.rglru_decode_step(p, jcfg, x, st))
    for _ in range(5):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, jstate = step(jp, jnp.asarray(x), jstate)
        got, pstate = rglru.rglru_decode_step(pp, pcfg, torch.from_numpy(x), pstate)
        close(got, want)
        close(pstate["h"], jstate["h"])
        close(pstate["conv"], jstate["conv"])
    assert pstate["h"] is h_buf and pstate["conv"] is conv_buf  # in place


def test_decode_run_equals_the_blocks_last_positions():
    """Token by token from the zero state, the decode step gives the full
    sequence block's output at every position, in both packages."""
    jcfg, pcfg, jp, pp = block_pair(2)
    s = 12
    x = np.random.default_rng(4).standard_normal((2, s, D)).astype(np.float32)
    full = rglru.rglru_block(pp, pcfg, torch.from_numpy(x))
    jfull = jax_rglru.rglru_block(jp, jcfg, jnp.asarray(x))
    state, jstate = rglru.init_rglru_state(pcfg, 2), jax_rglru.init_rglru_state(jcfg, 2)
    for t in range(s):
        got, state = rglru.rglru_decode_step(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), state)
        want, jstate = jax_rglru.rglru_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jstate)
        close(got[:, 0], full[:, t])
        close(want[:, 0], np.asarray(jfull)[:, t])


def test_bf16_block_follows_jax_precision():
    """In bf16 compute the gates' projections still take float32 operands
    and the conv is read as float32 (as in JAX), so the port's block is
    within bf16 rounding of JAX's: its mean difference is a small part of
    the output's scale."""
    _, _, jp, pp = block_pair(3)
    jcfg = jax_rglru.RGLRUConfig(d_model=D, d_rnn=DR, compute_dtype=jnp.bfloat16)
    pcfg = rglru.RGLRUConfig(d_model=D, d_rnn=DR, compute_dtype=torch.bfloat16)
    x = np.random.default_rng(5).standard_normal((2, 16, D)).astype(np.float32)
    want = np.asarray(jnp.asarray(
        jax_rglru.rglru_block(jp, jcfg, jnp.asarray(x, jnp.bfloat16)), jnp.float32))
    got = rglru.rglru_block(pp, pcfg, torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert np.abs(got - want).mean() <= 2e-2 * np.abs(want).mean()
