"""The port's MoE (``repro_torch.models.moe``) against the JAX package's,
on the CPU.

Both packages compute with the same weights: the JAX ``init_moe`` draws
them and they are carried across as numpy arrays.  Inputs come from
numpy seeds.  The config is the qwen2-moe smoke config's MoE (d 64,
per-expert width 32, 6 experts, top 2, 2 shared experts).

Tolerances:

* slots and dropped assignments: exactly equal;
* float32 compute: 1e-5 (float32 sums in another order);
* bfloat16 compute: 2e-2, as ``tests/test_torch_models.py`` uses in
  bf16 (the two frameworks round the expert products and the SiLU at
  other points; the routing is float32 in both and drops the same
  assignments);
* the combine's bf16 sums: bit for bit, since they add the same bf16
  values in the same order;
* the balance and z losses: 1e-6 relative (float32 sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import common as jax_common
from repro.models import moe as jax_moe
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def to_torch(tree):
    return jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def configs(dtype="f32"):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = dataclasses.replace(jax_smoke_config("qwen2_moe_a2_7b"), compute_dtype=jdt).moe_config()
    pcfg = dataclasses.replace(get_smoke_config("qwen2_moe_a2_7b"), compute_dtype=tdt).moe_config()
    return jcfg, pcfg, tol


@pytest.fixture(scope="module")
def params():
    jcfg, _, _ = configs()
    p = jax_moe.init_moe(jax.random.PRNGKey(3), jcfg)
    return jax.tree_util.tree_map(np.asarray, p)


def jax_routing(p, cfg, x):
    """The JAX package's routing of x (its own functions, in moe_apply's
    order): top-k expert ids (B, S, k) and which assignments are kept."""
    logits = jax_common.linear(p["router"], x, compute_dtype=cfg.compute_dtype).astype(jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    b, s, k = top_e.shape
    cap = max(int(s * k / cfg.num_experts * cfg.capacity_factor), 4)
    slot = jax.vmap(lambda ef: jax_moe._positions_in_expert(ef, cfg.num_experts))(
        top_e.reshape(b, s * k))
    return np.asarray(top_e), np.asarray(slot < cap)


# ------------------------------------------------------ slots in an expert
@pytest.mark.parametrize("n,experts", [(1, 1), (12, 3), (64, 6), (257, 60)])
def test_positions_in_expert_equal_jax_ties_included(n, experts, rng):
    """Many assignments share an expert (every id repeats): the stable
    sort gives each expert's slots in row order, as jnp.argsort does."""
    e_flat = rng.integers(0, experts, n).astype(np.int32)
    want = np.asarray(jax_moe._positions_in_expert(jnp.asarray(e_flat), experts))
    got = moe._positions_in_expert(torch.from_numpy(e_flat).long(), experts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # each expert's slots are 0, 1, 2, ... in the row's order
    for e in range(experts):
        np.testing.assert_array_equal(got.numpy()[e_flat == e], np.arange((e_flat == e).sum()))


def test_positions_in_expert_batched_rows_are_groups(rng):
    e_flat = rng.integers(0, 5, (3, 40)).astype(np.int32)
    want = jax.vmap(lambda ef: jax_moe._positions_in_expert(ef, 5))(jnp.asarray(e_flat))
    got = moe._positions_in_expert(torch.from_numpy(e_flat).long(), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_k_puts_the_lower_expert_first_on_a_tie(params):
    """A zero router gives every expert the same prob: lax.top_k takes
    experts 0..k-1, and so must the port (torch.topk promises no order)."""
    _, pcfg, _ = configs()
    p = to_torch(params)
    p["router"]["w"] = torch.zeros_like(p["router"]["w"])
    x = torch.randn(2, 5, pcfg.d_model, generator=torch.Generator().manual_seed(0))
    _, probs, top_p, top_e = moe.route(p, pcfg, x)
    assert torch.equal(top_e, torch.arange(pcfg.top_k).expand(2, 5, -1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    want_e, _ = jax_routing(jp, configs()[0], jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    torch.testing.assert_close(top_p, torch.full_like(top_p, 1 / pcfg.top_k))


# ---------------------------------------------------------------- moe_apply
def run_both(params, dtype, x):
    jcfg, pcfg, tol = configs(dtype)
    want, want_aux = jax_moe.moe_apply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                       jnp.asarray(x))
    got, got_aux = moe.moe_apply(to_torch(params), pcfg, torch.from_numpy(x))
    return got, got_aux, want, want_aux, tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_overflowing_capacity_matches_jax(params, dtype, rng):
    """S = 32 gives capacity int(32*2/6*1.25) = 13 slots for a mean of
    10.7 assignments.  Each sequence's tokens share a component (a topic),
    so they crowd the same experts: some overflow, and both packages drop
    the same assignments."""
    jcfg, pcfg, _ = configs(dtype)
    b, s = 2, 32
    assert moe.capacity(pcfg, s) == 13
    x = (rng.standard_normal((b, s, pcfg.d_model))
         + 0.5 * rng.standard_normal((b, 1, pcfg.d_model))).astype(np.float32)
    got, got_aux, want, want_aux, tol = run_both(params, dtype, x)
    assert got.shape == (b, s, pcfg.d_model) and got.dtype == pcfg.compute_dtype
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)
    for name in ("balance_loss", "z_loss"):
        np.testing.assert_allclose(float(got_aux[name]), float(want_aux[name]), rtol=1e-6)
    # the same assignments dropped, and some are
    want_e, want_keep = jax_routing(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                    jnp.asarray(x))
    _, _, _, top_e = moe.route(to_torch(params), pcfg, torch.from_numpy(x))
    keep, _ = moe.dispatch_plan(top_e, pcfg.num_experts, moe.capacity(pcfg, s))
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert 0 < int((~keep).sum()) < keep.numel()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_within_capacity_matches_jax(params, dtype, rng):
    _, pcfg, _ = configs(dtype)
    x = rng.standard_normal((3, 8, pcfg.d_model)).astype(np.float32)
    got, got_aux, want, want_aux, tol = run_both(params, dtype, x)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(got_aux["z_loss"]), float(want_aux["z_loss"]), rtol=1e-6)


@pytest.mark.parametrize("b", [2, 5, 24])
def test_decode_folds_the_batch_into_one_group(params, b, rng):
    """S == 1, B > 1: one dispatch group of B tokens whose capacity comes
    from B (max(int(B*2/6*1.25), 4)); at B = 24, 10 slots an expert for a
    mean of 8 assignments."""
    _, pcfg, _ = configs()
    x = rng.standard_normal((b, 1, pcfg.d_model)).astype(np.float32)
    got, got_aux, want, want_aux, tol = run_both(params, "f32", x)
    assert got.shape == (b, 1, pcfg.d_model)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=tol, atol=tol)
    folded, _ = moe.moe_apply(to_torch(params), pcfg, torch.from_numpy(x.reshape(1, b, -1)))
    assert torch.equal(folded.reshape(got.shape), got)
    for name in ("balance_loss", "z_loss"):
        np.testing.assert_allclose(float(got_aux[name]), float(want_aux[name]), rtol=1e-6)


def test_serving_skips_the_losses(params, rng):
    _, pcfg, _ = configs()
    x = torch.from_numpy(rng.standard_normal((2, 6, pcfg.d_model)).astype(np.float32))
    with_losses, aux = moe.moe_apply(to_torch(params), pcfg, x)
    without, none = moe.moe_apply(to_torch(params), pcfg, x, losses=False)
    assert set(aux) == {"balance_loss", "z_loss"} and none == {}
    assert torch.equal(with_losses, without)


def test_moe_gradients_match_jax_float32(params, rng):
    """d(sum(out * r) + balance + z) / d(params, x): through the routing
    weights (the scattered top-k probs), the experts and the shared FFN."""
    jcfg, pcfg, _ = configs()
    x = (rng.standard_normal((2, 32, pcfg.d_model))
         + 0.5 * rng.standard_normal((2, 1, pcfg.d_model))).astype(np.float32)
    r = rng.standard_normal((2, 32, pcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_moe.moe_apply(p, jcfg, x)
        return jnp.sum(out * r) + aux["balance_loss"] + aux["z_loss"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params),
                                               jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda t: t.requires_grad_(True), to_torch(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_apply(p, pcfg, xt)
    (torch.sum(out * torch.from_numpy(r)) + aux["balance_loss"] + aux["z_loss"]).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jgp),
                                 jax.tree_util.tree_leaves(p)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ combine
def jax_combine(routing, weighted, s):
    """moe.py's combine, as the JAX package writes it (moe_apply's
    scatter-add into zeros, the sentinel rows dropped)."""
    d = weighted.shape[-1]
    return jax.vmap(
        lambda r, w: jnp.zeros((s, d), weighted.dtype)
        .at[r.reshape(-1)]
        .add(w.reshape(-1, d), mode="drop")
    )(routing, weighted)


def routing_table(buf_pos, b, s, k, e, cap):
    """The JAX routing table (B, E, C) from the buffer rows, as moe_apply
    builds it."""
    table = np.full((b, e * cap + 1), s, np.int32)
    tok = np.repeat(np.arange(s, dtype=np.int32), k)
    for i in range(b):
        table[i, buf_pos[i]] = tok
    return table[:, :-1].reshape(b, e, cap)


def test_combine_adds_in_xla_order_bit_for_bit():
    """bf16: 1 + 2^-8 + 2^-8 is 1 when the 1 comes first (each add rounds
    to even) and 1.0078125 when it comes last.  Token 0 takes experts 2
    and 0 with contributions 1, 2^-8 and (from expert 1) 2^-8: XLA adds
    them in buffer order, expert 0 first."""
    e, cap, s, k, d = 3, 4, 2, 3, 1
    top_e = torch.tensor([[[2, 0, 1], [1, 2, 0]]])
    keep, buf_pos = moe.dispatch_plan(top_e, e, cap)
    assert bool(keep.all())
    weighted = torch.zeros((1, e, cap, d), dtype=torch.bfloat16)
    weighted[0, 0, 0], weighted[0, 1, 0], weighted[0, 2, 0] = 2.0**-8, 2.0**-8, 1.0
    weighted[0, 0, 1], weighted[0, 1, 1], weighted[0, 2, 1] = 1.0, 2.0**-8, 2.0**-8
    got = moe._combine(weighted, buf_pos, top_e)
    want = jax_combine(jnp.asarray(routing_table(buf_pos.numpy(), 1, s, k, e, cap)),
                       jnp.asarray(weighted.float().numpy()).astype(jnp.bfloat16), s)
    assert as_f32(want)[0, :, 0].tolist() == [1.0078125, 1.0]
    assert as_f32(got)[0, :, 0].tolist() == [1.0078125, 1.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_combine_bits_equal_jax_on_random_routing(params, seed):
    """The combine of random bf16 expert outputs under the smoke config's
    routing at S = 32 (some assignments dropped): the port's bits equal
    the JAX scatter-add's."""
    _, pcfg, _ = configs("bf16")
    rng = np.random.default_rng(seed)
    b, s = 2, 32
    x = torch.from_numpy((rng.standard_normal((b, s, pcfg.d_model))
                          + 0.5 * rng.standard_normal((b, 1, pcfg.d_model))).astype(np.float32))
    _, _, _, top_e = moe.route(to_torch(params), pcfg, x)
    cap = moe.capacity(pcfg, s)
    keep, buf_pos = moe.dispatch_plan(top_e, pcfg.num_experts, cap)
    assert not bool(keep.all())
    weighted = torch.from_numpy(
        rng.standard_normal((b, pcfg.num_experts, cap, pcfg.d_model)).astype(np.float32)
    ).to(torch.bfloat16)
    got = moe._combine(weighted, buf_pos, top_e)
    routing = routing_table(buf_pos.numpy(), b, s, pcfg.top_k, pcfg.num_experts, cap)
    want = jax_combine(jnp.asarray(routing),
                       jnp.asarray(weighted.float().numpy()).astype(jnp.bfloat16), s)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_init_moe_has_the_jax_shapes_and_scales(params):
    _, pcfg, _ = configs()
    mine = moe.init_moe(torch.Generator().manual_seed(0), pcfg)
    meta = moe.init_moe(None, pcfg)
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), mine) == want
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(meta))
    e, d, f = pcfg.num_experts, pcfg.d_model, pcfg.d_ff
    assert abs(float(mine["experts"]["gate"].std()) - d**-0.5) < 0.1 * d**-0.5
    assert abs(float(mine["experts"]["down"].std()) - f**-0.5) < 0.1 * f**-0.5
    assert tuple(mine["shared"]["gate"]["w"].shape) == (d, f * pcfg.num_shared)
    assert tuple(mine["router"]["w"].shape) == (d, e)
