"""The port's training step against the JAX package's, on the CPU.

The same smoke-size Yi-6B (2 layers, d 64) in both packages: the JAX
``LM.init`` tree is carried across leaf for leaf (the port trains on the
same tree, stacked leaves and all), the batches are drawn with numpy from
a seed, and the port runs with ``device="cpu"``.

Tolerances, stated once here and beside each assert:

* float32 compute (``compute_dtype=float32, compute_cast=None``): the two
  packages sum in other orders, so a value may differ by a few float32
  ulps of the largest value it is compared with (``F32``);
* the defaults (bf16 compute, bf16 compute cast): both round to bf16 at
  every product, but XLA and torch round at different points, so a
  gradient leaf may differ by a few bf16 ulps (2^-8 relative) of its
  largest element (``BF16_MAX``), and by much less on average
  (``BF16_MEAN``);
* within the port, the remat modes are bitwise equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.distribution.compression import compress_decompress as jax_compress
from repro.models import LM as JaxLM
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.train import optimizer as jax_opt
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.step import TrainStepConfig as JaxStepConfig
from repro.train.step import make_train_state as jax_make_state
from repro.train.step import make_train_step as jax_make_step
from repro.utils import tree as jax_tree
from repro_torch.configs import get_smoke_config
from repro_torch.distribution.compression import compress_decompress, init_compression
from repro_torch.models import LM
from repro_torch.models.common import cross_entropy
from repro_torch.train import AdamWConfig, TrainStepConfig, warmup_cosine
from repro_torch.train import optimizer as port_opt
from repro_torch.train.step import make_train_state, make_train_step
from repro_torch.utils import tree as port_tree
from torch_parity import F32, assert_mostly_close, to_numpy, to_torch

#: bf16 compute: a gradient leaf within 4% of its largest |element| (about
#: 10 bf16 ulps there; measured 0.6-1.3%), 0.5% on average (measured 0.1-0.3%)
BF16_MAX, BF16_MEAN = 4e-2, 5e-3


def tokens_batch(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model) at float32 and at the defaults."""
    out = {}
    for name, jdt, pdt in (("f32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jm = JaxLM(dataclasses.replace(jax_smoke_config("yi_6b"), compute_dtype=jdt))
        out[name] = (jm, jm.init(jax.random.PRNGKey(0)),
                     LM(dataclasses.replace(get_smoke_config("yi_6b"), compute_dtype=pdt)))
    return out


def jax_grads(jm, params, batch, cast):
    def loss(p):
        if cast:
            p = jax.tree_util.tree_map(
                lambda x: x.astype(jnp.bfloat16) if x.ndim >= 2 else x, p)
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]

    value, grads = jax.value_and_grad(loss)(params)
    return float(value), {k: np.asarray(v) for k, v in jax_tree.flatten_with_paths(grads).items()}


def port_grads(pm, params_np, batch, cast):
    masters = port_tree.tree_map(lambda x: x.requires_grad_(True), to_torch(params_np))
    used = port_tree.tree_map(
        lambda t: t.to(torch.bfloat16) if cast and t.ndim >= 2 else t, masters)
    loss, metrics = pm.loss(used, {k: torch.from_numpy(v) for k, v in batch.items()})
    flat = port_tree.flatten_with_paths(masters)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), metrics, dict(zip(flat, grads))


# ------------------------------------------------------------------ trees
def test_tree_paths_and_sizes_match_jax(models):
    jm, params, pm = models["f32"]
    for opt in ("adamw", "adafactor"):
        jcfg = JaxStepConfig(optimizer=opt, compress_grads=True)
        jstate = jax_make_state(jm, params, jcfg)
        pparams = to_torch(to_numpy(params))
        pstate = make_train_state(pm, pparams, TrainStepConfig(optimizer=opt, compress_grads=True))
        jflat = jax_tree.flatten_with_paths((params, jstate))
        pflat = port_tree.flatten_with_paths((pparams, pstate))
        assert list(pflat) == list(jflat)  # the JAX paths, in the JAX order
        for k, v in jflat.items():
            assert tuple(pflat[k].shape) == tuple(v.shape), k
            assert str(pflat[k].dtype).split(".")[-1] == str(v.dtype), k
        assert port_tree.tree_size_bytes((pparams, pstate)) == jax_tree.tree_size_bytes(
            (params, jstate))
        assert port_tree.tree_param_count(pstate) == jax_tree.tree_param_count(jstate)
        assert port_tree.unflatten_like((pparams, pstate), pflat) == (pparams, pstate)
    # the optimizer state sits under "opt": its count, and a stacked norm
    # scale's factored v
    assert {"/".join(p) for p in (("1", "opt", "count"),
                                  ("1", "opt", "v", "seg0", "b0", "norm1", "scale", "row"))} <= set(jflat)
    assert {"0/seg0/b0/attn/wq/w", "1/step", "1/ef/embed/table"} <= set(pflat)


def test_init_params_is_the_jax_layout(models):
    _, params, pm = models["f32"]
    mine = pm.init_params(torch.Generator().manual_seed(0))
    meta = pm.init_params(None)
    jflat = jax_tree.flatten_with_paths(params)
    for tree in (mine, meta):
        flat = port_tree.flatten_with_paths(tree)
        assert list(flat) == list(jflat)
        assert all(tuple(flat[k].shape) == tuple(v.shape) for k, v in jflat.items())
    assert all(t.is_meta for t in port_tree.tree_leaves(meta))
    # the same draws as LM.init, before its cast: the serving module built
    # from the tree equals the one init draws into
    served = LM(pm.cfg).init(torch.Generator().manual_seed(0))
    from repro_torch.models import params_from_numpy

    rebuilt = params_from_numpy(mine, pm.cfg, device="cpu")
    for (k, a), (_, b) in zip(served.state_dict().items(), rebuilt.state_dict().items()):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32) if masked else None
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   mask=None if mask is None else jnp.asarray(mask)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                              mask=None if mask is None else torch.from_numpy(mask)))
    assert got == pytest.approx(want, rel=F32)  # float32, another summation order
    if masked:  # an all-zero mask divides by max(sum, 1): the loss is 0
        zero = torch.zeros((3, 5))
        assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   mask=zero)) == 0.0


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_loss_and_grads_match_jax_float32(models, masked):
    jm, params, pm = models["f32"]
    batch = {"tokens": tokens_batch((4, 17))}
    if masked:
        batch["loss_mask"] = (np.random.default_rng(1).random((4, 17)) < 0.7).astype(np.float32)
    want, jg = jax_grads(jm, params, batch, cast=False)
    got, metrics, pg = port_grads(pm, to_numpy(params), batch, cast=False)
    assert got == pytest.approx(want, rel=F32)
    assert set(metrics) == {"ce", "aux", "loss"} and float(metrics["aux"]) == 0.0
    assert list(pg) == list(jg)
    for k, g in pg.items():
        scale = np.abs(jg[k]).max()
        # float32 sums in another order: within F32 of the leaf's largest gradient
        np.testing.assert_allclose(g.numpy(), jg[k], rtol=0, atol=F32 * scale, err_msg=k)


def test_loss_and_grads_match_jax_at_the_defaults(models):
    """bf16 compute with the bf16 compute cast, stacked norm scales cast too."""
    jm, params, pm = models["bf16"]
    batch = {"tokens": tokens_batch((4, 17))}
    want, jg = jax_grads(jm, params, batch, cast=True)
    got, _, pg = port_grads(pm, to_numpy(params), batch, cast=True)
    assert got == pytest.approx(want, rel=1e-3)  # measured 1e-4 relative
    for k, g in pg.items():
        assert g.dtype == torch.float32, k  # gradients of the float32 masters
        diff = np.abs(g.numpy() - jg[k])
        scale = np.abs(jg[k]).max()
        assert diff.max() <= BF16_MAX * scale, (k, diff.max(), scale)
        assert diff.mean() <= BF16_MEAN * scale, (k, diff.mean(), scale)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_remat_modes_are_bitwise_equal(models, compute):
    _, params, pm = models[compute]
    batch = {"tokens": tokens_batch((2, 17), seed=5),
             "loss_mask": (np.random.default_rng(2).random((2, 17)) < 0.8).astype(np.float32)}
    out = {}
    for mode in ("none", "full", "dots"):
        model = LM(dataclasses.replace(pm.cfg, remat=mode))
        out[mode] = port_grads(model, to_numpy(params), batch, cast=compute == "bf16")
    for mode in ("full", "dots"):
        assert out[mode][0] == out["none"][0]
        for k, g in out["none"][2].items():
            assert torch.equal(out[mode][2][k], g), (mode, k)


def test_unknown_remat_mode_is_refused(models):
    _, params, pm = models["f32"]
    model = LM(dataclasses.replace(pm.cfg, remat="sometimes"))
    with pytest.raises(ValueError, match="remat"):
        port_grads(model, to_numpy(params), {"tokens": tokens_batch((1, 5))}, cast=False)


def test_chunked_attention_gradients_match_jax():
    """The reference attention the trainer runs past 1024 tokens is the
    chunked online softmax; its gradients match the JAX package's at a
    small chunk (float32: F32 of the largest gradient)."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as port_attn

    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 4, 24, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((1, 4, 24, 16)).astype(np.float32)
    for window in (None, 7):
        def jloss(q, k, v):
            out = jax_attn._sdpa_chunked(q, k, v, causal=True, window=window, chunk=8)
            return jnp.sum(out * w)

        jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        pt = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = port_attn._sdpa_chunked(*pt, causal=True, window=window, chunk=8)
        pg = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), pt)
        for a, b in zip(pg, jg):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=F32 * np.abs(b).max())


def test_training_with_the_flash_kernel_is_refused_in_both_packages(models):
    jm, params, pm = models["f32"]
    batch = {"tokens": tokens_batch((2, 16))}
    jflash = JaxLM(dataclasses.replace(jm.cfg, use_flash_kernel=True))
    with pytest.raises(AssertionError):  # raised inside Pallas: no VJP
        jax.value_and_grad(lambda p: jflash.loss(p, {"tokens": jnp.asarray(batch["tokens"])})[0])(
            params)
    pflash = LM(dataclasses.replace(pm.cfg, use_flash_kernel=True))
    with pytest.raises(NotImplementedError, match="no backward"):
        port_grads(pflash, to_numpy(params), batch, cast=False)
    step = make_train_step(pflash, TrainStepConfig())
    pparams = to_torch(to_numpy(params))
    with pytest.raises(NotImplementedError, match="use_flash_kernel"):
        step(pparams, make_train_state(pflash, pparams, TrainStepConfig()),
             {"tokens": torch.from_numpy(batch["tokens"])})
    with torch.no_grad():  # evaluating the loss is not training
        pflash.loss(to_torch(to_numpy(params)), {"tokens": torch.from_numpy(batch["tokens"])})


# -------------------------------------------------------------- schedule
def test_warmup_cosine_matches_jax_to_the_ulp():
    """Against the JAX schedule, eager and jitted (the JAX step runs it
    jitted; the two differ from each other by a few ulps of the result).
    The warm-up is the same float32 arithmetic: equal.  Past it, ``cos``
    may round differently in the last place, and near the end ``1 +
    cos(pi p)`` cancels, so the comparison is one float32 ulp of
    ``peak_lr`` (one cos ulp moves the result by at most half of it)."""
    kw = dict(peak_lr=3e-4, warmup_steps=7, total_steps=53)
    steps = np.arange(0, 60, dtype=np.int32)
    eager = np.array([float(jax_warmup_cosine(jnp.int32(s), **kw)) for s in steps], np.float32)
    jitted = np.asarray(jax.jit(lambda s: jax_warmup_cosine(s, **kw))(jnp.asarray(steps)))
    got = warmup_cosine(torch.from_numpy(steps), **kw).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:7], eager[:7])
    ulp = np.spacing(np.float32(kw["peak_lr"]))
    assert np.abs(got - eager).max() <= ulp
    # jitted, XLA divides by the warm-up as a product with its reciprocal:
    # that alone moves the reference by up to 1.5 ulps of peak_lr
    assert np.abs(jitted - eager).max() <= 2 * ulp
    assert np.abs(got - jitted).max() <= 2 * ulp
    assert got[0] == 0.0 and got[7] == pytest.approx(3e-4) and got[-1] == pytest.approx(3e-5)


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(torch.tensor(s, dtype=torch.int32), peak_lr=1.0,
                               warmup_steps=10, total_steps=100)) for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


# ------------------------------------------------------------- optimizers
def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = port_opt.adamw_init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw w^2
        params, state = port_opt.adamw_update(params, grads, state, cfg, torch.tensor(0.05))
    assert float(params["w"].abs().max()) < 1e-2


def test_adafactor_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.full((4, 3), 3.0)}
    state = port_opt.adafactor_init(params, cfg)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        params, state = port_opt.adafactor_update(params, grads, state, cfg, torch.tensor(0.05))
    assert float(params["w"].abs().max()) < 5e-2


def grads_like(params, seed):
    """Gradients of every leaf, a tenth of each leaf's elements tiny (about
    1e-9), where Adam's first step is +-lr by the gradient's sign."""
    rng = np.random.default_rng(seed)

    def one(p):
        g = rng.standard_normal(p.shape).astype(np.float32) * 1e-2
        tiny = rng.random(p.shape) < 0.1
        return np.where(tiny, g * 1e-7, g).astype(np.float32)

    return jax.tree_util.tree_map(one, to_numpy(params))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("n_updates", [1, 3])
def test_optimizer_updates_match_jax(models, name, n_updates):
    """The same tree and gradients through n updates of both packages.

    Adam's update is ``m_hat / (sqrt(v_hat) + eps)``: at the first step
    that is ``g / (|g| + 1e-8)``, +-lr wherever |g| >> 1e-8, so an
    element is only as stable as its gradient's sign.  Here the two
    packages get the same float32 gradients, so no sign differs; where
    |g| is near eps (the tiny tenth) the update is a smooth function of g
    and agrees to F32 too.  The tolerance on every parameter is F32 of
    lr per step taken, relative to nothing larger: a sign flip would show
    as a difference of 2 lr, 10^5 times that."""
    jm, params, _ = models["f32"]
    init = getattr(jax_opt, f"{name}_init")
    update = getattr(jax_opt, f"{name}_update")
    cfg_j = jax_opt.AdamWConfig()
    cfg_p = AdamWConfig()
    jp, js = params, init(params, cfg_j)
    pp = to_torch(to_numpy(params))
    ps = getattr(port_opt, f"{name}_init")(pp, cfg_p)
    lr = 1e-3
    for i in range(n_updates):
        g = grads_like(params, seed=10 + i)
        jp, js = update(jp, jax.tree_util.tree_map(jnp.asarray, g), js, cfg_j, jnp.float32(lr))
        pp2, ps2 = getattr(port_opt, f"{name}_update")(pp, to_torch(g), ps, cfg_p,
                                                        torch.tensor(lr, dtype=torch.float32))
        assert pp2 is pp and ps2 is ps  # in place
    jflat = jax_tree.flatten_with_paths((jp, js))
    pflat = port_tree.flatten_with_paths((pp, ps))
    assert list(pflat) == list(jflat)
    for k, want in jflat.items():
        got = pflat[k]
        want = np.asarray(want)
        if k.startswith("0/"):  # parameters: F32 of lr per update
            np.testing.assert_allclose(got.numpy(), want, rtol=F32,
                                       atol=F32 * lr * n_updates, err_msg=k)
        elif got.dtype == torch.bfloat16:  # Adafactor's m: one bf16 ulp of itself
            got = got.float().numpy()
            want = want.astype(np.float32)
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-30, err_msg=k)
        elif got.dtype == torch.int32:
            assert int(got) == int(want) == n_updates
        else:  # moments: F32
            np.testing.assert_allclose(got.numpy(), want, rtol=F32,
                                       atol=F32 * np.abs(want).max(), err_msg=k)
    if name == "adafactor":  # a stacked norm scale's v is factored over the layer axis
        assert tuple(pflat["1/v/seg0/b0/norm1/scale/row"].shape) == (2,)
        assert tuple(pflat["1/v/seg0/b0/norm1/scale/col"].shape) == (64,)
        assert tuple(pflat["1/v/final_norm/scale/full"].shape) == (64,)


# ----------------------------------------------------------- compression
def test_compression_matches_jax_bitwise():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((3, 40)).astype(np.float32),
         "b": (rng.standard_normal(7) * 1e-3).astype(np.float32)}
    g["w"][0, :4] = [0.5, -0.5, 1.5, 2.5]  # exact halves: round half to even
    jstate = jax.tree_util.tree_map(jnp.zeros_like, g)
    pstate = init_compression(to_torch(g))
    for _ in range(3):
        jg, jstate = jax_compress(jax.tree_util.tree_map(jnp.asarray, g), jstate)
        pg, pstate = compress_decompress(to_torch(g), pstate)
        for k in g:
            np.testing.assert_array_equal(pg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(pstate[k].numpy(), np.asarray(jstate[k]))


def test_compression_error_feedback_unbiased():
    """Sum of dequantized grads + final residual == sum of true grads."""
    rng = np.random.default_rng(0)
    seq = [{"w": torch.from_numpy(rng.standard_normal(64).astype(np.float32))}
           for _ in range(20)]
    state = init_compression(seq[0])
    total = torch.zeros(64)
    for g in seq:
        dq, state = compress_decompress(g, state)
        total = total + dq["w"]
    true = sum(g["w"] for g in seq)
    np.testing.assert_allclose((total + state["w"]).numpy(), true.numpy(), rtol=1e-5, atol=1e-5)
    assert float((total - true).abs().max()) < 0.1


# ------------------------------------------------------------ train step
def run_steps(jm, pm, params, jcfg, pcfg, batches):
    jstate = jax_make_state(jm, params, jcfg)
    jstep = jax.jit(jax_make_step(jm, jcfg))
    pparams = to_torch(to_numpy(params))
    pstate = make_train_state(pm, pparams, pcfg)
    pstep = make_train_step(pm, pcfg)
    jp = params
    for b in batches:
        jp, jstate, jmet = jstep(jp, jstate, {"tokens": jnp.asarray(b)})
        pparams, pstate, pmet = pstep(pparams, pstate, {"tokens": torch.from_numpy(b)})
    return (jp, jstate, jmet), (pparams, pstate, pmet)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_steps_match_jax_float32(models, optimizer):
    """Three steps, with the int8 compression on for AdamW, at float32
    compute: the metrics and the optimizer state within F32, the
    parameters, Adafactor's ``m`` and the compression's residuals by
    ``assert_mostly_close``."""
    jm, params, pm = models["f32"]
    kw = dict(optimizer=optimizer, compute_cast=None, peak_lr=1e-3, warmup_steps=2,
              total_steps=10, compress_grads=optimizer == "adamw")
    batches = [tokens_batch((4, 17), seed=s) for s in range(3)]
    (jp, js, jmet), (pp, ps, pmet) = run_steps(
        jm, pm, params, JaxStepConfig(**kw), TrainStepConfig(**kw), batches)
    assert set(pmet) == set(jmet)
    for k in jmet:
        assert float(pmet[k]) == pytest.approx(float(jmet[k]), rel=F32, abs=1e-12), k
    jflat = jax_tree.flatten_with_paths((jp, js))
    pflat = port_tree.flatten_with_paths((pp, ps))
    assert list(pflat) == list(jflat)
    for k, want in jflat.items():
        want = np.asarray(want).astype(np.float32)
        got = pflat[k].float().numpy()
        top = np.abs(want).max()
        if k.startswith("0/"):  # parameters: an update is at most lr in size
            assert_mostly_close(got, want, rtol=F32, atol=F32 * 1e-3 * 3,
                                bound=2 * 1e-3 * 3, key=k)
        elif pflat[k].dtype == torch.bfloat16:  # Adafactor's m: one bf16 ulp
            assert_mostly_close(got, want, rtol=2 ** -7, atol=1e-30,
                                bound=2 ** -7 * top, key=k)
        elif k.startswith("1/ef/"):
            # a residual is the gradient less its quantized value: it carries
            # the gradient's F32 error, and the gradient's largest element is
            # 127 quanta (a quantum is about 2 max|residual|); a rounding tie
            # moves a residual by one quantum
            quantum = 2 * top
            assert_mostly_close(got, want, rtol=0, atol=F32 * 127 * quantum,
                                bound=quantum * (1 + 1e-2), key=k)
        else:  # moments: F32; where a compression tie moved a gradient by a
            # quantum (1/127 of its largest), m moves by (1 - b1) of it: under
            # 1% of the leaf's largest |m|
            assert_mostly_close(got, want, rtol=F32, atol=F32 * top, bound=2e-2 * top, key=k)


def test_train_step_compute_cast_reaches_stacked_norm_scales(models):
    """At the defaults the step casts every float32 leaf of rank >= 2:
    the stacked block norm scales compute in bf16, final_norm stays
    float32 (the rule reads ranks, and the tree is the JAX layout)."""
    _, params, pm = models["bf16"]
    seen = {}
    real_loss = pm.loss

    def spy(p, batch):
        seen.update({k: v.dtype for k, v in port_tree.flatten_with_paths(p).items()})
        return real_loss(p, batch)

    pm.loss = spy
    try:
        pparams = to_torch(to_numpy(params))
        cfg = TrainStepConfig()
        make_train_step(pm, cfg)(pparams, make_train_state(pm, pparams, cfg),
                                 {"tokens": torch.from_numpy(tokens_batch((2, 9)))})
    finally:
        del pm.loss
    assert seen["seg0/b0/norm1/scale"] == torch.bfloat16
    assert seen["seg0/b0/attn/wq/w"] == torch.bfloat16
    assert seen["final_norm/scale"] == torch.float32
    assert all(t.dtype == torch.float32 for t in port_tree.tree_leaves(pparams))


def test_train_steps_match_jax_at_the_defaults(models):
    """Three AdamW steps at bf16 compute and cast: the loss within 1e-3
    relative each step; after three steps of lr 1e-3, every parameter
    within 3 lr of JAX's (an element may move by up to 2 lr where a bf16
    gradient's sign differs between the frameworks), and on average
    within lr / 4."""
    jm, params, pm = models["bf16"]
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    batches = [tokens_batch((4, 17), seed=s) for s in range(3)]
    (jp, _, jmet), (pp, _, pmet) = run_steps(
        jm, pm, params, JaxStepConfig(**kw), TrainStepConfig(**kw), batches)
    assert float(pmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-3)
    jflat = jax_tree.flatten_with_paths(jp)
    for k, got in port_tree.flatten_with_paths(pp).items():
        diff = np.abs(got.numpy() - np.asarray(jflat[k]))
        assert diff.max() <= 3 * 1e-3 and diff.mean() <= 1e-3 / 4, (k, diff.max(), diff.mean())


def test_grad_accumulation_matches_big_batch_and_jax(models):
    """accum_steps=2 on (2, 2, 17) against one batch of (4, 17) in the
    port (the JAX test's tolerances), and against JAX's accum_steps=2
    (float32: F32)."""
    jm, params, pm = models["f32"]
    tokens = tokens_batch((4, 17), seed=1)
    one = TrainStepConfig(accum_steps=1, peak_lr=1e-3, grad_clip=1e9, compute_cast=None)
    acc = TrainStepConfig(accum_steps=2, peak_lr=1e-3, grad_clip=1e9, compute_cast=None)
    p1 = to_torch(to_numpy(params))
    p2 = to_torch(to_numpy(params))
    p1, _, m1 = make_train_step(pm, one)(p1, make_train_state(pm, p1, one),
                                         {"tokens": torch.from_numpy(tokens)})
    p2, _, m2 = make_train_step(pm, acc)(p2, make_train_state(pm, p2, acc),
                                         {"tokens": torch.from_numpy(tokens.reshape(2, 2, 17))})
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    for a, b in zip(port_tree.tree_leaves(p1), port_tree.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)

    jacc = JaxStepConfig(accum_steps=2, peak_lr=1e-3, grad_clip=1e9, compute_cast=None)
    jp, _, jm2 = jax.jit(jax_make_step(jm, jacc))(
        params, jax_make_state(jm, params, jacc), {"tokens": jnp.asarray(tokens.reshape(2, 2, 17))})
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=F32)
    assert float(m2["ce"]) == pytest.approx(float(jm2["ce"]), rel=F32)  # the last microbatch's
    jflat = jax_tree.flatten_with_paths(jp)
    for k, got in port_tree.flatten_with_paths(p2).items():
        np.testing.assert_allclose(got.numpy(), np.asarray(jflat[k]), rtol=F32,
                                   atol=F32 * 1e-3, err_msg=k)


def test_train_step_reduces_loss_tiny_lm():
    pm = LM(get_smoke_config("yi_6b"))
    params = pm.init_params(torch.Generator().manual_seed(0))
    cfg = TrainStepConfig(peak_lr=3e-3, warmup_steps=5, total_steps=60)
    state = make_train_state(pm, params, cfg)
    step = make_train_step(pm, cfg)
    rng = np.random.default_rng(0)
    tokens = np.tile(rng.integers(0, 64, 128).astype(np.int32), 20)
    first = last = None
    for _ in range(40):
        start = rng.integers(0, len(tokens) - 33, 4)
        batch = {"tokens": torch.from_numpy(np.stack([tokens[s:s + 33] for s in start]))}
        params, state, metrics = step(params, state, batch)
        first = float(metrics["loss"]) if first is None else first
        last = float(metrics["loss"])
    assert last < first - 0.5, (first, last)
    assert int(state["step"]) == 40 and int(state["opt"]["count"]) == 40
