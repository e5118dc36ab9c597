"""RoPE on the port's attention path, ``attention._rope``: with no autograd
recording it rotates q and k bit for bit as ``apply_rope`` does, into the
contiguous (B, H, S, D) tensors the flash wrapper reads as views, in fewer
device operations; under autograd it is ``apply_rope``'s rotation, with the
same gradients.  The cases marked ``cuda`` run the equalities on the card
and skip without one: ``PYTHONPATH=src python -m pytest --noconftest -m
cuda tests/test_torch_rope.py``."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import attention
from repro_torch.models.attention import AttentionConfig
from repro_torch.models.common import apply_rope
from repro_torch.models.lm import LM, LMConfig, ModelFamily

torch.set_num_threads(1)  # small tensors: extra threads only contend

#: (n_heads, n_kv_heads, d_head, dtype, rope_theta): Yi-6B, h2o-danube-3-4b,
#: a float16 MHA at 96, an MQA at 256 and a small MHA in float32
SHAPES = {
    "yi_32_4x128_bf16": (32, 4, 128, torch.bfloat16, 5e6),
    "danube_32_8x120_bf16": (32, 8, 120, torch.bfloat16, 1e5),
    "mha_32_32x96_f16": (32, 32, 96, torch.float16, 1e4),
    "mqa_16_1x256_f32": (16, 1, 256, torch.float32, 1e4),
    "mha_4_4x64_f32": (4, 4, 64, torch.float32, 1e4),
}
#: shared positions (S,) as LM.forward and prefill pass them, and one
#: position a sequence (B, 1) as decode_step passes them
POSITIONS = ("shared", "per_sequence")
FAST, AUTOGRAD = "three_pass", "autograd"


def case(shape: str, where: str, *, batch: int = 2, seq: int = 8, device="cpu", seed=0):
    """cfg, q and k as ``_project`` leaves them ((B, S, H, D) views of one
    (B, S, H·D) product each), and the positions."""
    hq, hk, d, dtype, theta = SHAPES[shape]
    cfg = AttentionConfig(d_model=hq * d, n_heads=hq, n_kv_heads=hk, d_head=d,
                          rope_theta=theta, compute_dtype=dtype)
    g = torch.Generator(device=device).manual_seed(seed)
    s = seq if where == "shared" else 1
    q = (3 * torch.randn((batch, s, hq * d), generator=g, device=device)).to(dtype)
    k = (3 * torch.randn((batch, s, hk * d), generator=g, device=device)).to(dtype)
    if where == "shared":
        pos = torch.arange(seq, device=device) + 4000  # large angles as well as small
    else:
        pos = torch.randint(0, 4096, (batch, 1), generator=g, device=device)
    return cfg, q.view(batch, s, hq, d), k.view(batch, s, hk, d), pos


def assert_as_apply_rope(cfg, q, k, pos):
    with torch.no_grad():
        got = attention._rope(cfg, q, k, pos)
    for x, y in zip((q, k), got):
        want = apply_rope(x.transpose(1, 2), pos, theta=cfg.rope_theta)
        assert y.dtype == want.dtype and y.shape == want.shape
        assert torch.equal(y, want)
    return got


@pytest.mark.parametrize("where", POSITIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_rotation_equals_apply_rope_bit_for_bit(shape, where):
    assert_as_apply_rope(*case(shape, where))


@pytest.mark.parametrize("where", POSITIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_output_is_contiguous_in_bhsd(shape, where):
    cfg, q, k, pos = case(shape, where, seq=5)
    with torch.no_grad():
        got = attention._rope(cfg, q, k, pos)
    for x, y in zip((q, k), got):
        b, s, h, d = x.shape
        assert y.shape == (b, h, s, d) and y.is_contiguous()
        # the flash wrapper's reshape to (B·H, S, D) is then a view
        assert y.reshape(b * h, s, d).data_ptr() == y.data_ptr()


def grads(rope, q, k, weights):
    q = q.detach().clone().requires_grad_()
    k = k.detach().clone().requires_grad_()
    out = rope(q, k)
    sum((y.float() * w).sum() for y, w in zip(out, weights)).backward()
    return out, q.grad, k.grad


@pytest.mark.parametrize("shape", ["yi_32_4x128_bf16", "mha_4_4x64_f32"])
def test_under_autograd_the_rotation_and_its_gradients_are_todays(shape):
    cfg, q, k, pos = case(shape, "shared")
    g = torch.Generator().manual_seed(1)
    weights = [torch.randn(x.transpose(1, 2).shape, generator=g) for x in (q, k)]
    before = dict(attention.ROPE_CALLS)
    got = grads(lambda a, b: attention._rope(cfg, a, b, pos), q, k, weights)
    assert attention.ROPE_CALLS[AUTOGRAD] == before[AUTOGRAD] + 1
    assert attention.ROPE_CALLS[FAST] == before[FAST]
    want = grads(lambda a, b: tuple(apply_rope(x.transpose(1, 2), pos, theta=cfg.rope_theta)
                                    for x in (a, b)), q, k, weights)
    for y, w in zip(got[0], want[0]):
        assert y.requires_grad and torch.equal(y, w)
    for gy, gw in zip(got[1:], want[1:]):
        assert gy is not None and torch.equal(gy, gw)


LAYERS = 3


def tiny_lm(**kw) -> LM:
    cfg = LMConfig(name="tiny", family=ModelFamily.DENSE, n_layers=LAYERS, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, segments=((("attn",), LAYERS),),
                   **kw)
    return LM(cfg).init(torch.Generator().manual_seed(0))


def tokens() -> torch.Tensor:
    return torch.randint(0, 97, (2, 16), generator=torch.Generator().manual_seed(1))


def calls_in(fn):
    before = dict(attention.ROPE_CALLS)
    fn()
    return {path: attention.ROPE_CALLS[path] - before[path] for path in before}


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "kernel_route"])
def test_lm_forward_rotates_once_a_layer_on_the_fast_path(flash):
    model = tiny_lm(use_flash_kernel=flash)
    assert calls_in(lambda: model(tokens())) == {FAST: LAYERS, AUTOGRAD: 0}


def test_decode_rotates_once_a_layer_on_the_fast_path():
    model = tiny_lm()
    state = model.init_decode_state(2, max_len=32)
    lengths = torch.tensor([3, 7])
    assert calls_in(lambda: model.decode_step(state, tokens()[:, :1], lengths)) == {
        FAST: LAYERS, AUTOGRAD: 0}


def test_training_rotates_on_the_autograd_path():
    model = tiny_lm(compute_dtype=torch.float32)
    params = model.init_params(torch.Generator().manual_seed(0))
    leaves = []

    def grad_leaves(tree):
        for key, v in tree.items():
            if isinstance(v, dict):
                grad_leaves(v)
            elif v.is_floating_point():
                tree[key] = v.requires_grad_()
                leaves.append(tree[key])

    grad_leaves(params)

    def step():
        total, _ = model.loss(params, {"tokens": tokens()})
        total.backward()

    assert calls_in(step) == {FAST: 0, AUTOGRAD: LAYERS}
    assert all(leaf.grad is not None for leaf in leaves)


class DeviceOps(TorchDispatchMode):
    """The aten ops dispatched that make device work: no view, and no
    allocation alone (``empty``)."""

    ALLOCATIONS = ("empty", "empty_like", "empty_strided")

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket.__name__ not in self.ALLOCATIONS:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("where", POSITIONS)
def test_rope_makes_at_most_20_device_operations_for_q_and_k(where):
    cfg, q, k, pos = case("yi_32_4x128_bf16", where)
    with torch.no_grad(), DeviceOps() as new:
        attention._rope(cfg, q, k, pos)
    with torch.no_grad(), DeviceOps() as old:
        for x in (q, k):
            apply_rope(x.transpose(1, 2), pos, theta=cfg.rope_theta)
    assert len(old.ops) >= 36, old.ops  # the count sees the passes it replaced
    assert len(new.ops) <= 20, new.ops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("where", POSITIONS)
@pytest.mark.parametrize("shape", SHAPES)
def test_on_the_card_the_rotation_equals_apply_rope_bit_for_bit(card, shape, where):
    # the benchmark's batch of 2 x 4096 tokens, and a decode step of 16 slots
    batch, seq = (2, 4096) if where == "shared" else (16, 1)
    got = assert_as_apply_rope(*case(shape, where, batch=batch, seq=seq, device=card, seed=7))
    assert all(y.is_contiguous() for y in got)
