"""The model path's spans (``repro_torch.telemetry.spans``) on the CPU: what
``LM.forward`` records under a profiler, that no span is entered without
one or on the decode path, that the spans change no number, and that
chip_smoke's profiles count no span as device work."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from repro_torch.models import attention
from repro_torch.models.lm import LM, LMConfig, ModelFamily
from repro_torch.telemetry import spans

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

LAYERS = 3
PARTS = ("lm.attention.qkv", "lm.attention.rope", "lm.attention.kernel", "lm.attention.out")
NAMES = ("lm.embed", "lm.norm", "lm.attention", *PARTS, "lm.mlp", "lm.head")


def tiny_lm(**kw) -> LM:
    cfg = LMConfig(name="tiny", family=ModelFamily.DENSE, n_layers=LAYERS, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab=97, segments=((("attn",), LAYERS),),
                   **kw)
    return LM(cfg).init(torch.Generator().manual_seed(0))


def tokens() -> torch.Tensor:
    return torch.randint(0, 97, (2, 16), generator=torch.Generator().manual_seed(1))


def recorded(fn):
    """The ``lm.*`` spans ``fn()`` records under a CPU profiler, in order
    of start: [(name, start_us, end_us)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("lm.")), key=lambda e: (e[1], -e[2]))


def counts(events):
    out = {}
    for name, _, _ in events:
        out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.parametrize("flash", [False, True], ids=["reference", "kernel_route"])
def test_forward_records_every_span_once_a_layer(flash):
    model = tiny_lm(use_flash_kernel=flash)
    events = recorded(lambda: model(tokens()))
    assert counts(events) == {"lm.embed": 1, "lm.head": 1, "lm.norm": 2 * LAYERS + 1,
                              "lm.attention": LAYERS, "lm.mlp": LAYERS,
                              **{p: LAYERS for p in PARTS}}
    assert set(counts(events)) == set(NAMES)


def test_the_attention_parts_lie_inside_their_layer_and_in_order():
    events = recorded(lambda: tiny_lm()(tokens()))
    layers = [e for e in events if e[0] == "lm.attention"]
    parts = [e for e in events if e[0] in PARTS]
    assert len(parts) == len(PARTS) * len(layers)
    for i, (_, start, end) in enumerate(layers):
        inside = parts[i * len(PARTS):(i + 1) * len(PARTS)]
        assert [e[0] for e in inside] == list(PARTS)
        assert all(start <= s and e <= end for _, s, e in inside)
    # nothing of the MLP, the norms or the head runs inside an attention span
    others = [e for e in events if e[0] in ("lm.mlp", "lm.norm", "lm.head", "lm.embed")]
    assert not any(a_s <= s < a_e for _, s, _ in others for _, a_s, a_e in layers)


def test_the_training_stack_records_the_blocks_spans():
    model = tiny_lm(compute_dtype=torch.float32)
    params = model.init_params(torch.Generator().manual_seed(0))
    events = recorded(lambda: model.loss(params, {"tokens": tokens()}))
    got = counts(events)
    assert got["lm.attention"] == got["lm.mlp"] == LAYERS
    assert got["lm.norm"] == 2 * LAYERS


def test_without_a_profiler_no_span_is_entered(monkeypatch):
    entered = []
    monkeypatch.setattr(spans, "record_function",
                        lambda name: entered.append(name) or torch.profiler.record_function(name))
    assert spans.span("lm.mlp") is spans.OFF
    tiny_lm()(tokens())
    assert entered == []
    # a profiler that records enters each one, through the same name
    with profile(activities=[ProfilerActivity.CPU]):
        tiny_lm()(tokens())
    assert counts([(n, 0, 0) for n in entered])["lm.attention"] == LAYERS


def test_spans_wait_for_the_profilers_active_steps():
    """In a schedule's warm-up step the profiler records nothing, and the
    spans stay off."""
    seen = []
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            seen.append(spans.span("lm.head") is spans.OFF)
            prof.step()
    assert seen == [True, False]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_logits_are_the_same_with_and_without_the_profiler(dtype):
    model = tiny_lm(compute_dtype=dtype, use_flash_kernel=True)
    ids = tokens()
    plain = model(ids)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = model(ids)
    assert plain.dtype == traced.dtype == dtype
    assert torch.equal(plain, traced)


def test_decode_and_prefill_enter_no_span():
    model = tiny_lm(compute_dtype=torch.float32)
    state = model.init_decode_state(2, max_len=32)
    lengths = torch.tensor([0, 5], dtype=torch.int32)
    assert recorded(lambda: model.decode_step(state, tokens()[:, :1], lengths)) == []
    acfg = model.cfg.attention_config()
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(2))
    cache = attention.init_cache(acfg, 2, 32, dtype=torch.float32)
    assert recorded(lambda: attention.prefill(model.blocks[0]["attn"], acfg, x,
                                              torch.arange(16), cache)) == []


def test_attend_train_is_prefills_attention():
    """Split into its spans, the layer computes what prefill computes."""
    model = tiny_lm(compute_dtype=torch.float32)
    acfg = model.cfg.attention_config()
    p = model.blocks[0]["attn"]
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(3))
    cache = attention.init_cache(acfg, 2, 32, dtype=torch.float32)
    want, _ = attention.prefill(p, acfg, x, torch.arange(16), cache)
    assert torch.equal(attention.attend_train(p, acfg, x, torch.arange(16)), want)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smokes_profiles_count_no_span_as_device_work():
    """A span is drawn on the device's timeline as a user annotation, over
    the kernels it launched; counted, it would add launches and busy time."""
    def row(key, device, annotation=False):
        return SimpleNamespace(key=key, device_type=SimpleNamespace(name=device),
                               is_user_annotation=annotation)

    rows = [row("flash_wgmma<bf16, 128>", "CUDA"), row("lm.attention", "CUDA", True),
            row("Memset (Device)", "CUDA"), row("aten::mm", "CPU"), row("lm.mlp", "CPU")]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert [e.key for e in _chip_smoke().device_rows(prof)] == [
        "flash_wgmma<bf16, 128>", "Memset (Device)"]
