"""The device operations of a traced window put down to the program's spans
(``perfbench/spans.py``), on windows made by hand, and the per-layer shares
that read them."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import spans, spec, tracing

SHARES = {"attention_share": "lm.attention", "rope_share": "lm.attention.rope",
          "norm_share": "lm.norm", "mlp_share": "lm.mlp"}


def ev(name, start_us, end_us, device="CPU", annotation=False):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start_us, end=end_us),
                           is_user_annotation=annotation)


def launch(at, name="cudaLaunchKernel"):
    return ev(name, at, at + 0.5)


#: a traced window of 100 us and one batch: a kernel launched before it,
#: then one layer's norm, RoPE, the flash wrapper's copy and kernel, an MLP
#: GEMM, and the scores' copy to the host; each launch's device operation
#: runs after it, in launch order
HOST = [
    ev("ProfilerStep#1", 0, 100),
    ev("score.forward", 10, 60),
    ev("lm.norm", 11, 14), ev("aten::mul", 11.5, 13), launch(12),
    ev("lm.attention", 15, 40),
    ev("lm.attention.rope", 16, 20), ev("aten::cat", 17, 19), launch(18),
    ev("lm.attention.kernel", 21, 30), ev("aten::contiguous", 21.5, 23.5),
    ev("aten::copy_", 21.8, 23), launch(22), launch(25, "cudaLaunchKernelExC"),
    ev("lm.mlp", 41, 55), ev("aten::mm", 42, 45), launch(43),
    ev("score.logprob", 60.5, 64), ev("aten::copy_", 61, 63), launch(62, "cudaMemcpyAsync"),
]
DEVICE = [
    ev("elementwise_kernel early", 1, 9, "CUDA"),
    ev("elementwise_kernel MulFunctor<float>", 13, 15, "CUDA"),
    ev("CatArrayBatchedCopy", 19, 21, "CUDA"),
    ev("direct_copy_kernel", 23, 24, "CUDA"),
    ev("void flash_wgmma<__nv_bfloat16, 128>(CUtensorMap_st)", 27, 35, "CUDA"),
    ev("nvjet_tst_gemm", 44, 50, "CUDA"),
    ev("Memcpy DtoH (Device -> Pinned)", 63, 64, "CUDA"),
    # the profiler's device-side copy of a span: no work, kept out of the window
    ev("lm.attention", 19, 35, "CUDA", annotation=True),
]


def window(host=HOST, device=DEVICE):
    return tracing.from_profile(host + device, 1, tracing.Work(batch_flops=1.0,
                                                               flash_launch_bound_s=1e-6))


def without(events, name):
    return [e for e in events if e.name != name]


def test_pairing_from_the_end_leaves_the_early_operation_unmatched():
    found = spans.attribute(window())
    assert [op.name for op in found.unmatched] == ["elementwise_kernel early"]
    got = [(op.name.split("<")[0].split("(")[0], spans.innermost(path))
           for op, path in found.matched]
    assert got == [("elementwise_kernel MulFunctor", "lm.norm"),
                   ("CatArrayBatchedCopy", "lm.attention.rope"),
                   ("direct_copy_kernel", "lm.attention.kernel"),
                   ("void flash_wgmma", "lm.attention.kernel"),
                   ("nvjet_tst_gemm", "lm.mlp"),
                   ("Memcpy DtoH ", "score.logprob")]


def test_an_operation_goes_to_the_innermost_span_with_its_parents_above():
    paths = [path for _, path in spans.attribute(window()).matched]
    assert paths[1] == ("score.forward", "lm.attention", "lm.attention.rope")
    assert paths[4] == ("score.forward", "lm.mlp")
    assert paths[5] == ("score.logprob",)


def test_open_spans_of_nested_and_disjoint_spans():
    s = [tracing.Op("a", 0, 10), tracing.Op("b", 1, 3), tracing.Op("c", 4, 6),
         tracing.Op("d", 12, 14)]
    assert spans.open_spans(s, [0.5, 2, 3.5, 5, 11, 13, 20]) == [
        ("a",), ("a", "b"), ("a",), ("a", "c"), (), ("d",), ()]


def test_a_dropped_kernel_slips_the_pairing_and_the_anchor_check_refuses_it():
    # the GEMM dropped: the flash kernel pairs with the GEMM's launch
    assert spans.attribute(window(device=without(DEVICE, "nvjet_tst_gemm"))) is None


def test_a_launch_missing_from_the_name_set_slips_the_pairing_and_is_refused():
    host = [launch(43, "cudaLaunchSomethingElse") if e.name == "cudaLaunchKernel"
            and e.time_range.start == 43 else e for e in HOST]
    assert spans.attribute(window(host)) is None


def test_a_program_without_the_spans_gives_none():
    host = [e for e in HOST if not e.name.startswith("lm.")]
    assert spans.attribute(window(host)) is None


def test_a_window_without_device_work_gives_none():
    assert spans.attribute(window(device=[])) is None


@pytest.mark.parametrize("metric, want", [
    ("attention_share", 100 * (2 + 1 + 8) / 20), ("rope_share", 100 * 2 / 20),
    ("norm_share", 100 * 2 / 20), ("mlp_share", 100 * 6 / 20)])
def test_each_share_reads_its_span_with_its_children(metric, want):
    read = spec.metric_reader(metric)
    assert read(window()) == pytest.approx(want)
    assert spans.share(window(), SHARES[metric]) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_each_share_is_none_where_the_attribution_is(metric):
    read = spec.metric_reader(metric)
    assert read(window(device=without(DEVICE, "nvjet_tst_gemm"))) is None
    assert read(window([e for e in HOST if not e.name.startswith("lm.")])) is None


def test_a_span_that_launched_nothing_reads_none():
    host = [e for e in HOST if e.name != "lm.attention.rope"]
    assert spans.share(window(host), "lm.attention.rope") is None
    assert spans.share(window(host), "lm.attention") == pytest.approx(55.0)


def test_the_spans_annotation_on_the_device_is_no_operation():
    w = window()
    assert len(w.kernels) == 6 and len(w.transfers) == 1
    assert not any(k.name.startswith("lm.") for k in w.kernels)


def test_the_breakdown_table():
    """``tools/span_breakdown.py``'s table of the attribution."""
    path = Path(__file__).resolve().parents[2] / "tools" / "span_breakdown.py"
    tool_spec = importlib.util.spec_from_file_location("span_breakdown", path)
    tool = importlib.util.module_from_spec(tool_spec)
    tool_spec.loader.exec_module(tool)
    got = tool.table(window())
    assert got["matched_share"] == pytest.approx(100 * 20 / 28)
    assert got["unmatched_ops"] == 1 and got["unspanned_share"] == 0.0
    assert got["flash_s"] == pytest.approx(8e-6)
    rows = {name: row for name, *row in got["spans"]}
    assert rows["lm.attention.kernel"] == [pytest.approx(9e-6), pytest.approx(45.0), 2.0]
    assert rows["lm.mlp"] == [pytest.approx(6e-6), pytest.approx(30.0), 1.0]
    assert sum(row[1] for row in rows.values()) == pytest.approx(100.0)
    assert tool.table(window(device=[])) is None
