"""The benchmark as data: ``BENCHMARK.json`` against its contract, every file
it names found by name, the width guard, and the per-layer readers on a
window made by hand."""
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import program, spec, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"tokens_per_s", "latency_p95_s", "peak_mem_gib", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert spec.read_json(ROOT / c["file"])["name"] == c["name"]
        assert c["reduced"] == spec.read_json(ROOT / c["file"])["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", CELLS)
def test_every_file_of_a_cell_is_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.tokens_per_batch == cell.traffic["tokens_per_batch"] == 8192
    assert cell.per_layer and {"tokens_per_s", "setup_s"} <= {m["name"] for m in cell.end_to_end}
    assert set(spec.metric_readers(cell)) == {m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("workload", CELLS)
def test_each_limit_lies_between_its_readings(workload):
    limits = spec.load_cell(workload).limits
    for name in ("max_gap", "mean_gap"):
        lo, limit, hi = limits[name]["lower"], limits[name]["limit"], limits[name]["upper"]
        assert hi >= 3 * lo and lo < limit < hi
        assert limit - lo > hi - limit or limit > (lo + hi) / 2


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_has_the_widths_of_the_file(workload):
    cell = spec.load_cell(workload)
    cfg = cell.model.port_config(cell.config)
    assert cfg.use_flash_kernel and cfg.rope_theta == cell.config["rope_theta"]


@pytest.mark.parametrize("key, value", [("intermediate_size", 11000), ("num_key_value_heads", 8),
                                        ("num_hidden_layers", 30), ("sliding_window", 2048)])
def test_a_cell_whose_port_config_differs_in_a_width_is_refused(key, value):
    config = dict(spec.load_cell("yi-6b.score-4k").config, **{key: value})
    with pytest.raises(program.ConfigMismatch, match="differs from the cell's file"):
        spec.model_module(config).port_config(config)


def test_scalars_that_move_no_work_are_not_widths():
    """Yi-6B's published rope_theta (5e6) and rms_norm_eps (1e-5) differ from
    the port's registry (1e4, 1e-6): the cell runs the published ones."""
    cell = spec.load_cell("yi-6b.score-4k")
    cfg = cell.model.port_config(cell.config)
    assert (cfg.rope_theta, cfg.norm_eps) == (5_000_000.0, 1e-05)


def test_a_new_metric_is_a_new_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "kernels_per_s.py").write_text(
        "def read(window):\n    return len(window.kernels) / window.window_s\n")
    monkeypatch.setattr(spec, "HERE", tmp_path)
    assert spec.metric_reader("kernels_per_s")(window()) == pytest.approx(4 / 0.010)


def op(name, start_us, end_us, device="CUDA", annotation=False):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start_us, end=end_us),
                           is_user_annotation=annotation)


def window(batches=2):
    """10 ms traced: two steps of 5 ms; four kernels (one flash), a copy, a
    host span, and a device-side copy of the host span that is no work."""
    events = [
        op("ProfilerStep#1", 0, 5000, "CPU"), op("ProfilerStep#2", 5000, 10000, "CPU"),
        op("score.wait", 100, 9900, "CPU"), op("score.forward", 0, 9000, annotation=True),
        op("nvjet_gemm", 0, 3000), op("void (anonymous namespace)::flash_wgmma<__nv_bfloat16, "
                                      "128>(CUtensorMap_st)", 3000, 4000),
        op("nvjet_gemm", 4500, 8000), op("elementwise", 8000, 9000),
        op("Memcpy DtoH (Device -> Pinned)", 9000, 9100), op("nvjet_gemm", -300, 50),
    ]
    work = tracing.Work(batch_flops=1e12, flash_launch_bound_s=0.5e-3)
    return tracing.from_profile(events, batches, work)


def test_a_traced_window_and_its_readers():
    w = window()
    assert w.window_s == pytest.approx(0.010)
    assert len(w.kernels) == 4 and len(w.transfers) == 1  # the annotation is no work
    assert w.busy_s == pytest.approx(0.0086)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in BENCH["per_layer"]}
    got = tracing.read(w, readers)
    assert got["forward_mfu"] == pytest.approx(100 * 2e12 / (0.010 * 989e12))
    assert got["launches_per_batch"] == 2
    assert got["flash_roofline"] == pytest.approx(50.0)
    assert got["flash_share"] == pytest.approx(100 * 1.0 / 8.5)
    assert got["device_idle"] == pytest.approx(14.0)
    assert tracing.device_table(w)[0] == ["nvjet_gemm", pytest.approx(0.0065)]
    assert ["flash_wgmma<bf16, 128>", pytest.approx(0.001)] in tracing.device_table(w)
    idle = dict(tracing.idle_table(w))
    assert idle["score.wait"] == pytest.approx(0.0005 + 0.0009)


def test_readers_find_nothing_in_a_window_without_device_work():
    w = tracing.from_profile([op("ProfilerStep#1", 0, 5000, "CPU")], 1,
                             tracing.Work(batch_flops=1.0, flash_launch_bound_s=1.0))
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in BENCH["per_layer"]}
    assert tracing.read(w, readers) == {}


def test_run_refuses_without_a_card_and_prints_no_result():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_run_refuses_outside_a_checkout_of_the_port(tmp_path):
    """A directory with BENCHMARK.json and perfbench/ alone holds no port."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no port" in proc.stderr


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", str(2**31 + 3), "--seconds", "3", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
