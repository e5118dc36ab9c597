"""The port's serverless runtime (``repro_torch.runtime``), mirroring
``test_runtime.py``: warm-start accounting, retries, speculation, the
stage lane and the cost model.

Where the reference test races a sleep against a speculation deadline,
the port's test waits on events instead, so it holds under many test
workers at once: a straggler blocks until its backup has finished (or a
generous timeout), and a doomed task does not crash until its duplicate
has been launched.  ``jit`` keeps its meaning for the accounting only
(``runtime/warm.py``): eager PyTorch compiles nothing.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import CostModel as JCostModel
from repro.runtime import FunctionSpec as JFunctionSpec
from repro.runtime.resources import tier_histogram as j_tier_histogram
from repro_torch.engine.columnar import Columnar
from repro_torch.runtime import (
    CostModel,
    ExecutorConfig,
    FaultInjector,
    FunctionSpec,
    ServerlessExecutor,
    TaskFailure,
    WarmFunctionCache,
)
from repro_torch.runtime.resources import MEMORY_TIERS_GB, tier_histogram

torch.set_num_threads(1)  # tiny tensors: extra threads only contend

#: upper bound on any wait in these tests; a healthy run takes milliseconds
PATIENCE_S = 30.0


def test_warm_cache_cold_then_warm():
    cache = WarmFunctionCache()
    spec = FunctionSpec(name="square", fn=lambda x: x * x)
    x = torch.arange(8.0)
    f1 = cache.get_or_compile(spec, x)
    np.testing.assert_allclose(f1(x).numpy(), np.arange(8.0) ** 2)
    f2 = cache.get_or_compile(spec, x)
    assert f1 is f2 is spec.fn  # eager: the function itself, counted
    assert cache.stats.cold_starts == 1 and cache.stats.warm_hits == 1
    assert cache.stats.warm_ratio == 0.5


@pytest.mark.parametrize("a,b", [
    (torch.ones(4), torch.ones(8)),                      # another shape
    (torch.ones(4), torch.ones(4, dtype=torch.int32)),   # another dtype
    (torch.ones(4), (torch.ones(4),)),                   # another structure
])
def test_warm_cache_new_abstract_input_is_cold(a, b):
    cache = WarmFunctionCache()
    spec = FunctionSpec(name="sum", fn=lambda x: x)
    cache.get_or_compile(spec, a)
    cache.get_or_compile(spec, b)
    assert cache.stats.cold_starts == 2 and cache.stats.warm_hits == 0


def test_warm_cache_walks_columnar_relations():
    """A stage's inputs are Columnar relations: equal shapes are warm,
    another capacity or another column set is cold."""
    cache = WarmFunctionCache()
    spec = FunctionSpec(name="stage", fn=lambda rel: rel)

    def rel(n, names=("a", "b")):
        return Columnar.from_numpy({c: np.zeros(n, np.int32) for c in names}, device="cpu")

    for r in (rel(4), rel(4), rel(8), rel(4, ("a",))):
        cache.get_or_compile(spec, r)
    assert (cache.stats.cold_starts, cache.stats.warm_hits) == (3, 1)
    assert cache.has_fingerprint(spec.fingerprint)
    assert not cache.has_fingerprint("nope")
    cache.invalidate()
    assert not cache.has_fingerprint(spec.fingerprint)


def test_non_jit_specs_skip_the_accounting():
    cache = WarmFunctionCache()
    spec = FunctionSpec(name="host", fn=lambda x: x, jit=False)
    assert cache.get_or_compile(spec, torch.ones(2)) is spec.fn
    assert (cache.stats.cold_starts, cache.stats.warm_hits) == (0, 0)


def test_fingerprint_distinguishes_config():
    f = lambda x: x + 1  # noqa: E731
    a = FunctionSpec(name="n", fn=f, static_config={"k": 1})
    b = FunctionSpec(name="n", fn=f, static_config={"k": 2})
    assert a.fingerprint != b.fingerprint


def test_fingerprint_equals_the_jax_packages_for_the_same_function():
    """The spec hashes (name, code, config, jit) alike in both packages:
    the same function object fingerprints the same."""
    f = lambda x: x + 1  # noqa: E731
    for kw in ({}, {"static_config": {"k": 1}}, {"jit": False}):
        assert FunctionSpec(name="n", fn=f, **kw).fingerprint == \
            JFunctionSpec(name="n", fn=f, **kw).fingerprint


def test_executor_runs_and_records():
    with ServerlessExecutor(ExecutorConfig(max_workers=2)) as ex:
        spec = FunctionSpec(name="add", fn=lambda a, b: a + b)
        out = ex.run(spec, torch.ones(4), torch.ones(4))
        np.testing.assert_allclose(out.numpy(), 2.0)
        assert ex.stats()["tasks"] == 1
        assert ex.stats()["cold_starts"] == 1


def test_executor_retries_after_injected_crash():
    inj = FaultInjector(failures={"flaky": 2})
    with ServerlessExecutor(
        ExecutorConfig(max_retries=3, retry_backoff_s=0.001), fault_injector=inj,
    ) as ex:
        spec = FunctionSpec(name="flaky", fn=lambda x: x * 2)
        out = ex.run(spec, torch.ones(2))
        np.testing.assert_allclose(out.numpy(), 2.0)
        assert ex.stats()["retries"] == 2


def test_executor_exhausted_retries_fail():
    inj = FaultInjector(failures={"doomed": 99})
    with ServerlessExecutor(
        ExecutorConfig(max_retries=1, retry_backoff_s=0.001), fault_injector=inj,
    ) as ex:
        spec = FunctionSpec(name="doomed", fn=lambda x: x)
        with pytest.raises(TaskFailure, match="after 2 attempts"):
            ex.run(spec, torch.ones(2))


class GatedInjector(FaultInjector):
    """A FaultInjector whose failing attempts crash only once ``gate`` is
    set (or PATIENCE_S passes): the slow crash that triggers straggler
    speculation, without a race against the clock."""

    def __init__(self, gate, **kw):
        super().__init__(**kw)
        self.gate = gate

    def maybe_fail(self, task_name):
        with self._lock:
            remaining = self.failures.get(task_name, 0)
            count = self.seen.get(task_name, 0)
            self.seen[task_name] = count + 1
        if count < remaining:
            self.gate.wait(PATIENCE_S)
            raise RuntimeError(f"[fault-injection] simulated container crash for {task_name!r}")


class SpeculationGate:
    """The executor's event bus, reduced to what these tests read: an
    event set when it launches a duplicate, and the tasks duplicated."""

    def __init__(self):
        self.event = threading.Event()
        self.fired = []

    def wait(self, timeout):
        return self.event.wait(timeout)

    def publish(self, event):
        if type(event).__name__ == "SpeculationFired":
            self.fired.append(event.task)
            self.event.set()


def test_straggler_speculation_first_result_wins():
    release = threading.Event()
    first = threading.Lock()

    def slow_once(x):
        # the first call blocks until the test ends; its duplicate is fast
        if first.acquire(blocking=False):
            release.wait(PATIENCE_S)
        return x + 1

    # every task starts at once (no queueing); the blocked one outlasts
    # any deadline, so it is duplicated whatever the machine's load
    cfg = ExecutorConfig(max_workers=8, speculation_factor=50.0, speculation_min_samples=3)
    try:
        with ServerlessExecutor(cfg) as ex:
            fast = lambda x: x + 1  # noqa: E731
            specs = [
                (FunctionSpec(name=f"t{i}", fn=slow_once if i == 0 else fast, jit=False),
                 (torch.ones(2),))
                for i in range(6)
            ]
            results = ex.map_with_speculation(specs)
            for r in results:
                np.testing.assert_allclose(r.numpy(), 2.0)
            assert ex.stats()["speculated"] >= 1
            release.set()
    finally:
        release.set()


def test_speculation_duplicate_and_original_both_fail():
    """When the duplicate AND the original both exhaust retries, exactly
    one TaskFailure surfaces and the attempt ledger counts attempts
    across both containers."""
    gate = SpeculationGate()
    inj = GatedInjector(gate, failures={"doomed": 99})
    # the doomed task cannot crash before its duplicate launches, so the
    # deadline can be generous (50 x the median sibling)
    cfg = ExecutorConfig(
        max_workers=8, max_retries=1, retry_backoff_s=0.001,
        speculation_factor=50.0, speculation_min_samples=2,
    )
    ok = FunctionSpec(name="ok", fn=lambda x: x + 1, jit=False)
    with ServerlessExecutor(cfg, fault_injector=inj, bus=gate) as ex:
        specs = [(FunctionSpec(name="doomed", fn=lambda x: x, jit=False), (torch.ones(2),))]
        specs += [(ok, (torch.ones(2),)) for _ in range(4)]
        with pytest.raises(TaskFailure, match="failed on all 2 container"):
            ex.map_with_speculation(specs)
        doomed = [r for r in ex.records if r.name == "doomed"]
        assert len(doomed) == 2
        assert gate.fired.count("doomed") == 1
        assert sum(r.attempts for r in doomed) == 4
        assert inj.seen["doomed"] == 4


def test_speculation_duplicate_succeeds_after_original_fails():
    gate = SpeculationGate()
    inj = GatedInjector(gate, failures={"flaky": 1})
    cfg = ExecutorConfig(
        max_workers=8, max_retries=0, retry_backoff_s=0.001,
        speculation_factor=50.0, speculation_min_samples=2,
    )
    ok = FunctionSpec(name="ok", fn=lambda x: x + 1, jit=False)
    with ServerlessExecutor(cfg, fault_injector=inj, bus=gate) as ex:
        specs = [(FunctionSpec(name="flaky", fn=lambda x: x + 1, jit=False), (torch.ones(2),))]
        specs += [(ok, (torch.ones(2),)) for _ in range(4)]
        for r in ex.map_with_speculation(specs):
            np.testing.assert_allclose(r.numpy(), 2.0)
        assert inj.seen["flaky"] == 2
        assert gate.fired.count("flaky") == 1


class _CallState:
    """Captured by task closures: a class has a stable repr, so mutating
    it leaves the FunctionSpec fingerprint (and its latency history) be."""

    calls = 0
    release = threading.Event()


def _straggling_task(stall_on):
    _CallState.calls = 0
    _CallState.release = threading.Event()

    def task(x):
        _CallState.calls += 1
        if _CallState.calls == stall_on:
            _CallState.release.wait(PATIENCE_S)
        return x + 1

    return task


def test_single_task_speculation_from_latency_history():
    cfg = ExecutorConfig(max_workers=2, speculation_factor=3.0, speculation_min_samples=3)
    spec = FunctionSpec(name="stage", fn=_straggling_task(stall_on=4), jit=False)
    try:
        with ServerlessExecutor(cfg) as ex:
            for _ in range(3):
                ex.run(spec, torch.ones(2))
            assert ex.stats()["speculated"] == 0
            t0 = time.perf_counter()
            out = ex.run(spec, torch.ones(2))  # the 4th call stalls; its backup wins
            elapsed = time.perf_counter() - t0
            np.testing.assert_allclose(out.numpy(), 2.0)
            assert ex.stats()["speculated"] == 1
            assert elapsed < PATIENCE_S / 2
            _CallState.release.set()
    finally:
        _CallState.release.set()


def test_single_task_without_history_never_speculates():
    cfg = ExecutorConfig(max_workers=2, speculation_factor=1.01, speculation_min_samples=3)
    spec = FunctionSpec(name="fresh", fn=lambda x: x + 1, jit=False)
    with ServerlessExecutor(cfg) as ex:
        ex.run(spec, torch.ones(2))
        ex.run(spec, torch.ones(2))
        assert ex.stats()["speculated"] == 0


def test_single_task_speculation_all_racers_fail():
    gate = SpeculationGate()
    inj = GatedInjector(gate)
    cfg = ExecutorConfig(
        max_workers=2, max_retries=1, retry_backoff_s=0.001,
        speculation_factor=1.5, speculation_min_samples=2,
    )
    spec = FunctionSpec(name="flaky", fn=lambda x: x + 1, jit=False)
    with ServerlessExecutor(cfg, fault_injector=inj, bus=gate) as ex:
        for _ in range(2):
            ex.run(spec, torch.ones(2))
        inj.failures["flaky"] = 99
        with pytest.raises(TaskFailure):
            ex.run(spec, torch.ones(2))
        assert ex.stats()["speculated"] == 1
        failed = [r for r in ex.records if r.name == "flaky" and r.duration_s == 0.0]
        assert sum(r.attempts for r in failed) == 4


def test_submit_speculative_future_api_and_concurrent_speculation():
    cfg = ExecutorConfig(max_workers=4, speculation_factor=3.0, speculation_min_samples=3)
    spec = FunctionSpec(name="stage", fn=_straggling_task(stall_on=4), jit=False)
    try:
        with ServerlessExecutor(cfg) as ex:
            for _ in range(3):
                ex.submit_speculative(spec, torch.ones(2)).result()
            futs = [ex.submit_speculative(spec, torch.ones(2)) for _ in range(3)]
            for f in futs:
                np.testing.assert_allclose(f.result(timeout=PATIENCE_S).numpy(), 2.0)
            assert ex.stats()["speculated"] >= 1
            _CallState.release.set()
    finally:
        _CallState.release.set()


def test_submit_stage_lane_does_not_starve_containers():
    cfg = ExecutorConfig(max_workers=2, max_concurrent_stages=8)
    spec = FunctionSpec(name="leaf", fn=lambda x: x * 2, jit=False)
    with ServerlessExecutor(cfg) as ex:

        def driver(i):
            return int(ex.run(spec, torch.full((4,), i)).sum())

        futs = [ex.submit_stage(driver, i) for i in range(8)]
        assert [f.result(timeout=PATIENCE_S) for f in futs] == [i * 8 for i in range(8)]


def test_cost_model_tiers_equal_the_jax_packages():
    cm, jcm = CostModel(), JCostModel()
    small = cm.request_for_scan(10 << 20)
    big = cm.request_for_scan(20 << 30)
    assert small.memory_gb == 1
    assert big.memory_gb > small.memory_gb
    assert tier_histogram([small, small, big])[small.memory_gb] == 2
    for nbytes in (0, 1, 10 << 20, 1 << 30, 20 << 30, 1 << 40):
        a, b = cm.request_for_scan(nbytes), jcm.request_for_scan(nbytes)
        assert (a.memory_gb, a.devices, a.estimated_bytes) == (b.memory_gb, b.devices, b.estimated_bytes)
        assert a.fits_tier() and a.memory_gb in MEMORY_TIERS_GB
    assert tier_histogram([small, big]) == j_tier_histogram([jcm.request_for_scan(10 << 20),
                                                             jcm.request_for_scan(20 << 30)])


def test_cost_model_param_jobs_scale_with_devices():
    cm = CostModel()
    one = cm.request_for_params(4 << 30, 1 << 30, devices=1)
    many = cm.request_for_params(4 << 30, 1 << 30, devices=16)
    assert many.memory_gb < one.memory_gb
    assert many.devices == 16
