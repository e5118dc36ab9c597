"""The serverless executor: isolation, retries, stragglers, fault injection.

Each submitted task is conceptually one ephemeral container.  On this
single-host build, containers are worker threads; the *semantics* carried
to a real deployment are what matter and are what the tests pin down:

* **at-least-once with idempotence** — tasks are pure functions of their
  inputs, so retries and speculative duplicates are safe by construction
  (this is why the paper insists on functional pipelines);
* **bounded retries** on worker failure, with exponential backoff;
* **straggler speculation** — if a task exceeds ``speculation_factor`` ×
  the median duration of its completed siblings, a duplicate launches and
  the first finisher wins (standard backup-request trick, scaled down).
  Single tasks (the ``submit()``/``run()`` path — one fused stage, one
  container) have no siblings, so their baseline is the **per-fingerprint
  latency history** of prior runs of the same function: a pipeline stage
  that usually takes 50 ms but is stuck at 500 ms gets a backup request
  too, not just fan-out batches;
* **failure injection** — tests wrap task functions with a FaultInjector
  that kills the first N attempts to prove the retry path.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime.function import FunctionSpec
from repro_torch.runtime.warm import WarmFunctionCache
from repro_torch.utils.logging import get_logger

log = get_logger("runtime.executor")


class TaskFailure(RuntimeError):
    """A task exhausted its retries."""


@dataclass
class ExecutorConfig:
    max_workers: int = 4
    max_retries: int = 3
    retry_backoff_s: float = 0.01
    #: speculate a duplicate when runtime > factor × median sibling time
    speculation_factor: float = 3.0
    #: minimum completed siblings before speculation kicks in
    speculation_min_samples: int = 3
    #: hard per-attempt timeout (None = no timeout); a timed-out attempt
    #: counts as a failure and is retried
    attempt_timeout_s: Optional[float] = None
    #: completed durations remembered per function fingerprint — the
    #: baseline single-task speculation falls back to when a task has no
    #: completed siblings to take a median over
    latency_history_size: int = 64
    #: upper bound on pipeline stages the wave scheduler keeps in flight at
    #: once (the CLI's ``--parallelism``).  Stage *functions* still execute
    #: on the container pool, so effective compute parallelism is
    #: ``min(max_concurrent_stages, max_workers)``.  Under
    #: ``schedule="critical_path"`` this flat count is superseded by
    #: memory-capped admission (``memory_budget_gb``) unless the caller
    #: pins an explicit per-run ``parallelism``.
    max_concurrent_stages: int = 4
    #: estimated-peak-memory budget for co-scheduled stages (Scheduler
    #: v2's adaptive admission): the wave scheduler admits a ready stage
    #: only while the sum of in-flight ``ResourceRequest.memory_gb``
    #: tiers plus the candidate's stays within this budget — two 80 GB
    #: stages never run together on a 128 GB budget.  ``None`` disables
    #: the memory cap (count-capped admission only).
    memory_budget_gb: Optional[float] = 32.0


@dataclass
class TaskRecord:
    name: str
    attempts: int = 0
    speculated: bool = False
    duration_s: float = 0.0
    worker: str = ""


@dataclass
class FaultInjector:
    """Deterministically fail the first ``failures`` attempts of a task.

    ``seen`` counts attempts by task *name*, so a speculated duplicate and
    its original share one attempt ledger — exactly the cross-container
    accounting the retry tests pin down.  ``crash_delay_s`` simulates a
    container that hangs before crashing (slow failure), which is what
    triggers straggler speculation on a doomed task.
    """

    failures: Dict[str, int] = field(default_factory=dict)
    seen: Dict[str, int] = field(default_factory=dict)
    crash_delay_s: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def maybe_fail(self, task_name: str) -> None:
        with self._lock:
            remaining = self.failures.get(task_name, 0)
            count = self.seen.get(task_name, 0)
            self.seen[task_name] = count + 1
        if count < remaining:
            delay = self.crash_delay_s.get(task_name, 0.0)
            if delay:
                time.sleep(delay)
            raise RuntimeError(
                f"[fault-injection] simulated container crash for {task_name!r} "
                f"(attempt {count + 1}/{remaining})"
            )


class ServerlessExecutor:
    """Thread-pool "container fleet" with the semantics described above."""

    def __init__(
        self,
        config: Optional[ExecutorConfig] = None,
        *,
        warm_cache: Optional[WarmFunctionCache] = None,
        fault_injector: Optional[FaultInjector] = None,
        bus: Any = None,
        metrics: Any = None,
    ) -> None:
        self.config = config or ExecutorConfig()
        self.warm_cache = warm_cache or WarmFunctionCache()
        self.fault_injector = fault_injector
        #: telemetry (both optional, duck-typed to avoid an import cycle):
        #: ``bus`` is a repro_torch.telemetry.bus.EventBus for speculation
        #: events, ``metrics`` a registry with ``counter(name)`` and
        #: ``histogram(name)`` absorbing task durations/retries next to the
        #: speculation baselines
        self.bus = bus
        self.metrics = metrics
        self.records: List[TaskRecord] = []
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.max_workers, thread_name_prefix="container"
        )
        #: drivers of whole pipeline stages (scan → execute → write) run in
        #: their own lane: they *block* on container-pool futures, so giving
        #: them container workers could deadlock a full fleet.  Sized above
        #: ``max_concurrent_stages`` because the lane only provides threads —
        #: the wave scheduler enforces the actual in-flight bound.
        self._stage_pool: Optional[ThreadPoolExecutor] = None
        self._durations: List[float] = []
        self._speculations = 0  # duplicates launched, lifetime of the pool
        #: function fingerprint -> recent completed durations (the prior-run
        #: baseline for single-task speculation AND the scheduler's cost
        #: model medians)
        self._latency_history: Dict[str, List[float]] = {}
        #: function fingerprint -> latest predicted-vs-actual stage cost
        #: (Scheduler v2); persisted next to the durations in the
        #: ``latencyhist`` namespace so the model's accuracy is auditable
        #: across processes
        self._forecasts: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- lifecycle
    def shutdown(self) -> None:
        with self._lock:
            stage_pool, self._stage_pool = self._stage_pool, None
        if stage_pool is not None:
            stage_pool.shutdown(wait=True)
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ServerlessExecutor":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()

    # ------------------------------------------------------------- running
    def _attempt(self, spec: FunctionSpec, args: Tuple[Any, ...]) -> Any:
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail(spec.name)
        fn = self.warm_cache.get_or_compile(spec, *args)
        return fn(*args)

    def _run_with_retries(
        self, spec: FunctionSpec, args: Tuple[Any, ...], speculated: bool = False
    ) -> Any:
        record = TaskRecord(
            name=spec.name,
            speculated=speculated,
            worker=threading.current_thread().name,
        )
        last_err: Optional[BaseException] = None
        for attempt in range(self.config.max_retries + 1):
            record.attempts = attempt + 1
            t0 = time.perf_counter()
            try:
                result = self._attempt(spec, args)
                record.duration_s = time.perf_counter() - t0
                with self._lock:
                    self.records.append(record)
                    self._durations.append(record.duration_s)
                    history = self._latency_history.setdefault(
                        spec.fingerprint, []
                    )
                    history.append(record.duration_s)
                    del history[: -self.config.latency_history_size]
                if self.metrics is not None:
                    self.metrics.counter("executor.tasks").inc()
                    self.metrics.counter("executor.retries").inc(attempt)
                    self.metrics.histogram(
                        "executor.task_duration_s"
                    ).observe(record.duration_s)
                return result
            except Exception as e:  # container crash → retry
                last_err = e
                log.warning(
                    "task %s attempt %d failed: %s", spec.name, attempt + 1, e
                )
                time.sleep(self.config.retry_backoff_s * (2**attempt))
        with self._lock:
            self.records.append(record)
        if self.metrics is not None:
            self.metrics.counter("executor.task_failures").inc()
            self.metrics.counter("executor.retries").inc(
                self.config.max_retries
            )
        raise TaskFailure(
            f"task {spec.name!r} failed after {self.config.max_retries + 1} attempts"
        ) from last_err

    def submit(self, spec: FunctionSpec, *args: Any) -> "Future[Any]":
        return self._pool.submit(self._run_with_retries, spec, args)

    def submit_stage(self, fn: Callable[..., Any], *args: Any) -> "Future[Any]":
        """Submit one stage *driver* (scan → execute → write) to the stage
        lane.  Drivers block on container-pool futures (``run`` /
        ``submit_speculative``) and on parallel shard reads, so they get
        their own threads — a fleet of busy containers can never deadlock
        the wave scheduler."""
        with self._lock:
            if self._stage_pool is None:
                self._stage_pool = ThreadPoolExecutor(
                    max_workers=max(self.config.max_concurrent_stages, 32),
                    thread_name_prefix="stage",
                )
            pool = self._stage_pool
        return pool.submit(fn, *args)

    @property
    def io_pool(self) -> ThreadPoolExecutor:
        """Leaf-task lane for parallel shard reads (``execute_scan``'s
        ``pool``).  Shares the container pool — shard reads never block on
        other futures, so they are always safe to queue there."""
        return self._pool

    # ------------------------------------------------- latency baselines
    def seed_latency_history(
        self, history: Dict[str, Sequence[float]]
    ) -> None:
        """Install persisted per-fingerprint latency baselines.

        Called by the SDK Client when it opens a lake, with the histories
        a previous process recorded — a fresh process speculates against
        inherited medians instead of re-learning them.  Locally-observed
        durations win: fingerprints this executor has already timed are
        left untouched.
        """
        size = self.config.latency_history_size
        with self._lock:
            for fp, durations in history.items():
                if fp not in self._latency_history:
                    self._latency_history[fp] = [
                        float(d) for d in list(durations)[-size:]
                    ]

    def latency_history(self) -> Dict[str, List[float]]:
        """Snapshot of the per-fingerprint completed-duration histories
        (what the SDK Client persists into the lake after each run)."""
        with self._lock:
            return {fp: list(ds) for fp, ds in self._latency_history.items()}

    def latency_medians(self) -> Dict[str, float]:
        """Median completed duration per function fingerprint — the
        scheduler cost model's primary source.  One completed run is
        enough to beat the bytes heuristic (unlike speculation, which
        needs ``speculation_min_samples`` before arming a backup)."""
        with self._lock:
            return {
                fp: sorted(ds)[len(ds) // 2]
                for fp, ds in self._latency_history.items()
                if ds
            }

    def record_forecast(
        self, fingerprint: str, predicted_s: float, actual_s: float
    ) -> None:
        """Record one stage's predicted-vs-actual cost (Scheduler v2).
        The SDK Client persists these next to the latency durations so
        the cost model's calibration survives the process."""
        with self._lock:
            self._forecasts[fingerprint] = {
                "predicted_s": float(predicted_s),
                "actual_s": float(actual_s),
            }

    def forecasts(self) -> Dict[str, Dict[str, float]]:
        """Snapshot of the latest predicted-vs-actual cost per fingerprint."""
        with self._lock:
            return {fp: dict(f) for fp, f in self._forecasts.items()}

    def warm_ready(self, spec: FunctionSpec) -> bool:
        """True when the warm cache has already seen a cold start for
        this spec's fingerprint (any shape) — the scheduler's
        warm/cold dispatch hint on ``StageScheduled``."""
        return self.warm_cache.has_fingerprint(spec.fingerprint)

    def _historical_baseline(self, spec: FunctionSpec) -> Optional[float]:
        """Median completed duration of prior runs of this function, or
        None below ``speculation_min_samples`` (no evidence, no backup)."""
        with self._lock:
            history = list(self._latency_history.get(spec.fingerprint, ()))
        if len(history) < self.config.speculation_min_samples:
            return None
        return sorted(history)[len(history) // 2]

    def _publish(self, event_cls_name: str, spec: FunctionSpec,
                 tags: Optional[Dict[str, Any]], **fields: Any) -> None:
        """Publish one speculation event if a bus is attached.  The event
        class is resolved lazily by name — the executor predates telemetry
        and must stay importable without it (no import cycle)."""
        if self.bus is None:
            return
        from repro_torch.telemetry import events as ev

        tags = tags or {}
        self.bus.publish(getattr(ev, event_cls_name)(
            run_id=tags.get("run_id"),
            task=spec.name,
            stage_id=tags.get("stage_id"),
            **fields,
        ))

    def submit_speculative(
        self, spec: FunctionSpec, *args: Any,
        tags: Optional[Dict[str, Any]] = None,
    ) -> "Future[Any]":
        """Future-returning ``run()``: primary submitted now, straggler
        backup armed against the per-fingerprint latency history.

        A single task has no completed siblings to take a median over, so
        the straggler baseline is the latency history of prior runs: once
        the primary exceeds ``speculation_factor`` × that median, ONE
        duplicate launches and the first successful finisher wins.  With
        no history the primary just runs to completion.  Because the
        deadline is a timer (not a blocking wait), any number of
        concurrently submitted stages each keep their own speculation —
        this is what lets straggler backup requests compose with the wave
        scheduler's concurrent stage submissions.
        """
        result: "Future[Any]" = Future()
        state_lock = threading.Lock()
        with self._lock:
            # records before this invocation (baseline-building successes
            # included) must not count toward this task's attempt ledger
            start_idx = len(self.records)
        racers: List[Future] = []
        timer: List[Optional[threading.Timer]] = [None]

        def on_racer_done(fut: "Future[Any]") -> None:
            with state_lock:
                if result.done():
                    return
                if fut.exception() is None:
                    if timer[0] is not None:
                        timer[0].cancel()
                    if len(racers) > 1 and fut is racers[1]:
                        # the duplicate beat the straggling primary
                        self._publish("SpeculationWon", spec, tags)
                        if self.metrics is not None:
                            self.metrics.counter(
                                "executor.speculation_wins"
                            ).inc()
                    result.set_result(fut.result())
                    return
                if not all(r.done() for r in racers):
                    return  # a twin is still running — it may yet win
                if timer[0] is not None:
                    timer[0].cancel()
                if len(racers) == 1:
                    # every retry failed before the deadline — no twin to
                    # wait on; surface the primary's TaskFailure as-is
                    result.set_exception(fut.exception())
                    return
                # every racer failed — one TaskFailure, attempts accounted
                # across the original and its duplicate (this invocation)
                with self._lock:
                    attempts = sum(
                        r.attempts
                        for r in self.records[start_idx:]
                        if r.name == spec.name
                    )
                failure = TaskFailure(
                    f"task {spec.name!r} failed on all {len(racers)} "
                    f"container(s) after {attempts} total attempts"
                )
                failure.__cause__ = racers[-1].exception()
                result.set_exception(failure)

        def arm_backup() -> None:
            with state_lock:
                if result.done() or racers[0].done():
                    return
                log.info("speculating single straggler task %s", spec.name)
                with self._lock:
                    self._speculations += 1
                self._publish("SpeculationFired", spec, tags)
                if self.metrics is not None:
                    self.metrics.counter("executor.speculations").inc()
                backup = self._pool.submit(
                    self._run_with_retries, spec, args, True
                )
                racers.append(backup)
            backup.add_done_callback(on_racer_done)

        primary = self._pool.submit(self._run_with_retries, spec, args)
        racers.append(primary)
        baseline = self._historical_baseline(spec)
        if baseline is not None:
            deadline = self.config.speculation_factor * max(baseline, 1e-4)
            self._publish(
                "SpeculationArmed", spec, tags,
                baseline_s=baseline, deadline_s=deadline,
            )
            t = threading.Timer(deadline, arm_backup)
            t.daemon = True
            timer[0] = t
            t.start()
        primary.add_done_callback(on_racer_done)
        return result

    def run(
        self, spec: FunctionSpec, *args: Any,
        tags: Optional[Dict[str, Any]] = None,
    ) -> Any:
        """Run one task synchronously, speculating against its own history
        (blocking face of ``submit_speculative``)."""
        return self.submit_speculative(spec, *args, tags=tags).result()

    # -------------------------------------------------- bulk + speculation
    def map_with_speculation(
        self, specs_and_args: Sequence[Tuple[FunctionSpec, Tuple[Any, ...]]]
    ) -> List[Any]:
        """Run a batch of sibling tasks; duplicate stragglers.

        Used for fan-out stages (per-shard transforms, eval shards).  The
        duplicate races the original; the first *successful* finisher wins —
        pure functions make the race benign.  A racer that exhausts its
        retries does not sink the task while its twin is still running: the
        task fails (one ``TaskFailure``) only once every racer has failed,
        with attempts accounted across the duplicates.
        """
        cfg = self.config
        futures: List[Future] = [
            self._pool.submit(self._run_with_retries, spec, args)
            for spec, args in specs_and_args
        ]
        start = [time.perf_counter()] * len(futures)
        results: List[Any] = [None] * len(futures)
        done = [False] * len(futures)
        # duration at *completion* (not now-start: measuring completed
        # siblings against the wall clock would grow the median in lockstep
        # with the straggler's elapsed time and speculation could never fire)
        finish: List[Optional[float]] = [None] * len(futures)
        speculated: Dict[int, Future] = {}
        while not all(done):
            completed_times = [
                finish[i] - start[i]
                for i, d in enumerate(done)
                if d and finish[i] is not None
            ]
            median = (
                sorted(completed_times)[len(completed_times) // 2]
                if len(completed_times) >= cfg.speculation_min_samples
                else None
            )
            for i, fut in enumerate(futures):
                if done[i]:
                    continue
                spec, args = specs_and_args[i]
                racers: List[Future] = [fut]
                if i in speculated:
                    racers.append(speculated[i])
                finished = [f for f in racers if f.done()]
                success = next(
                    (f for f in finished if f.exception() is None), None
                )
                if success is not None:
                    results[i] = success.result()
                    done[i] = True
                    finish[i] = time.perf_counter()
                    continue
                if finished and len(finished) == len(racers):
                    # every racer failed — surface exactly one TaskFailure
                    # carrying the attempt count across all duplicates
                    done[i] = True
                    attempts = self._attempts_for(spec.name)
                    raise TaskFailure(
                        f"task {spec.name!r} failed on all {len(racers)} "
                        f"container(s) after {attempts} total attempts"
                    ) from finished[-1].exception()
                # at least one racer in flight: maybe launch a duplicate
                elapsed = time.perf_counter() - start[i]
                if (
                    median is not None
                    and i not in speculated
                    and not finished  # don't duplicate an already-failed task
                    and elapsed > cfg.speculation_factor * max(median, 1e-4)
                ):
                    log.info("speculating straggler task %s", spec.name)
                    with self._lock:
                        self._speculations += 1
                    self._publish("SpeculationFired", spec, None)
                    if self.metrics is not None:
                        self.metrics.counter("executor.speculations").inc()
                    speculated[i] = self._pool.submit(
                        self._run_with_retries, spec, args, True
                    )
            time.sleep(0.002)
        return results

    def _attempts_for(self, name: str) -> int:
        """Attempts recorded for ``name`` across the original and any
        speculated duplicates (the cross-container retry ledger)."""
        with self._lock:
            return sum(r.attempts for r in self.records if r.name == name)

    # ------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tasks": len(self.records),
                "retries": sum(r.attempts - 1 for r in self.records),
                "speculated": self._speculations,
                "cold_starts": self.warm_cache.stats.cold_starts,
                "warm_hits": self.warm_cache.stats.warm_hits,
            }
