"""``repro_torch.Client`` — the one construction path onto the platform.

The paper's pitch (4.1, 4.6) is that the entire lakehouse hides behind a
single Python client: no ``ObjectStore → Catalog → TableFormat →
ServerlessExecutor → Runner`` constructor soup in user code.  The Client
owns that wiring and exposes every surface on one object:

* data:        ``write_table / query / tables / log / tag``
* branches:    ``branch("feat_1")`` → a ``BranchHandle`` context manager
  (ephemeral by default — merge on success, roll back on audit failure)
* pipelines:   ``run / replay`` returning a typed ``RunHandle``, and
  ``run_async`` returning a future-like ``AsyncRunHandle``
* maintenance: ``gc() / compact() / cache.stats() / cache.prune()``

``Runner`` remains importable from ``repro_torch.core`` as the internal engine;
``repro_torch.Runner`` is a deprecation shim pointing here.

On open the Client also loads the executor's per-fingerprint speculation
latency history from the lake (``latencyhist`` namespace) and persists it
back after every run — a fresh process inherits straggler baselines
instead of re-learning them.  The history is keyed by each stage's
``FunctionSpec`` fingerprint, which hashes this package's own stage
function, so it carries between Clients of this package but gives a
Client of the JAX package (``repro``) on the same lake no seeds, nor
the other way round: its scheduler then estimates from bytes.  Tables,
manifests and the node cache carry across both ways.

Pipelines run on the Client's ``device``: ``None`` means the card and
raises at construction without a CUDA device; pass ``device="cpu"`` to
run on the CPU.
"""
from __future__ import annotations

import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.analysis import LintFailed, LintReport, lint_pipeline
from repro_torch.api.handles import AsyncRunHandle, RunHandle, RunState
from repro_torch.api.project import Project, resolve_pipeline
from repro_torch.catalog.nessie import Catalog, Commit
from repro_torch.core.physical import PlannerConfig
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.runner import ExpectationFailed, Runner, RunResult
from repro_torch.core.snapshot import NodeCacheRegistry
from repro_torch.io.objectstore import ObjectStore
from repro_torch.maintenance import (
    CompactionReport,
    EvictionPolicy,
    EvictionReport,
    GCReport,
    collect_garbage,
    compact_branch,
    compact_table,
    prune_cache,
)
from repro_torch.runtime.executor import ExecutorConfig, ServerlessExecutor
from repro_torch.table.format import Snapshot, TableFormat
from repro_torch.table.schema import Schema
from repro_torch.telemetry.bus import EventBus, Subscription, read_spool
from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.runlog import RunLogStore
from repro_torch.telemetry.tracing import RunTrace
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("api.client")

#: spool file (JSON lines) the bus mirrors events into, relative to the
#: lake root — what a *separate* ``repro events --follow`` process tails
SPOOL_RELPATH = Path("telemetry") / "events.jsonl"

#: lake namespace persisting the executor's per-fingerprint latency
#: history (straggler-speculation baselines survive process restarts)
_LATENCY_NS = "latencyhist"

RunTarget = Union[Pipeline, Project, str, Path, ModuleType]


class CacheMaintenance:
    """``client.cache`` — the differential cache's maintenance face."""

    def __init__(self, client: "Client"):
        self._client = client

    @property
    def registry(self) -> NodeCacheRegistry:
        # the registry is stateless over the store, so maintenance verbs
        # must not force an executor/runner into existence to reach it
        return self._client.cache_registry

    def stats(self) -> Dict[str, Any]:
        """Registry size + entry listing (what ``repro cache stats`` prints)."""
        items = self.registry.entries()
        return {
            "entries": len(items),
            "total_bytes": sum(e.output_bytes for e in items.values()),
            "items": items,
        }

    def prune(
        self,
        *,
        max_bytes: Optional[int] = None,
        ttl_s: Optional[float] = None,
        dry_run: bool = False,
    ) -> EvictionReport:
        """Evict entries by LRU within a byte budget and/or TTL."""
        return prune_cache(
            self.registry,
            EvictionPolicy(max_bytes=max_bytes, ttl_s=ttl_s),
            dry_run=dry_run,
        )


class Client:
    """One object, the whole platform.  ``Client(path)`` opens (or
    initializes) a lake at ``path``; ``Client.ephemeral()`` gives a
    throwaway tempdir lake for examples/tests/benchmarks.

    ``device`` is where queries and pipeline stages execute: ``None``
    means ``cuda`` and raises here, before the lake is touched, when no
    CUDA device exists; ``"cpu"`` runs on the CPU."""

    def __init__(
        self,
        path: Union[str, Path, None] = None,
        *,
        shard_rows: Optional[int] = None,
        executor_config: Optional[ExecutorConfig] = None,
        executor: Optional[ServerlessExecutor] = None,
        telemetry: bool = True,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if path is None:
            path = tempfile.mkdtemp(prefix="repro_lake_")
        self.path = Path(path)
        self.store = ObjectStore(self.path)
        #: the observability plane: one bus every component publishes
        #: into, one metrics registry absorbing StoreStats/executor
        #: numbers, one runlog reading traces back.  ``telemetry=False``
        #: turns the bus off entirely (no events, no spool, no run log) —
        #: the benchmark baseline
        self.metrics = MetricsRegistry()
        self.bus: Optional[EventBus] = (
            EventBus(spool_path=self.path / SPOOL_RELPATH)
            if telemetry
            else None
        )
        self.runlog = RunLogStore(self.store)
        if telemetry:
            self.store.stats.attach_metrics(self.metrics)
        self.catalog = Catalog(self.store)
        self.fmt = (
            TableFormat(self.store, shard_rows=shard_rows)
            if shard_rows is not None
            else TableFormat(self.store)
        )
        self._executor_config = executor_config
        self._executor = executor
        self._owns_executor = executor is None
        self._runner: Optional[Runner] = None
        self.cache_registry = NodeCacheRegistry(self.store)
        self._closed = False
        #: guards lazy executor/runner construction — two concurrent
        #: run_async calls on a fresh Client must not build two fleets
        self._init_lock = threading.Lock()
        #: background lane for run_async (lazily created, joined on close);
        #: ``_closed`` is read/written under ``_async_lock`` so a racing
        #: run_async cannot recreate the pool after close() joined it
        self._async_pool: Optional[ThreadPoolExecutor] = None
        self._async_lock = threading.Lock()
        #: last-persisted latency histories (skip unchanged refs on save);
        #: guarded by ``_history_lock`` — concurrent async runs save too
        self._history_lock = threading.Lock()
        self._persisted_history: Dict[str, tuple] = {}
        self._persisted_forecasts: Dict[str, Dict[str, float]] = {}
        if executor is not None:
            self._load_latency_history()
        self.cache = CacheMaintenance(self)

    @classmethod
    def ephemeral(cls, **kwargs: Any) -> "Client":
        """A lake in a fresh temp directory (examples and tests)."""
        return cls(None, **kwargs)

    # ---------------------------------------------------------- lifecycle
    @property
    def executor(self) -> ServerlessExecutor:
        with self._init_lock:
            if self._executor is None:
                self._executor = ServerlessExecutor(
                    self._executor_config,
                    bus=self.bus, metrics=self.metrics,
                )
                self._load_latency_history()
            elif self._executor.bus is None and self.bus is not None:
                # caller-supplied fleet: adopt this lake's telemetry plane
                self._executor.bus = self.bus
                self._executor.metrics = self.metrics
            return self._executor

    @property
    def runner(self) -> Runner:
        """The internal engine (transform-audit-write orchestrator)."""
        executor = self.executor
        with self._init_lock:
            if self._runner is None:
                self._runner = Runner(
                    self.catalog, self.fmt, executor,
                    cache_registry=self.cache_registry,
                    bus=self.bus, runlog=self.runlog,
                    device=self.device,
                )
            return self._runner

    def close(self) -> None:
        with self._async_lock:
            if self._closed:
                return
            self._closed = True
            pool, self._async_pool = self._async_pool, None
        if pool is not None:
            # join in-flight async runs BEFORE tearing the executor down —
            # a run mid-flight must never lose its container fleet
            pool.shutdown(wait=True)
        if self._executor is not None:
            self._save_latency_history()
            if self._owns_executor:
                self._executor.shutdown()
        if self.bus is not None:
            self.bus.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"Client({str(self.path)!r})"

    # ------------------------------------------------- latency persistence
    def _load_latency_history(self) -> None:
        """Seed the executor's speculation baselines from the lake."""
        assert self._executor is not None
        refs = self.store.list_refs(_LATENCY_NS)
        history = {
            fp: [float(d) for d in raw.get("durations", [])]
            for fp, raw in refs.items()
        }
        if history:
            self._executor.seed_latency_history(history)
            log.info(
                "loaded latency baselines for %d function fingerprint(s)",
                len(history),
            )
        # keep persisted forecasts so an unchanged fingerprint's ref is
        # neither rewritten nor stripped of its forecast on save
        self._persisted_forecasts = {
            fp: dict(raw["forecast"])
            for fp, raw in refs.items()
            if isinstance(raw.get("forecast"), dict)
        }
        self._persisted_history = {
            fp: (
                tuple(ds),
                tuple(sorted(self._persisted_forecasts.get(fp, {}).items())),
            )
            for fp, ds in history.items()
        }

    def _save_latency_history(self) -> None:
        """Persist changed histories (tiny JSON refs, one per fingerprint).

        The scheduler's latest predicted-vs-actual forecast rides the same
        ref (``forecast`` key), so it ages out with the durations under the
        lakekeeper's ``latency_ttl_s`` sweep — no second GC policy.
        """
        if self._executor is None:
            return
        with self._history_lock:
            fresh = self._executor.forecasts()
            for fp, durations in self._executor.latency_history().items():
                # latest forecast wins; fall back to the persisted one so a
                # save without a new run never strips it from the ref
                forecast = fresh.get(fp) or self._persisted_forecasts.get(fp)
                snap = (
                    tuple(durations),
                    tuple(sorted((forecast or {}).items())),
                )
                if self._persisted_history.get(fp) == snap:
                    continue
                ref = {"durations": list(durations), "updated_at": time.time()}
                if forecast:
                    ref["forecast"] = dict(forecast)
                self.store.set_ref(_LATENCY_NS, fp, ref)
                self._persisted_history[fp] = snap
                if forecast:
                    self._persisted_forecasts[fp] = dict(forecast)

    # ------------------------------------------------------------ branches
    def branch(
        self,
        name: str,
        *,
        base: str = "main",
        ephemeral: Optional[bool] = None,
    ) -> "BranchHandle":
        """A branch-scoped view of the platform (context manager).

        ``ephemeral=None`` (default) resolves to True when the handle has
        to create the branch: on a clean ``with`` exit the branch merges
        into ``base`` and disappears; an exception or a non-SUCCESS run
        rolls it back instead (delete, no merge).  A pre-existing branch
        defaults to non-ephemeral — the handle scopes, the exit touches
        nothing.
        """
        return BranchHandle(self, name, base=base, ephemeral=ephemeral)

    def branches(self) -> List[str]:
        return self.catalog.branches()

    def create_branch(
        self, name: str, *, from_branch: Optional[str] = None
    ) -> Commit:
        return self.catalog.create_branch(name, from_branch=from_branch)

    def log(self, branch: str = "main", *, limit: int = 50) -> List[Commit]:
        return self.catalog.log(branch, limit=limit)

    def tables(self, branch: str = "main") -> Dict[str, str]:
        return self.catalog.tables(branch=branch)

    def tag(self, name: str, *, branch: str = "main",
            commit_id: Optional[str] = None) -> str:
        """Pin a name to a commit (GC root, time-travel anchor)."""
        target = commit_id or self.catalog.head(branch).commit_id
        self.catalog.tag(name, target)
        return target

    def tags(self) -> Dict[str, str]:
        return self.catalog.tags()

    # ---------------------------------------------------------------- data
    def write_table(
        self,
        name: str,
        data: Dict[str, np.ndarray],
        *,
        branch: str = "main",
        schema: Optional[Schema] = None,
        append: bool = False,
        message: Optional[str] = None,
        author: str = "user",
    ) -> Snapshot:
        """Write columnar data as a table version and commit it.

        The schema is inferred from the arrays unless given; ``append``
        extends the branch's current version via structural sharing.
        """
        if schema is None:
            schema = Schema.of(
                **{c: str(np.asarray(v).dtype) for c, v in data.items()}
            )
        parent: Optional[Snapshot] = None
        if append:
            head_tables = self.catalog.tables(branch=branch)
            if name in head_tables:
                parent = self.fmt.load_snapshot(head_tables[name])
        snap = self.fmt.write(
            name, schema, data, parent=parent, append=parent is not None
        )
        self.catalog.commit(
            branch,
            {name: self.fmt.manifest_key(snap)},
            message=message or f"write_table {name}",
            author=author,
        )
        return snap

    def query(
        self,
        sql: str,
        *,
        branch: Optional[str] = None,
        commit_id: Optional[str] = None,
        engine: str = "auto",
    ) -> Dict[str, np.ndarray]:
        """Synchronous SQL against a branch head or any commit.

        Zero registration: FROM/JOIN names resolve against the catalog at
        query time.  ``engine`` selects the filter+agg execution path —
        ``"auto"`` routes eligible plans through the fused CUDA kernel
        (exactness proven from shard stats, see ``repro_torch.engine.route``),
        ``"kernel"`` forces it, ``"jnp"`` pins the reference path.
        """
        return self.runner.query(
            sql, branch=branch, commit_id=commit_id, engine=engine
        )

    # -------------------------------------------------------- observability
    def trace(self, run_id: int) -> RunTrace:
        """The persisted trace of a recorded run: span tree (run → stage →
        node/scan), queue-vs-exec-vs-commit breakdown, critical path,
        Chrome-trace export (``trace.write_chrome_trace(path)``).

        Raises ``KeyError`` when the run has no trace — telemetry was off,
        or ``gc --runlog-ttl`` expired it.
        """
        return RunTrace.from_events(self.runlog.get(run_id), run_id=run_id)

    def events(
        self,
        *,
        follow: bool = False,
        run_id: Optional[int] = None,
        buffer: int = 4096,
    ) -> Any:
        """The live event stream.

        ``follow=False`` (default) returns the events already mirrored to
        this lake's spool file — including those published by *other*
        processes.  ``follow=True`` returns a :class:`Subscription` on the
        in-process bus (context manager; ``poll()`` / ``follow()``), which
        sees everything published from now on.
        """
        if follow:
            if self.bus is None:
                raise RuntimeError(
                    "telemetry is disabled for this client "
                    "(Client(..., telemetry=True) to enable)"
                )
            return self.bus.subscribe(maxlen=buffer)
        return read_spool(self.path / SPOOL_RELPATH, run_id=run_id)

    # ---------------------------------------------------------------- lint
    def lint(
        self,
        target: RunTarget,
        *,
        branch: str = "main",
    ) -> LintReport:
        """Static preflight over a pipeline: lineage + schema checks,
        cache-poison rules, plan diagnostics, blast radius.

        Executes nothing and writes nothing — the only reads are catalog
        refs and table manifests, to resolve the schemas of external
        source tables at the ``branch`` head (falling back to ``main``
        when the branch does not exist yet).
        """
        pipeline = resolve_pipeline(target)
        schemas, snapshots, head = self._lint_inputs(pipeline, branch)
        return lint_pipeline(
            pipeline,
            external_schemas=schemas,
            external_snapshots=snapshots,
            catalog_tables=set(head),
        )

    def _lint_inputs(self, pipeline, branch: str):
        """Catalog-side inputs for the static passes: external-source
        schemas, loaded snapshots (shard stats for the typed checks), and
        the set of table names at the branch head.  Reads refs and
        manifests only — never shard data, never a write."""
        lookup = branch if self.catalog.has_branch(branch) else "main"
        head_tables = self.catalog.tables(branch=lookup)
        schemas: Dict[str, Optional[Schema]] = {}
        snapshots: Dict[str, Any] = {}
        for table in pipeline.external_sources():
            if table in head_tables:
                snap = self.fmt.load_snapshot(head_tables[table])
                snapshots[table] = snap
                schemas[table] = snap.schema
        return schemas, snapshots, head_tables

    def explain(
        self,
        target: Any,
        *,
        branch: str = "main",
        commit_id: Optional[str] = None,
        engine: str = "auto",
    ):
        """Static plan explainability — zero execution, zero store writes.

        Two modes, selected by the target:

        * a SQL string (``SELECT ...``) — returns an
          :class:`~repro_torch.analysis.explain.ExplainedQuery`: planned scans,
          pushdown/pruning, the kernel-vs-jnp verdict with the full route
          trace (every eligibility check, pass/fail, fix hints), inferred
          output schema, and typed-dataflow findings.  The predicted
          ``engine_path`` — or the predicted :class:`RouteError` message,
          byte-for-byte — is exactly what ``client.query`` would do,
          because both read the same interactive plan.
        * a pipeline/project/module — returns a
          :class:`~repro_torch.analysis.explain.PipelineExplanation`: per-node
          route verdicts (equal to what the physical planner stamps onto
          its stages) plus the full preflight :class:`LintReport`.
        """
        from repro_torch.analysis.explain import explain_pipeline, explain_query

        if isinstance(target, str) and target.lstrip()[:6].lower() == "select":
            from repro_torch.core.physical import resolve_query_snapshots
            from repro_torch.engine.sql import parse_sql

            query = parse_sql(target)
            snapshots = resolve_query_snapshots(
                self.catalog, self.fmt, query,
                branch=branch, commit_id=commit_id, text=target,
            )
            return explain_query(query, snapshots, engine=engine)
        pipeline = resolve_pipeline(target)
        schemas, snapshots, head = self._lint_inputs(pipeline, branch)
        return explain_pipeline(
            pipeline,
            external_schemas=schemas,
            snapshots=snapshots,
            engine=engine,
            catalog_tables=set(head),
        )

    # ---------------------------------------------------------------- runs
    def run(
        self,
        target: RunTarget,
        *,
        branch: str = "main",
        params: Optional[Dict[str, Any]] = None,
        fusion: bool = True,
        pushdown: bool = True,
        cache: bool = True,
        base_commit: Optional[str] = None,
        author: str = "user",
        planner_config: Optional[PlannerConfig] = None,
        raise_errors: bool = True,
        parallelism: Optional[int] = None,
        preflight: bool = False,
        schedule: str = "critical_path",
        streaming: Optional[bool] = None,
    ) -> RunHandle:
        """Execute a pipeline/project/module with transform-audit-write.

        Always returns a ``RunHandle``; an audit failure is a typed
        ``AUDIT_FAILED`` outcome (run rolled back), never an exception.
        Infrastructure/user-code errors raise unless ``raise_errors=False``
        captures them into an ``ERROR`` handle.

        ``preflight=True`` lints the pipeline first (``Client.lint``) and
        refuses to launch on any error-severity finding — ``LintFailed``
        carries the full report (captured into an ``ERROR`` handle when
        ``raise_errors=False``).  Warnings never block a run.

        ``parallelism`` caps how many independent stages the wave
        scheduler keeps in flight (default: the executor config's
        ``max_concurrent_stages``, or the memory-capped admission gate
        under ``schedule="critical_path"``).  ``schedule`` picks the
        dispatch order — ``"critical_path"`` (cost-weighted longest path
        first, the default) or ``"stage_id"`` (ascending, the legacy
        wave order) — and ``streaming`` toggles the outputs-ready
        handoff plus incremental shard scans (default: on under
        critical_path, off under stage_id).  All three are throughput
        knobs only: results are byte-identical at every setting.
        """
        pipeline = resolve_pipeline(target)
        if preflight:
            report = self.lint(pipeline, branch=branch)
            if report.errors:
                err = LintFailed(report)
                if raise_errors:
                    raise err
                return RunHandle(
                    state=RunState.ERROR,
                    run_id=-1,
                    branch=branch,
                    merged_commit=None,
                    error=err,
                    _fmt=self.fmt,
                    _runlog=self.runlog,
                )
        try:
            result = self.runner.run(
                pipeline,
                branch=branch,
                params=params,
                fusion=fusion,
                pushdown=pushdown,
                cache=cache,
                base_commit=base_commit,
                author=author,
                planner_config=planner_config,
                parallelism=parallelism,
                schedule=schedule,
                streaming=streaming,
            )
        except ExpectationFailed as e:
            self._save_latency_history()
            rec = e.record
            return RunHandle(
                state=RunState.AUDIT_FAILED,
                run_id=rec.run_id if rec else -1,
                branch=branch,
                merged_commit=None,
                artifacts=dict(rec.artifacts) if rec else {},
                checks=dict(rec.checks) if rec else {},
                stats=dict(rec.stats) if rec else {},
                plan=e.plan,
                _fmt=self.fmt,
                _runlog=self.runlog,
            )
        except Exception as e:
            self._save_latency_history()
            if raise_errors:
                raise
            return RunHandle(
                state=RunState.ERROR,
                # the runner stamps its run id on escaping exceptions, so
                # the handle (and its trace) stay addressable; -1 only
                # when the failure predates run-id allocation
                run_id=getattr(e, "repro_run_id", -1),
                branch=branch,
                merged_commit=None,
                error=e,
                _fmt=self.fmt,
                _runlog=self.runlog,
            )
        self._save_latency_history()
        return self._handle_from_result(result)

    def run_async(
        self,
        target: RunTarget,
        *,
        branch: str = "main",
        params: Optional[Dict[str, Any]] = None,
        fusion: bool = True,
        pushdown: bool = True,
        cache: bool = True,
        base_commit: Optional[str] = None,
        author: str = "user",
        planner_config: Optional[PlannerConfig] = None,
        raise_errors: bool = False,
        parallelism: Optional[int] = None,
        preflight: bool = False,
        schedule: str = "critical_path",
        streaming: Optional[bool] = None,
    ) -> AsyncRunHandle:
        """``run()`` without the wait (paper Table 1's async runs).

        Submits the run to a background thread and returns immediately
        with a future-like ``AsyncRunHandle``: ``.state`` reads
        ``RUNNING`` until the run resolves, ``.poll()`` probes without
        blocking, ``.result()`` joins and yields the same typed
        ``RunHandle`` a synchronous ``run()`` would have returned —
        identical SUCCESS/AUDIT_FAILED/ERROR semantics, transform-audit-
        write included.  ``raise_errors`` defaults to **False** here so
        infrastructure errors resolve into an ``ERROR`` handle instead of
        detonating inside the background thread; pass ``True`` to have
        ``result()`` re-raise them.

        Concurrent async runs are safe — branch heads move via CAS, run
        ids are allocated atomically, and the executor fleet is shared —
        but per-run ``io`` deltas are store-global and may include a
        concurrent run's traffic.  ``close()`` joins in-flight runs.
        """
        # resolve on the caller's thread: module imports (and their
        # side-effectful project registration) don't belong on the lane
        pipeline = resolve_pipeline(target)
        with self._async_lock:
            # checked under the lock: a racing close() must not leave a
            # freshly-built pool (and a run against a dead fleet) behind
            if self._closed:
                raise RuntimeError("client is closed")
            if self._async_pool is None:
                self._async_pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="run-async"
                )
            pool = self._async_pool
        future = pool.submit(
            self.run,
            pipeline,
            branch=branch,
            params=params,
            fusion=fusion,
            pushdown=pushdown,
            cache=cache,
            base_commit=base_commit,
            author=author,
            planner_config=planner_config,
            raise_errors=raise_errors,
            parallelism=parallelism,
            preflight=preflight,
            schedule=schedule,
            streaming=streaming,
        )
        return AsyncRunHandle(future, branch=branch)

    def replay(
        self,
        run_id: int,
        target: RunTarget,
        *,
        strict_code: bool = True,
    ) -> RunHandle:
        """Re-execute a recorded run: same code, same data version."""
        pipeline = resolve_pipeline(target)
        result = self.runner.replay(pipeline, run_id, strict_code=strict_code)
        self._save_latency_history()
        handle = self._handle_from_result(result, replay_of=run_id)
        return handle

    def _handle_from_result(
        self, result: RunResult, *, replay_of: Optional[int] = None
    ) -> RunHandle:
        # a merged run always audited clean, but replay re-executes WITHOUT
        # an audit gate (it never merges) — a reproduced failing check must
        # surface as AUDIT_FAILED, not ride a hardcoded SUCCESS
        ok = all(result.checks.values())
        return RunHandle(
            state=RunState.SUCCESS if ok else RunState.AUDIT_FAILED,
            run_id=result.run_id,
            branch=result.branch,
            merged_commit=result.merged_commit,
            artifacts=dict(result.artifacts),
            checks=dict(result.checks),
            stats=dict(result.stats),
            plan=result.plan,
            replay_of=replay_of,
            _fmt=self.fmt,
            _runlog=self.runlog,
        )

    # ---------------------------------------------------------- maintenance
    def gc(
        self,
        *,
        history: Optional[int] = None,
        grace_s: float = 900.0,
        pin_ttl_s: Optional[float] = 86400.0,
        latency_ttl_s: Optional[float] = 30 * 86400.0,
        runlog_ttl_s: Optional[float] = 14 * 86400.0,
        dry_run: bool = False,
    ) -> GCReport:
        """Mark-and-sweep unreachable objects (the lakekeeper's GC).

        ``runlog_ttl_s`` is the run-trace retention window: traces older
        than it are swept (ref + blob, one pass); None keeps every trace.
        """
        return collect_garbage(
            self.store, self.catalog, self.fmt,
            history=history, grace_s=grace_s,
            pin_ttl_s=pin_ttl_s, latency_ttl_s=latency_ttl_s,
            runlog_ttl_s=runlog_ttl_s,
            dry_run=dry_run, bus=self.bus,
        )

    def compact(
        self,
        table: Optional[str] = None,
        *,
        branch: str = "main",
        target_rows: Optional[int] = None,
        min_fill: float = 0.5,
        dry_run: bool = False,
    ) -> List[CompactionReport]:
        """Merge small shards into larger ones (one table or the branch)."""
        if table is not None:
            return [compact_table(
                self.catalog, self.fmt, table, branch=branch,
                target_rows=target_rows, min_fill=min_fill, dry_run=dry_run,
                bus=self.bus,
            )]
        return compact_branch(
            self.catalog, self.fmt, branch=branch,
            target_rows=target_rows, min_fill=min_fill, dry_run=dry_run,
            bus=self.bus,
        )


class BranchHandle:
    """A branch-scoped facade: the Client's surface with ``branch=`` fixed.

    As a context manager it gives the paper's feature-branch workflow the
    transactional shape of a run, one level up (Fig. 4): work lands on the
    branch; a clean exit merges it into ``base`` atomically and deletes
    the branch; an exception — or any run that did not SUCCEED — rolls
    the whole branch back instead.  Dirty artifacts never reach ``base``.
    """

    def __init__(
        self,
        client: Client,
        name: str,
        *,
        base: str = "main",
        ephemeral: Optional[bool] = None,
    ):
        self.client = client
        self.name = name
        self.base = base
        self._ephemeral = ephemeral
        self._created = False
        self._failed = False
        self._entered = False
        #: async runs launched through this handle — joined at exit so
        #: the merge/rollback decision never races an in-flight run
        self._async_handles: List[AsyncRunHandle] = []

    # ----------------------------------------------------------- lifecycle
    def _ensure(self) -> None:
        if not self.client.catalog.has_branch(self.name):
            self.client.catalog.create_branch(self.name, from_branch=self.base)
            self._created = True

    @property
    def ephemeral(self) -> bool:
        return self._created if self._ephemeral is None else self._ephemeral

    def __enter__(self) -> "BranchHandle":
        self._ensure()
        self._entered = True
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        self._entered = False
        # join in-flight async runs FIRST: the exit-time merge/rollback
        # decision must see their outcomes (and their merges into this
        # branch must not race its deletion).  The outcome is read off the
        # joined future directly — done-callbacks may still be in flight
        for handle in self._async_handles:
            try:
                ok = handle._future.result().ok
            except BaseException:
                ok = False  # an escaped infra error rolls the branch back
            if not ok:
                self._failed = True
        self._async_handles.clear()
        if not self.ephemeral:
            return
        if exc_type is not None or self._failed:
            # rollback: the branch (and everything only it referenced)
            # vanishes; base never sees it.  Blobs go at the next gc.
            self.client.catalog.delete_branch(self.name)
            log.info("rolled back ephemeral branch %r", self.name)
            return
        self.client.catalog.merge(
            self.name, self.base,
            message=f"merge branch {self.name}",
            delete_source=True,
        )
        log.info("merged ephemeral branch %r into %r", self.name, self.base)

    # ------------------------------------------------------- scoped surface
    def run(self, target: RunTarget, **kwargs: Any) -> RunHandle:
        self._ensure()
        kwargs.setdefault("raise_errors", False)
        handle = self.client.run(target, branch=self.name, **kwargs)
        if not handle.ok:
            self._failed = True
        return handle

    def run_async(self, target: RunTarget, **kwargs: Any) -> AsyncRunHandle:
        """Async run scoped to this branch.  Any handle still in flight
        when the ``with`` block exits is joined there, so the exit-time
        merge/rollback decision always sees the run's outcome."""
        self._ensure()
        handle = self.client.run_async(target, branch=self.name, **kwargs)

        def _note_outcome(fut: Any) -> None:
            try:
                ok = fut.result().ok
            except BaseException:
                ok = False
            if not ok:
                self._failed = True

        handle._future.add_done_callback(_note_outcome)
        self._async_handles.append(handle)
        return handle

    def lint(self, target: RunTarget) -> LintReport:
        """Preflight against this branch's table schemas."""
        self._ensure()
        return self.client.lint(target, branch=self.name)

    def explain(self, target: Any, **kwargs: Any) -> Any:
        """Static explain (SQL or pipeline) against this branch's head."""
        self._ensure()
        kwargs.setdefault("branch", self.name)
        return self.client.explain(target, **kwargs)

    def replay(self, run_id: int, target: RunTarget, **kwargs: Any) -> RunHandle:
        return self.client.replay(run_id, target, **kwargs)

    def query(self, sql: str, **kwargs: Any) -> Dict[str, np.ndarray]:
        self._ensure()
        kwargs.setdefault("branch", self.name)
        return self.client.query(sql, **kwargs)

    def write_table(self, name: str, data: Dict[str, np.ndarray],
                    **kwargs: Any) -> Snapshot:
        self._ensure()
        kwargs.setdefault("branch", self.name)
        return self.client.write_table(name, data, **kwargs)

    def tables(self) -> Dict[str, str]:
        self._ensure()
        return self.client.tables(branch=self.name)

    def log(self, **kwargs: Any) -> List[Commit]:
        self._ensure()
        return self.client.log(self.name, **kwargs)

    def tag(self, name: str, **kwargs: Any) -> str:
        self._ensure()
        kwargs.setdefault("branch", self.name)
        return self.client.tag(name, **kwargs)

    def head(self) -> Commit:
        self._ensure()
        return self.client.catalog.head(self.name)

    def __repr__(self) -> str:
        return (
            f"BranchHandle({self.name!r}, base={self.base!r}, "
            f"ephemeral={self.ephemeral})"
        )
