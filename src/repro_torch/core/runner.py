"""The run orchestrator: transform → audit → write (paper 4.3, Fig. 4).

``bauplan run`` semantics:

1. resolve (or create) the working branch — "Bauplan detects the Git
   context and creates a Nessie branch with the same name";
2. pin the base commit (or the one a replayed run recorded);
3. execute the physical plan **into an ephemeral branch** ``run_<id>``;
4. audit: every expectation must pass;
5. write: merge the ephemeral branch atomically into the working branch
   and delete it — or, on any failure, delete it without merging so dirty
   artifacts are never visible (the database-transaction analogy).

Stage execution goes through the serverless executor (retries, warm
starts, speculation); artifacts flow between stages as tensors on the
runner's device within a run (data locality, 4.5) and hit the object
store only at stage boundaries/outputs.  Scans run on the host and each
scanned table is copied to the device once, in the stage that reads it.

Stages are *wave-scheduled*: every stage whose parents have completed is
submitted to the executor's stage lane immediately, so independent
fan-out stages run concurrently.  Each stage function runs on an
executor worker thread and issues its work on that thread's current
CUDA stream — the default stream unless a caller set another — so
stages that run at once share the card in the order their launches
reach it; the runner creates no streams of its own.

Scheduler v2 (this module + core/physical.py's cost model) makes the
wave scheduler cost-aware and streaming:

* ``schedule="critical_path"`` (default) pops the ready set by
  longest-path-to-sink weight — stage runtimes estimated from persisted
  ``latencyhist`` medians with a bytes-scanned fallback — and admission
  is capped by estimated peak memory (``ExecutorConfig
  .memory_budget_gb``) instead of a flat stage count;
  ``schedule="stage_id"`` reproduces the original wave policy exactly.
* ``streaming=True`` (default under critical_path) hands a stage's
  outputs to its dependents the moment the stage function produces them
  — downstream stages start while the upstream stage is still writing
  its artifacts and before it commits.  The stage barrier is retained
  where it matters: audits and catalog commits.

Neither knob changes semantics: artifact manifests, check verdicts and
cache entries are byte-identical at every parallelism level, ordering
mode and streaming setting, and per-stage catalog commits are applied in
stage-id order so branch history stays linear and deterministic.

The interactive query path (``Runner.query``, ``bauplan query``) plans
pushdown and the engine route from shard statistics, scans the surviving
shards on the host, moves the columns to the device, and executes on the
fused CUDA kernel or the reference torch operators.
"""
from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from dataclasses import replace as _replace
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.catalog.nessie import Catalog, CatalogError
from repro_torch.core.logical import build_logical_plan
from repro_torch.core.physical import (
    PhysicalPlan,
    PlannerConfig,
    build_physical_plan,
    critical_path_ids,
    estimate_stage_costs,
    plan_interactive_query,
    resolve_query_snapshots,
    stage_function_spec,
)
from repro_torch.core.pipeline import Pipeline
from repro_torch.core.snapshot import (
    CacheView,
    NodeCacheEntry,
    NodeCacheRegistry,
    RunRecord,
    RunRegistry,
)
from repro_torch.engine.columnar import Columnar
from repro_torch.engine.exec import compile_query
from repro_torch.engine.sql import parse_sql
from repro_torch.runtime.executor import ServerlessExecutor
from repro_torch.table.format import Snapshot, TableFormat
from repro_torch.table.scan import KERNEL_CHUNK_ROWS, execute_scan
from repro_torch.table.schema import Column, Schema
from repro_torch.telemetry.bus import EventBus
from repro_torch.telemetry.events import (
    Event,
    NodeCacheHit,
    NodeCacheMiss,
    NodeCacheRehydrated,
    QueryExecuted,
    RunFinished,
    RunStarted,
    StageCommitted,
    StageFinished,
    StageQueued,
    StageScheduled,
    StageStarted,
)
from repro_torch.telemetry.runlog import RunLogStore
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("core.runner")

#: per-run event collector bound: large enough that no realistic run
#: drops its own trace (a 1000-stage, 50-shard-per-stage run is ~55k
#: events); the bound still protects a pathological publisher
_RUNLOG_BUFFER = 131072


class ExpectationFailed(RuntimeError):
    def __init__(
        self,
        failed: List[str],
        record: Optional[RunRecord] = None,
        plan: Optional[PhysicalPlan] = None,
    ):
        super().__init__(f"expectations failed: {failed} — run rolled back")
        self.failed = failed
        #: the rolled-back run's record (run_id, stats, artifact keys) — the
        #: SDK's ``Client.run`` turns this into an AUDIT_FAILED ``RunHandle``
        #: instead of letting the exception escape
        self.record = record
        self.plan = plan


class RunContext:
    """Per-run context handed to python nodes (``ctx`` argument).

    __repr__ deliberately covers only ``params`` — run_id and branch do
    not change any node's computation, so stage fingerprints (and the
    warm-start accounting) stay stable across runs.  This is the analog
    of reusing a frozen container (4.5).
    """

    def __init__(self, branch: str, run_id: int, params: Dict[str, Any]):
        self.branch = branch
        self.run_id = run_id
        self.params = params

    def __repr__(self) -> str:
        return f"RunContext(params={sorted(self.params.items())})"


def _check_query_columns(query, snapshots, text: str) -> None:
    """Zero-registration column validation for the interactive path.

    Every referenced column must exist in the table(s) it can refer to:
    ``qual.col`` against its owner's schema, plain names against the
    union of all resolved tables.  Failures surface as
    :class:`repro_torch.engine.sql.SqlError` carrying the offending position,
    mirroring what logical-plan validation does for pipelines.
    """
    import re as _re

    from repro_torch.engine.sql import SqlError

    def pos_of(name: str) -> int:
        m = _re.search(rf"\b{_re.escape(name)}\b", text)
        return m.start() if m else 0

    qual_tables = dict(query.qualifiers())
    union = set()
    for snap in snapshots.values():
        union |= set(snap.schema.names)
    for ref in query.referenced_columns():
        if "." in ref:
            qual, _, col = ref.partition(".")
            table = qual_tables.get(qual)
            if table is None or table not in snapshots:
                raise SqlError(
                    f"unknown table qualifier {qual!r}", text, pos_of(ref)
                )
            if not snapshots[table].schema.has(col):
                raise SqlError(
                    f"table {table!r} has no column {col!r}", text, pos_of(ref)
                )
        elif ref not in union:
            raise SqlError(f"unknown column {ref!r}", text, pos_of(ref))


@dataclass
class RunResult:
    run_id: int
    branch: str
    merged_commit: Optional[str]
    artifacts: Dict[str, str]
    checks: Dict[str, bool]
    stats: Dict[str, Any]
    plan: PhysicalPlan

    @property
    def ok(self) -> bool:
        return self.merged_commit is not None


@dataclass
class Runner:
    catalog: Catalog
    fmt: TableFormat
    #: the serverless executor ``run`` and ``replay`` dispatch stages to;
    #: ``query`` only needs an ``io_pool`` from it (a
    #: ``concurrent.futures.Executor`` that parallelizes shard reads) and
    #: scans serially without one, which gives byte-identical results
    executor: Optional[ServerlessExecutor] = None
    registry: RunRegistry = None  # type: ignore[assignment]
    cache_registry: NodeCacheRegistry = None  # type: ignore[assignment]
    #: telemetry event bus (None = telemetry off: no events, no run log).
    #: The runner publishes run/stage/cache/query events; the executor and
    #: scan pool publish speculation/shard events tagged with the run id.
    bus: Optional[EventBus] = None
    runlog: RunLogStore = None  # type: ignore[assignment]
    #: where scans land and stages and queries execute; None means
    #: ``cuda`` and raises without a CUDA device (pass ``"cpu"`` to run
    #: on the CPU)
    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.registry is None:
            self.registry = RunRegistry(self.catalog.store)
        if self.cache_registry is None:
            self.cache_registry = NodeCacheRegistry(self.catalog.store)
        if self.runlog is None:
            self.runlog = RunLogStore(self.catalog.store)

    def _publish(self, event: Event) -> None:
        if self.bus is not None:
            self.bus.publish(event)

    def _require_executor(self, what: str) -> None:
        if not isinstance(self.executor, ServerlessExecutor):
            raise TypeError(
                f"Runner.{what} dispatches stages through a ServerlessExecutor; "
                f"construct the Runner with executor=ServerlessExecutor(...) "
                f"(got {type(self.executor).__name__})"
            )

    def _collect_run_events(self, collector, run_id: int) -> List[Event]:
        """Drain the per-run collector down to this run's events.  The
        collector subscribes before RunStarted and drains after
        RunFinished, so with per-run filtering a concurrent run's events
        never leak into this run's trace."""
        events = [e for e in collector.drain() if e.run_id == run_id]
        collector.close()
        return events

    # ------------------------------------------------------------ queries
    def query(
        self,
        sql: str,
        *,
        branch: Optional[str] = None,
        commit_id: Optional[str] = None,
        engine: str = "auto",
    ) -> Dict[str, np.ndarray]:
        """``bauplan query -q "SELECT ..." [-b branch]`` — synchronous QW.

        Point-wise interactive path, zero registration: every table name
        in the statement (FROM + JOINs) resolves against the catalog at
        query time — lake tables and materialized pipeline outputs alike
        — and unknown tables/columns come back as :class:`SqlError` with
        the offending position.  Each table scans on the host in
        kernel-sized chunks and moves to the runner's device; ``engine``
        picks the filter+agg execution path ("auto" | "kernel" | "jnp", see
        engine/route.py).  Time travel via branch/commit.
        """
        t0 = time.perf_counter()
        query = parse_sql(sql)
        text = query.raw_sql or sql
        parse_s = time.perf_counter() - t0

        # -- zero-registration name resolution + planning ----------------
        t1 = time.perf_counter()
        snapshots = resolve_query_snapshots(
            self.catalog, self.fmt, query,
            branch=branch, commit_id=commit_id, text=text,
        )
        _check_query_columns(query, snapshots, text)
        iq = plan_interactive_query(query, snapshots, engine=engine)
        route, residual, scans = iq.route, iq.residual, iq.scans
        plan_s = time.perf_counter() - t1

        # -- host scans in kernel-sized chunks, then one copy each -------
        # (tables scan one after another; each scan parallelizes its own
        # shards on the io pool when there is one)
        t2 = time.perf_counter()
        pool = self.executor.io_pool if self.executor is not None else None
        rels = {
            table: Columnar.from_numpy(
                execute_scan(
                    self.fmt, scan, pool=pool,
                    bus=self.bus, tags={"source": "query", "table": table},
                    chunk_rows=KERNEL_CHUNK_ROWS,
                ),
                device=self.device,
            )
            for table, scan in scans.items()
        }
        scan_s = time.perf_counter() - t2

        # -- one executable (reference or fused-kernel path) --------------
        t3 = time.perf_counter()
        residual_query = _replace(query, filter_expr=residual)
        joined = {j.table: rels[j.table] for j in query.joins}
        out = compile_query(residual_query, route=route)(
            rels[query.source], joined or None
        )
        result = out.to_numpy()  # the device-to-host copy synchronizes
        exec_s = time.perf_counter() - t3

        rows_out = len(next(iter(result.values()))) if result else 0
        self._publish(QueryExecuted(
            table=query.source,
            rows_out=rows_out,
            shards_read=sum(len(s.shards) for s in scans.values()),
            wall_s=time.perf_counter() - t0,
            engine_path=route.engine_path,
            parse_s=parse_s,
            plan_s=plan_s,
            scan_s=scan_s,
            exec_s=exec_s,
        ))
        return result

    # ---------------------------------------------------------------- run
    def run(
        self,
        pipeline: Pipeline,
        *,
        branch: str = "main",
        params: Optional[Dict[str, Any]] = None,
        fusion: bool = True,
        pushdown: bool = True,
        base_commit: Optional[str] = None,
        author: str = "user",
        cache: bool = True,
        planner_config: Optional[PlannerConfig] = None,
        parallelism: Optional[int] = None,
        schedule: str = "critical_path",
        streaming: Optional[bool] = None,
    ) -> RunResult:
        """Execute ``pipeline`` with transform-audit-write semantics.

        The cross-run differential cache is ON by default (the fast path
        is the default path): logical nodes whose transitive fingerprint
        matches a previous audited run are planned around — restored from
        the object store or elided outright — and after this run's audit
        passes its own node outputs are registered for future runs.
        ``cache=False`` bypasses the cache in both directions (full
        recompute, nothing persisted).

        ``planner_config`` overrides the ``fusion``/``pushdown`` shorthands
        when the caller needs full control (e.g. ``max_stage_nodes``) —
        thanks to node-granular cache keys, replanning under a different
        config still reuses every cached node.

        ``schedule`` picks the ready-set ordering policy of the wave
        scheduler: ``"critical_path"`` (default, Scheduler v2) pops the
        stage with the heaviest longest-path-to-sink cost estimate first
        and admits stages under the executor's estimated-peak-memory
        budget; ``"stage_id"`` reproduces the original wave policy exactly —
        ascending stage ids, in-flight bounded by a flat count.
        ``streaming`` hands stage outputs to dependents as soon as the
        stage function produces them, overlapping upstream artifact
        writes/commits with downstream work (default: on under
        ``critical_path``, off under ``stage_id``).  ``parallelism``
        pins how many stages stay in flight at once, superseding
        memory-capped admission's count backstop.  All three are
        throughput knobs, never semantics knobs: every combination
        produces byte-identical artifact manifests, check verdicts and
        cache entries.
        """
        self._require_executor("run")
        if schedule not in ("critical_path", "stage_id"):
            raise ValueError(
                f"schedule must be 'critical_path' or 'stage_id', "
                f"got {schedule!r}"
            )
        t_start = time.perf_counter()
        params = dict(params or {})

        # 1. branch handling (auto-create like the paper's git detection);
        # tolerate a concurrent run creating the same branch first
        if not self.catalog.has_branch(branch):
            try:
                self.catalog.create_branch(branch)
                log.info("created catalog branch %r from main", branch)
            except CatalogError:
                if not self.catalog.has_branch(branch):
                    raise
        base = (
            self.catalog.get_commit(base_commit)
            if base_commit
            else self.catalog.head(branch)
        )

        run_id = self.registry.next_run_id()
        ephemeral = f"run_{run_id}"
        # telemetry: subscribe BEFORE the first event so the run's trace
        # is complete; RunFinished is published on every exit path (a
        # mid-DAG crash or failed audit still closes the run span)
        collector = (
            self.bus.subscribe(maxlen=_RUNLOG_BUFFER)
            if self.bus is not None
            else None
        )
        self._publish(
            RunStarted(run_id=run_id, pipeline=pipeline.name, branch=branch)
        )
        state = "ERROR"
        failed_checks: List[str] = []
        self.catalog.create_branch(ephemeral, at_commit=base.commit_id)
        # pin the base commit: a concurrent `repro gc` must not expire the
        # data version this run is reading (grace-period pinning)
        self.registry.pin_run(run_id, base.commit_id)

        try:
            try:
                result = self._execute(
                    pipeline, branch, ephemeral, base.commit_id, params,
                    planner_config
                    or PlannerConfig(fusion=fusion, pushdown=pushdown),
                    run_id,
                    use_cache=cache,
                    parallelism=parallelism,
                    schedule=schedule,
                    streaming=streaming,
                )
            except Exception:
                # any failure: discard the ephemeral branch — prod stays clean
                self.catalog.delete_branch(ephemeral)
                raise

            # 4. audit — a failed expectation also rolls back this run's
            # candidate cache entries (they are only persisted below, after
            # the audit), so the cache can never serve unaudited artifacts
            failed = [k for k, v in result["checks"].items() if not v]
            if failed:
                self.catalog.delete_branch(ephemeral)
                rec = self._record(
                    run_id, pipeline, branch, base.commit_id, params,
                    result, merged=None, t_start=t_start,
                )
                state, failed_checks = "AUDIT_FAILED", failed
                raise ExpectationFailed(failed, record=rec, plan=result["plan"])

            # 5. write: atomic merge + ephemeral cleanup
            merged = self.catalog.merge(
                ephemeral, branch,
                message=f"run {run_id}: {pipeline.name}",
                author=author, delete_source=True,
            )
            # 6. publish this run's node outputs to the differential cache,
            # and only now apply any staged legacy->node upgrades — a
            # failed audit must leave the registry untouched, adoptions
            # included (write-after-audit covers re-keying)
            if cache:
                view = result["cache"]["view"]
                if view is not None:
                    view.apply_adoptions()
                for entry in result["cache"]["entries"].values():
                    self.cache_registry.put(entry)
            rec = self._record(
                run_id, pipeline, branch, base.commit_id, params,
                result, merged=merged.commit_id, t_start=t_start,
            )
            state = "SUCCESS"
        except BaseException as e:
            # stamp the run id on the escaping exception so an ERROR
            # handle can still locate this run's persisted trace
            try:
                e.repro_run_id = run_id  # type: ignore[attr-defined]
            except Exception:
                pass
            raise
        finally:
            self.registry.unpin_run(run_id)
            self._publish(
                RunFinished(
                    run_id=run_id,
                    state=state,
                    wall_s=time.perf_counter() - t_start,
                    failed_checks=failed_checks,
                )
            )
            if collector is not None:
                events = self._collect_run_events(collector, run_id)
                try:
                    self.runlog.put(
                        run_id, events, pipeline=pipeline.name, state=state
                    )
                except Exception:  # a failed trace write must not sink a run
                    log.warning(
                        "failed to persist runlog for run %d", run_id,
                        exc_info=True,
                    )
        return RunResult(
            run_id=run_id,
            branch=branch,
            merged_commit=merged.commit_id,
            artifacts=result["artifacts"],
            checks=result["checks"],
            stats=rec.stats,
            plan=result["plan"],
        )

    # ------------------------------------------------------------- replay
    def replay(
        self,
        pipeline: Pipeline,
        run_id: int,
        *,
        strict_code: bool = True,
        parallelism: Optional[int] = None,
        schedule: str = "critical_path",
        streaming: Optional[bool] = None,
    ) -> RunResult:
        """Re-execute run ``run_id``: same code, same data version (4.6).

        Executes into a fresh ephemeral branch that is dropped afterwards —
        replay is for debugging/inspection, it never moves branches.
        """
        self._require_executor("replay")
        rec = self.registry.get(run_id)
        if strict_code and rec.pipeline_fingerprint != pipeline.fingerprint:
            raise ValueError(
                "pipeline code differs from the recorded run "
                f"({rec.pipeline_fingerprint} != {pipeline.fingerprint}); "
                "pass strict_code=False to replay anyway"
            )
        replay_id = self.registry.next_run_id()
        ephemeral = f"run_{replay_id}"
        collector = (
            self.bus.subscribe(maxlen=_RUNLOG_BUFFER)
            if self.bus is not None
            else None
        )
        t_start = time.perf_counter()
        self._publish(
            RunStarted(
                run_id=replay_id, pipeline=pipeline.name,
                branch=rec.branch, replay_of=run_id,
            )
        )
        state = "ERROR"
        self.catalog.create_branch(ephemeral, at_commit=rec.base_commit)
        self.registry.pin_run(replay_id, rec.base_commit)
        try:
            # replay must genuinely re-execute — the differential cache is
            # bypassed so the reproducibility claim is tested, not assumed
            result = self._execute(
                pipeline, rec.branch, ephemeral, rec.base_commit,
                dict(rec.params), PlannerConfig(fusion=rec.fused), replay_id,
                use_cache=False,
                parallelism=parallelism,
                schedule=schedule,
                streaming=streaming,
            )
            state = "SUCCESS"
        finally:
            self.catalog.delete_branch(ephemeral)
            self.registry.unpin_run(replay_id)
            self._publish(
                RunFinished(
                    run_id=replay_id,
                    state=state,
                    wall_s=time.perf_counter() - t_start,
                )
            )
            if collector is not None:
                events = self._collect_run_events(collector, replay_id)
                try:
                    self.runlog.put(
                        replay_id, events, pipeline=pipeline.name, state=state
                    )
                except Exception:
                    log.warning(
                        "failed to persist runlog for replay %d", replay_id,
                        exc_info=True,
                    )
        return RunResult(
            run_id=replay_id,
            branch=rec.branch,
            merged_commit=None,
            artifacts=result["artifacts"],
            checks=result["checks"],
            stats={"replay_of": run_id},
            plan=result["plan"],
        )

    # ------------------------------------------------------------ internal
    def _execute(
        self,
        pipeline: Pipeline,
        branch: str,
        ephemeral: str,
        base_commit: str,
        params: Dict[str, Any],
        config: PlannerConfig,
        run_id: int,
        *,
        use_cache: bool = False,
        parallelism: Optional[int] = None,
        schedule: str = "critical_path",
        streaming: Optional[bool] = None,
    ) -> Dict[str, Any]:
        # 2. code intelligence: logical plan pinned to the base commit
        tables_at_base = self.catalog.get_commit(base_commit).tables
        schemas = {}
        snapshots: Dict[str, Snapshot] = {}
        for name in pipeline.external_sources():
            if name not in tables_at_base:
                raise KeyError(
                    f"pipeline references table {name!r} missing at commit "
                    f"{base_commit[:12]} on branch {branch!r}"
                )
            snap = self.fmt.load_snapshot(tables_at_base[name])
            snapshots[name] = snap
            schemas[name] = snap.schema
        logical = build_logical_plan(pipeline, external_schemas=schemas)
        ctx = RunContext(branch, run_id, params)
        # sharding-invariant input identity: a compaction rewrite changes
        # snapshot ids but not content, so fingerprints key on the content
        # hash (memoized per snapshot — only the first run pays the scan)
        input_fps = (
            {
                name: self.fmt.content_fingerprint(snap)
                for name, snap in snapshots.items()
            }
            if use_cache
            else None
        )
        cache_view = CacheView(self.cache_registry) if use_cache else None
        plan = build_physical_plan(
            logical, snapshots, config=config, ctx=ctx,
            cache=cache_view, input_fingerprints=input_fps,
            device=self.device,
        )
        log.info("\n%s", plan.describe())

        # 3. transform: execute stages through the serverless executor —
        # the planner already cut every cache-satisfied node out of them
        env: Dict[str, Columnar] = {}  # device-resident artifacts (locality)
        artifacts: Dict[str, str] = {}
        checks: Dict[str, bool] = {}
        bytes_saved = 0
        new_entries: Dict[str, NodeCacheEntry] = {}
        bytes_before = self.fmt.store.stats.snapshot()

        # 3a. rehydrate cache-satisfied nodes: commit their cached manifest
        # keys to the ephemeral branch (contract outputs stay queryable and
        # executing stages read restored inputs back on demand) and report
        # their audited verdicts.  Expectations were audited when the entry
        # was created — same code, same data, same verdict (4.4.1).
        rehydrate_updates: Dict[str, str] = {}
        t_rehydrate = time.perf_counter()
        ts_rehydrate = time.time()
        for name in plan.rehydrate:
            entry = plan.cached_nodes[name]
            key = entry.outputs[name]
            artifacts[name] = key
            rehydrate_updates[name] = key
            bytes_saved += entry.output_bytes
            self.fmt.store.record_cache_hit(entry.output_bytes)
            # bump the entry's LRU clock so eviction favours cold ones.
            # Deliberately re-fetch instead of passing the in-hand entry:
            # entries staged by a legacy adoption are not persisted until
            # the audit passes, and touch() must not write them early.
            self.cache_registry.touch(entry.fingerprint)
        for cname in plan.cached_checks:
            checks[cname] = True
            self.cache_registry.touch(plan.cached_nodes[cname].fingerprint)
        if rehydrate_updates:
            self.catalog.commit(
                ephemeral, rehydrate_updates,
                message=f"run {run_id}: rehydrated "
                        f"{sorted(rehydrate_updates)} from node cache",
                author="runner",
            )
            log.info(
                "cache: rehydrated %d artifact(s), skipped %d audited "
                "check(s), elided %d node(s)",
                len(rehydrate_updates), len(plan.cached_checks),
                len(plan.elided),
            )
        if self.bus is not None:
            # plan-time cache verdicts, one event per logical node.  Hit
            # events for every cache-satisfied node (rehydrated, elided or
            # audited-check); rehydrated artifacts additionally get a
            # timed rehydrate span covering the manifest re-commit.
            rehydrate_s = time.perf_counter() - t_rehydrate
            for name in sorted(plan.cached_nodes):
                entry = plan.cached_nodes[name]
                self._publish(NodeCacheHit(
                    run_id=run_id, node=name, fingerprint=entry.fingerprint,
                    rehydrated=name in rehydrate_updates,
                    bytes=entry.output_bytes,
                ))
            for name in sorted(rehydrate_updates):
                self._publish(NodeCacheRehydrated(
                    run_id=run_id, ts=ts_rehydrate, node=name,
                    bytes=plan.cached_nodes[name].output_bytes,
                    dur_s=rehydrate_s,
                ))
            if use_cache:
                for stage in plan.stages:
                    for name in stage.node_names:
                        self._publish(NodeCacheMiss(
                            run_id=run_id, node=name,
                            fingerprint=plan.node_fingerprints.get(name, ""),
                            stage_id=stage.stage_id,
                        ))

        # 3b. wave/eager scheduling (Scheduler v2): every stage whose
        # parent stages are satisfied is submitted to the executor's stage
        # lane; completions (or, under streaming, outputs-ready) unblock
        # dependents immediately — no barrier between waves.  Shared run
        # state (env, artifacts, checks, cache candidates, counters) is
        # guarded by ``state_lock``; catalog commits are funneled through
        # ``pending_commits`` and applied in stage-id order, so the
        # ephemeral branch's history is linear and identical to a
        # sequential run's, whatever order stages actually finish in.
        use_streaming = (
            (schedule == "critical_path") if streaming is None else bool(streaming)
        )
        # per-stage runtime estimates + longest-path-to-sink weights: the
        # latencyhist medians the Client seeded into the executor win;
        # never-seen stages fall back to the bytes-scanned heuristic
        costs = estimate_stage_costs(
            plan.stages, pipeline.name, self.executor.latency_medians()
        )
        cfg = self.executor.config
        if parallelism is not None:
            # an explicit per-run parallelism pins the in-flight count in
            # either mode (the parity matrix isolates ordering/streaming
            # at a fixed level this way)
            workers = max(1, parallelism)
        elif schedule == "critical_path" and cfg.memory_budget_gb is not None:
            # memory-capped admission supersedes the flat stage count —
            # the count backstop is only the stage lane's thread capacity
            workers = max(cfg.max_concurrent_stages, 32)
        else:
            workers = max(1, cfg.max_concurrent_stages)
        mem_budget = (
            cfg.memory_budget_gb if schedule == "critical_path" else None
        )
        state_lock = threading.Lock()
        counters = {"stages_executed": 0}
        pending_commits: Dict[int, Dict[str, Optional[str]]] = {}
        next_commit = [0]
        # perf_counter at submit time, keyed by stage id — queue latency is
        # StageStarted - StageQueued, reported per stage in run stats
        queued_at: Dict[int, float] = {}
        stage_timings: Dict[int, Dict[str, float]] = {}

        def flush_commits_locked() -> None:
            # called with state_lock held: drain the contiguous prefix of
            # completed stages (the commit queue's epoch advance)
            while next_commit[0] in pending_commits:
                sid = next_commit[0]
                updates = pending_commits.pop(sid)
                t0 = time.perf_counter()
                if updates:
                    self.catalog.commit(
                        ephemeral, updates,
                        message=f"run {run_id} stage {sid}",
                        author="runner",
                    )
                commit_s = time.perf_counter() - t0
                stage_timings.setdefault(sid, {})["commit_s"] = commit_s
                self._publish(StageCommitted(
                    run_id=run_id, stage_id=sid,
                    tables=sorted(updates), commit_s=commit_s,
                ))
                next_commit[0] += 1

        def run_stage(stage) -> None:
            t_exec = time.perf_counter()
            queue_s = t_exec - queued_at.get(stage.stage_id, t_exec)
            self._publish(StageStarted(run_id=run_id, stage_id=stage.stage_id))
            scan_tags = {"run_id": run_id, "stage_id": stage.stage_id}
            inputs: List[Columnar] = []
            for table in sorted(stage.scans):
                # streaming mode drives the scan through the incremental
                # shard iterator (bounded read-ahead window) — chunking and
                # shard order are shared with the barrier path, so the
                # concatenated input is byte-identical either way
                data = execute_scan(
                    self.fmt, stage.scans[table].plan,
                    pool=self.executor.io_pool,
                    bus=self.bus, tags=dict(scan_tags, table=table),
                    streaming=use_streaming,
                )
                inputs.append(Columnar.from_numpy(data, device=self.device))
            for name in stage.internal_inputs:
                with state_lock:  # data locality: reuse in-memory artifact
                    rel = env.get(name)
                if rel is None:  # fallback: read from the ephemeral branch
                    key = self.catalog.table_key(name, branch=ephemeral)
                    rel = Columnar.from_numpy(
                        self.fmt.read(self.fmt.load_snapshot(key)),
                        device=self.device,
                    )
                inputs.append(rel)
            # one construction site (physical.stage_function_spec) for the
            # dispatch spec — the scheduler's cost lookup and the executor's
            # latency history key the same fingerprint by definition
            spec = stage_function_spec(pipeline.name, stage)
            outputs, stage_checks = self.executor.run(
                spec, *inputs, tags=scan_tags
            )
            if use_streaming:
                # streaming handoff: publish in-memory outputs and unblock
                # dependent stages NOW, before artifact writes land —
                # downstream stages consume completed upstream results
                # while this stage's store I/O is still in flight.  The
                # stage barrier is retained where it matters: audits and
                # catalog commits still drain in stage-id order below.
                with state_lock:
                    for name, rel in outputs.items():
                        env[name] = rel
                outputs_ready(stage.stage_id)
            # store I/O (artifact writes) runs outside the state lock so
            # concurrent stages overlap their writes; only the publication
            # of results + the ordered commit drain is serialized
            updates: Dict[str, Optional[str]] = {}
            node_bytes: Dict[str, int] = {}
            written: Dict[str, Any] = {}
            for name, rel in outputs.items():
                compact = rel.to_numpy(compact=True)
                node_bytes[name] = sum(arr.nbytes for arr in compact.values())
                schema = Schema(
                    tuple(
                        Column(c, str(compact[c].dtype)) for c in sorted(compact)
                    )
                )
                snap = self.fmt.write(name, schema, compact)
                key = self.fmt.manifest_key(snap)
                updates[name] = key
                written[name] = (rel, key)
            now = time.time()
            exec_s = time.perf_counter() - t_exec
            # predicted-vs-actual: the scheduling estimate against the full
            # driver span (scan → execute → write) — persisted to the
            # latencyhist namespace alongside the self-correcting medians
            self.executor.record_forecast(
                spec.fingerprint, costs[stage.stage_id].est_s, exec_s
            )
            self._publish(StageFinished(
                run_id=run_id, stage_id=stage.stage_id, exec_s=exec_s,
                outputs=sorted(outputs), checks=sorted(stage_checks),
            ))
            with state_lock:
                counters["stages_executed"] += 1
                stage_timings.setdefault(stage.stage_id, {}).update(
                    queue_s=queue_s, exec_s=exec_s
                )
                for name, (rel, key) in written.items():
                    env[name] = rel
                    artifacts[name] = key
                this_stage_checks: Dict[str, bool] = {}
                for cname, val in stage_checks.items():
                    # a 0-d tensor on the runner's device (or a Python
                    # bool): bool() reads it back, where np.asarray would
                    # refuse a CUDA tensor
                    verdict = bool(val)
                    checks[cname] = verdict
                    this_stage_checks[cname] = verdict
                if use_cache:
                    # candidate node entries — persisted by run() only if
                    # the audit passes (failed audits must not poison
                    # future runs).  One entry per materialized artifact
                    # and one per evaluated expectation, keyed by the
                    # fusion-independent node fingerprint, so any future
                    # plan shape can reuse them.
                    for name in stage.outputs:
                        fp = plan.node_fingerprints[name]
                        new_entries[fp] = NodeCacheEntry(
                            fingerprint=fp,
                            outputs={name: artifacts[name]},
                            checks={},
                            output_bytes=node_bytes.get(name, 0),
                            run_id=run_id,
                            created_at=now,
                            node=name,
                        )
                    for cname, verdict in this_stage_checks.items():
                        fp = plan.node_fingerprints[cname]
                        new_entries[fp] = NodeCacheEntry(
                            fingerprint=fp,
                            outputs={},
                            checks={cname: verdict},
                            output_bytes=0,
                            run_id=run_id,
                            created_at=now,
                            node=cname,
                        )
                pending_commits[stage.stage_id] = updates
                flush_commits_locked()

        stage_by_id = {s.stage_id: s for s in plan.stages}
        deps = {s.stage_id: set(s.parent_stages) for s in plan.stages}
        dependents: Dict[int, List[int]] = {}
        for s in plan.stages:
            for p in s.parent_stages:
                dependents.setdefault(p, []).append(s.stage_id)

        # The ready set is a min-heap whose key is the ordering mode:
        #   critical_path — (-cp_weight_s, stage_id): the stage heading the
        #       longest remaining cost-weighted path to a sink dispatches
        #       first; stage id is the deterministic tie-break.
        #   stage_id — ascending stage id, the original wave baseline: at
        #       parallelism 1 this degenerates to exactly the old
        #       sequential stage loop (the determinism-parity anchor).
        # Either way the knob changes dispatch ORDER only — artifacts,
        # checks and cache entries are byte-identical across modes.
        if schedule == "critical_path":
            def ready_key(sid: int) -> Tuple[float, int]:
                return (-costs[sid].cp_weight_s, sid)
        else:
            def ready_key(sid: int) -> Tuple[float, int]:
                return (0.0, sid)

        # Scheduler state below is guarded by ``cond``.  An RLock backs it
        # because a done-callback can fire inline on the submitting thread
        # (future already finished) while admit_locked still holds the
        # lock — a plain Lock would deadlock there.
        cond = threading.Condition(threading.RLock())
        ready: List[Tuple[Tuple[float, int], int]] = []
        ready_at: Dict[int, float] = {}
        unblocked: Set[int] = set()
        in_flight: Dict[int, Future] = {}
        inflight_mem = [0.0]
        failures: Dict[int, BaseException] = {}
        sched_stats: Dict[int, Dict[str, Any]] = {}

        def unblock_locked(sid: int) -> None:
            # idempotent: streaming fires this at outputs-ready AND the
            # done-callback fires it again when the driver future resolves
            if sid in unblocked:
                return
            unblocked.add(sid)
            for child in dependents.get(sid, ()):
                deps[child].discard(sid)
                if not deps[child]:
                    ready_at[child] = time.perf_counter()
                    heapq.heappush(ready, (ready_key(child), child))

        def outputs_ready(sid: int) -> None:
            # streaming handoff entry point (called from stage drivers)
            with cond:
                unblock_locked(sid)
                cond.notify_all()

        def on_stage_done(sid: int, fut: Future) -> None:
            with cond:
                err = fut.exception()
                if err is not None:
                    # stop scheduling, drain in-flight stages, then raise
                    failures[sid] = err
                else:
                    unblock_locked(sid)
                in_flight.pop(sid, None)
                inflight_mem[0] -= costs[sid].est_memory_gb
                cond.notify_all()

        def admit_locked() -> None:
            while ready and len(in_flight) < workers and not failures:
                _, sid = ready[0]
                cost = costs[sid]
                if (
                    mem_budget is not None
                    and in_flight
                    and inflight_mem[0] + cost.est_memory_gb > mem_budget
                ):
                    # memory-capped admission with head-of-line blocking:
                    # the most critical ready stage never loses its slot to
                    # a smaller one behind it (bypass could co-schedule two
                    # huge stages the moment the big head admits).  An
                    # empty in_flight always admits — no deadlock when one
                    # stage alone exceeds the budget.
                    sched_stats.setdefault(sid, {})["admission"] = "waited"
                    break
                heapq.heappop(ready)
                t_admit = time.perf_counter()
                wait_s = t_admit - ready_at.get(sid, t_admit)
                inflight_mem[0] += cost.est_memory_gb
                queued_at[sid] = t_admit
                stage = stage_by_id[sid]
                spec = stage_function_spec(pipeline.name, stage)
                warm = self.executor.warm_ready(spec)
                admission = (
                    "waited"
                    if sched_stats.get(sid, {}).get("admission") == "waited"
                    else "immediate"
                )
                sched_stats[sid] = {
                    "est_s": cost.est_s,
                    "source": cost.source,
                    "cp_weight_s": cost.cp_weight_s,
                    "cp_rank": cost.cp_rank,
                    "est_memory_gb": cost.est_memory_gb,
                    "admission_wait_s": wait_s,
                    "admission": admission,
                    "warm": warm,
                }
                self._publish(StageScheduled(
                    run_id=run_id, stage_id=sid,
                    est_cost_s=cost.est_s, cost_source=cost.source,
                    cp_weight_s=cost.cp_weight_s, cp_rank=cost.cp_rank,
                    est_memory_gb=cost.est_memory_gb,
                    admission_wait_s=wait_s, admission=admission,
                    schedule=schedule, streaming=use_streaming, warm=warm,
                ))
                self._publish(StageQueued(
                    run_id=run_id, stage_id=sid,
                    nodes=list(stage.node_names),
                    parents=sorted(stage.parent_stages),
                ))
                fut = self.executor.submit_stage(run_stage, stage)
                in_flight[sid] = fut
                fut.add_done_callback(
                    lambda f, sid=sid: on_stage_done(sid, f)
                )

        with cond:
            for s in plan.stages:
                if not deps[s.stage_id]:
                    ready_at[s.stage_id] = time.perf_counter()
                    heapq.heappush(ready, (ready_key(s.stage_id), s.stage_id))
            admit_locked()
            while in_flight or (ready and not failures):
                # timeout is a liveness backstop only — done-callbacks and
                # outputs_ready notify the loop on every state change
                cond.wait(timeout=0.1)
                admit_locked()
        if failures:
            # deterministic surfacing: raise the lowest failed stage id —
            # what the sequential loop would have hit first
            raise failures[min(failures)]
        stages_executed = counters["stages_executed"]
        bytes_after = self.fmt.store.stats.snapshot()
        # cache_* counters are run-level telemetry (reported under "cache")
        # and gc_*/compact_* belong to the lakekeeper, not bytes moved by
        # this run — keep the io dict strictly I/O
        io_delta = {
            k: bytes_after[k] - bytes_before[k]
            for k in bytes_after
            if not k.startswith(("cache_", "gc_", "compact_"))
        }
        return {
            "plan": plan,
            "artifacts": artifacts,
            "checks": checks,
            "io": io_delta,
            "parallelism": workers,
            "scheduler": {
                "schedule": schedule,
                "streaming": use_streaming,
                "memory_budget_gb": mem_budget,
                "workers": workers,
                "admission_waits": sum(
                    1 for s in sched_stats.values()
                    if s.get("admission") == "waited"
                ),
                # str keys: JSON-roundtrips through the run record
                "stages": {
                    str(sid): dict(s) for sid, s in sorted(sched_stats.items())
                },
                # the model's predicted critical path (stage ids, source →
                # sink) — same longest-path implementation `repro trace`
                # uses on observed latencies
                "critical_path": critical_path_ids(
                    {s.stage_id: costs[s.stage_id].est_s for s in plan.stages},
                    {s.stage_id: s.parent_stages for s in plan.stages},
                ),
            },
            # per-stage queue/exec/commit seconds (str keys: JSON-roundtrips
            # through the run record for `repro run --json`)
            "stage_timings": {
                str(sid): {
                    "queue_s": t.get("queue_s", 0.0),
                    "exec_s": t.get("exec_s", 0.0),
                    "commit_s": t.get("commit_s", 0.0),
                }
                for sid, t in sorted(stage_timings.items())
            },
            "cache": {
                "enabled": use_cache,
                # node-granular hit accounting: every cache-satisfied
                # logical node counts, whether rehydrated or elided
                "hits": len(plan.cached_nodes),
                "nodes_executed": plan.nodes_executed,
                "stages_executed": stages_executed,
                "rehydrated": len(plan.rehydrate),
                "elided": len(plan.elided),
                "bytes_saved": bytes_saved,
                "entries": new_entries,
                "view": cache_view,
            },
        }

    def _record(
        self,
        run_id: int,
        pipeline: Pipeline,
        branch: str,
        base_commit: str,
        params: Dict[str, Any],
        result: Dict[str, Any],
        *,
        merged: Optional[str],
        t_start: float,
    ) -> RunRecord:
        cache = result["cache"]
        rec = RunRecord(
            run_id=run_id,
            pipeline_name=pipeline.name,
            pipeline_fingerprint=pipeline.fingerprint,
            branch=branch,
            base_commit=base_commit,
            params=params,
            artifacts=result["artifacts"],
            checks=result["checks"],
            merged_commit=merged,
            fused=result["plan"].config.fusion,
            stats={
                "wall_s": time.perf_counter() - t_start,
                "stages": len(result["plan"].stages),
                "stages_executed": cache["stages_executed"],
                "parallelism": result.get("parallelism", 1),
                "scheduler": result.get("scheduler", {}),
                "stage_timings": result.get("stage_timings", {}),
                "io": result["io"],
                "executor": self.executor.stats(),
                "cache": {
                    "enabled": cache["enabled"],
                    "hits": cache["hits"],
                    "nodes_executed": cache["nodes_executed"],
                    "stages_executed": cache["stages_executed"],
                    "rehydrated": cache["rehydrated"],
                    "elided": cache["elided"],
                    "bytes_saved": cache["bytes_saved"],
                },
            },
            created_at=time.time(),
            # only audited (merged) runs publish entries; record what we did
            stage_cache={
                fp: dict(e.outputs) for fp, e in cache["entries"].items()
            } if merged is not None else {},
        )
        self.registry.record(rec)
        return rec
