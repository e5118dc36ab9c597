"""Physical planner: fusion + scan pushdown (the paper's 4.4.2 optimization).

The first Bauplan version mapped the logical plan isomorphically — one
(serverless, stateless) function per node, every intermediate spilled to
object storage.  The optimized planner instead:

1. **pushes filters down** into the scan (shard pruning via min/max stats
   + residual row filter), so the in-memory table starts small;
2. **fuses** chains of nodes into a single stage executed as ONE function
   on device-resident tensors — SQL logic and Python expectations run in
   place on the card, nothing round-trips through the store.  Where the
   JAX package traces a stage into one XLA program, the port runs the
   stage's operators eagerly, one after another, on the runner's device;
   a SQL node that the route sends to the kernel launches
   ``kernels/fused_filter_agg`` from inside the stage.

Both behaviours are switchable (``PlannerConfig``) because the naive plan
is the baseline the paper's 5x claim is measured against.

The planner is also **cache-aware** (the FaaS-and-Furious differential
cache, re-keyed at node granularity): every logical node gets a
*transitive fingerprint* — node code + upstream node fingerprints +
input table content hashes + run params — that is independent of how
nodes are fused into stages.  Given a ``CacheView``, the planner cuts
fused chains at cache boundaries: nodes the cache satisfies become
rehydrations (or are elided outright when nothing downstream needs
them), and stages are built only over the uncached remainder.  A fusion
config flip therefore re-plans *around* the warm cache instead of
invalidating it.  Node and stage fingerprints hash no code of this
module, so they equal the JAX package's for the same pipeline and data.

The interactive query path (``plan_interactive_query``) shares the
pushdown split and the per-table column projection with stage planning.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.logical import LogicalPlan
from repro_torch.core.pipeline import Node
from repro_torch.core.snapshot import CacheView, NodeCacheEntry
from repro_torch.engine.columnar import Columnar
from repro_torch.engine.exec import execute_query
from repro_torch.engine.expr import Expr
from repro_torch.engine.query import Query
from repro_torch.engine.route import RouteDecision, column_stats_for_query, plan_route
from repro_torch.runtime.function import FunctionSpec
from repro_torch.runtime.resources import CostModel, ResourceRequest
from repro_torch.table.format import Snapshot
from repro_torch.table.scan import Predicate, ScanPlan, plan_scan
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.hashing import stable_hash


@dataclass(frozen=True)
class PlannerConfig:
    fusion: bool = True
    pushdown: bool = True
    #: cap on fused nodes per stage (very long chains recompile slowly)
    max_stage_nodes: int = 32
    #: SQL execution engine: "auto" routes eligible filter+group+agg
    #: pipelines through kernels/fused_filter_agg when byte-identity with
    #: the jnp path is provable from shard statistics (engine/route.py),
    #: "kernel" forces it, "jnp" pins the reference path.  NOT part of
    #: node fingerprints — both paths produce identical artifacts, so
    #: flipping the engine must keep the differential cache warm.
    sql_engine: str = "auto"


@dataclass(frozen=True)
class ScanSpec:
    """One external-table read feeding a stage."""

    table: str
    plan: ScanPlan
    #: bytes that will actually be read after shard/column pruning
    estimated_bytes: int

    @property
    def predicates(self) -> Tuple[Predicate, ...]:
        return self.plan.predicates


@dataclass
class Stage:
    stage_id: int
    node_names: Tuple[str, ...]
    scans: Dict[str, ScanSpec]
    internal_inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    checks: Tuple[str, ...]
    fn: Callable[..., Tuple[Dict[str, Columnar], Dict[str, Any]]]
    resources: ResourceRequest
    fingerprint: str
    #: stage-level transitive identity (node code + upstream stage
    #: fingerprints + input table snapshot ids + run params).  This is the
    #: *legacy* (stage-keyed) differential-cache key — new entries are keyed by
    #: per-node fingerprints (``PhysicalPlan.node_fingerprints``) — kept so
    #: stage-keyed entries written by old lakes can still be matched and
    #: upgraded (``CacheView.adopt_legacy``).
    transitive_fingerprint: str = ""
    #: stage ids whose outputs feed this stage — the dependency edges the
    #: wave scheduler walks (always lower than this stage's id; restored
    #: cache inputs are not edges, they are committed before any stage runs)
    parent_stages: Tuple[int, ...] = ()
    #: per-SQL-node engine decisions (engine/route.py) — observability
    #: only, deliberately excluded from every fingerprint
    sql_routes: Dict[str, RouteDecision] = field(default_factory=dict)

    @property
    def input_order(self) -> Tuple[str, ...]:
        """Stage fn positional args: scans first (sorted), then internals."""
        return tuple(sorted(self.scans)) + self.internal_inputs


@dataclass
class PhysicalPlan:
    logical: LogicalPlan
    config: PlannerConfig
    stages: List[Stage]
    #: logical node name -> transitive node fingerprint (the cache key,
    #: independent of fusion grouping)
    node_fingerprints: Dict[str, str] = field(default_factory=dict)
    #: nodes the cache satisfied at plan time: name -> entry
    cached_nodes: Dict[str, NodeCacheEntry] = field(default_factory=dict)
    #: cache-satisfied artifacts the runner must restore (commit their
    #: cached manifest keys): contract outputs, inputs of executing
    #: stages, and same-config materialization points
    rehydrate: Tuple[str, ...] = ()
    #: cache-satisfied expectations — verdict True recorded at audit time,
    #: reported without re-evaluation
    cached_checks: Tuple[str, ...] = ()
    #: nodes neither executed nor rehydrated: nothing downstream of them
    #: needs their value this run (the fusion-flip win).  Contract outputs
    #: are never elided; an interior materialization the current config
    #: would have produced cold can be (see build_physical_plan)
    elided: Tuple[str, ...] = ()

    @property
    def num_materializations(self) -> int:
        return sum(len(s.outputs) for s in self.stages)

    @property
    def nodes_executed(self) -> int:
        """Logical nodes this plan actually computes (cache hits excluded)."""
        return sum(len(s.node_names) for s in self.stages)

    def describe(self) -> str:
        lines = [f"physical plan ({'fused' if self.config.fusion else 'isomorphic'}):"]
        for s in self.stages:
            scans = {
                t: f"{spec.plan.rows_to_read} rows"
                f" (-{spec.plan.pruned_shards} shards)"
                for t, spec in s.scans.items()
            }
            lines.append(
                f"  stage {s.stage_id}: nodes={list(s.node_names)} scans={scans} "
                f"inputs={list(s.internal_inputs)} outputs={list(s.outputs)} "
                f"checks={list(s.checks)} mem={s.resources.memory_gb}GB"
            )
        if self.cached_nodes:
            lines.append(
                f"  cache: rehydrate={list(self.rehydrate)} "
                f"checks={list(self.cached_checks)} elided={list(self.elided)}"
            )
        return "\n".join(lines)


def _ensure_columnar(value: Any, node_name: str, device: DeviceLike) -> Columnar:
    if isinstance(value, Columnar):
        return value
    if isinstance(value, dict):
        return Columnar.from_arrays(value, device=device)
    raise TypeError(
        f"python node {node_name!r} must return a Columnar or a dict of "
        f"columns, got {type(value)}"
    )


def _make_stage_fn(
    ordered_nodes: Sequence[Node],
    rewrites: Dict[str, Query],
    input_order: Sequence[str],
    outputs: Sequence[str],
    ctx: Any,
    routes: Optional[Dict[str, RouteDecision]] = None,
    device: DeviceLike = None,
) -> Callable:
    """Compose stage nodes into one pure function over device tensors.

    A python node may return a dict of columns (tensors or numpy arrays);
    it becomes a ``Columnar`` on ``device``, the runner's device (None
    means ``cuda``), so every relation of a stage lives on one device."""
    routes = routes or {}

    def stage_fn(*inputs: Columnar):
        env: Dict[str, Columnar] = dict(zip(input_order, inputs))
        checks: Dict[str, Any] = {}
        for node in ordered_nodes:
            if node.kind == "sql":
                query = rewrites.get(node.name, node.query)
                joined = {j.table: env[j.table] for j in query.joins}
                env[node.name] = execute_query(
                    query,
                    env[query.source],
                    joined=joined or None,
                    route=routes.get(node.name),
                )
            elif node.kind == "python":
                out = node.fn(ctx, *[env[p] for p in node.parents])
                env[node.name] = _ensure_columnar(out, node.name, device)
            else:  # expectation — returns a boolean (0-d tensor or bool)
                checks[node.name] = node.fn(ctx, *[env[p] for p in node.parents])
        return {name: env[name] for name in outputs}, checks

    return stage_fn


def _split_primary_pushdown(
    query: Query, snapshots: Dict[str, Snapshot]
) -> Tuple[List[Predicate], Optional[Expr]]:
    """Filter conjuncts pushable into the FROM table's scan, plus residual.

    Only predicates provably over the *primary* table are pushed: pushing
    into a joined table could change which duplicate-key row wins the
    first-match gather, and an unqualified column is attributed to the
    primary only when no (known) join table also owns the name.  Pushed
    predicates are re-keyed to the plain column name the shard stats use.
    """
    conjuncts = query.filter_expr._flatten_and()
    primary_qual = query.source_alias or query.source
    psnap = snapshots.get(query.source)
    primary_cols = set(psnap.schema.names) if psnap else set()
    join_cols: set = set()
    unknown_join = False
    for j in query.joins:
        s = snapshots.get(j.table)
        if s is None:
            unknown_join = True  # node-sourced join: columns unknowable here
        else:
            join_cols.update(s.schema.names)

    pushed: List[Predicate] = []
    residual: List[Expr] = []
    for c in conjuncts:
        p = c._as_simple_predicate()
        tail: Optional[str] = None
        if p is not None:
            if "." in p.column:
                qual, t = p.column.split(".", 1)
                if qual == primary_qual and t in primary_cols:
                    tail = t
            elif p.column in primary_cols and (
                not query.joins or (not unknown_join and p.column not in join_cols)
            ):
                tail = p.column
        if tail is not None:
            pushed.append(Predicate(tail, p.op, p.value))
        else:
            residual.append(c)
    res: Optional[Expr] = None
    for r in residual:
        res = r if res is None else Expr("and", (res, r))
    return pushed, res


def _columns_for_table(
    query: Query, table: str, snapshot: Snapshot
) -> Optional[List[str]]:
    """The (plain-named) columns of ``table`` the query touches.

    None means "read everything" — the SELECT * case.  Ambiguous plain
    references load the name from every owning table; the executor's
    combined relation then reports the ambiguity on use."""
    if not (query.projections or query.is_aggregation):
        return None
    names = set(snapshot.schema.names)
    quals = {q for q, t in query.qualifiers() if t == table}
    out: List[str] = []
    for r in query.referenced_columns():
        if "." in r:
            qual, tail = r.split(".", 1)
            if qual in quals and tail in names:
                out.append(tail)
        elif r in names:
            out.append(r)
    # pure COUNT(*): still need one column to carry the row count
    return list(dict.fromkeys(out)) or [snapshot.schema.names[0]]


@dataclass(frozen=True)
class InteractiveQueryPlan:
    """Everything the interactive query path decides before touching data.

    One shared planning artifact behind both ``Runner.query`` (which
    executes it) and ``repro explain`` (which only describes it) — the
    static route verdict agrees with the runtime decision *by
    construction*, because both read this object.
    """

    query: Query
    #: filter conjuncts pushed into the FROM table's scan
    pushed: Tuple[Predicate, ...]
    #: filter remainder evaluated by the engine (None = fully pushed)
    residual: Optional[Expr]
    #: folded shard statistics that grounded the route decision
    stats: Dict[str, Tuple[int, int]]
    total_rows: Optional[int]
    route: "RouteDecision"
    #: per-table scan plans (column projection + shard pruning applied)
    scans: Dict[str, ScanPlan]


def resolve_query_snapshots(
    catalog: Any,
    fmt: Any,
    query: Query,
    *,
    branch: Optional[str] = None,
    commit_id: Optional[str] = None,
    text: Optional[str] = None,
) -> Dict[str, Snapshot]:
    """Zero-registration name resolution: every FROM/JOIN table against
    the catalog, unknown names surfacing as positioned SqlErrors."""
    from repro_torch.catalog.nessie import CatalogError
    from repro_torch.engine.sql import SqlError, find_token

    text = text if text is not None else (query.raw_sql or "")
    snapshots: Dict[str, Snapshot] = {}
    for table in query.source_tables():
        try:
            key = catalog.table_key(table, branch=branch, commit_id=commit_id)
            snapshots[table] = fmt.load_snapshot(key)
        except CatalogError as e:
            raise SqlError(
                f"unknown table {table!r} ({e})", text,
                find_token(text, table) or 0,
            ) from e
    return snapshots


def plan_interactive_query(
    query: Query,
    snapshots: Dict[str, Snapshot],
    *,
    engine: str = "auto",
) -> InteractiveQueryPlan:
    """Plan one interactive query: pushdown split, stats fold, engine
    route, and per-table scan plans.  Pure function of the query and the
    resolved snapshots — no data is read, nothing is written, so the
    explain plane can call it as-is.  Raises :class:`RouteError` when
    ``engine='kernel'`` is forced on an ineligible query, exactly as the
    execution path would."""
    pushed, residual = (
        _split_primary_pushdown(query, snapshots)
        if query.filter_expr is not None
        else ([], None)
    )
    stats, total_rows = column_stats_for_query(query, snapshots)
    route = plan_route(
        query, engine=engine, stats=stats, total_rows=total_rows
    )
    scans = {
        table: plan_scan(
            snapshots[table],
            columns=_columns_for_table(query, table, snapshots[table]),
            predicates=tuple(pushed) if table == query.source else (),
        )
        for table in query.source_tables()
    }
    return InteractiveQueryPlan(
        query=query,
        pushed=tuple(pushed),
        residual=residual,
        stats=stats,
        total_rows=total_rows,
        route=route,
        scans=scans,
    )


def _scan_bytes(plan: ScanPlan) -> int:
    row_bytes = sum(
        np.dtype(plan.snapshot.schema.dtype_of(c)).itemsize for c in plan.columns
    )
    return plan.rows_to_read * row_bytes


def compute_node_fingerprints(
    logical: LogicalPlan,
    input_fingerprints: Dict[str, str],
    run_params: Dict[str, Any],
    *,
    edited_node: Optional[str] = None,
) -> Dict[str, str]:
    """Per-node transitive identity, independent of fusion grouping.

    ``node code + upstream node fingerprints + input table identities +
    run params`` — two nodes with equal transitive fingerprints produce
    bit-identical outputs, so a cached result can substitute for
    execution regardless of how either plan grouped nodes into stages.
    ``input_fingerprints`` should be sharding-invariant content hashes
    (``TableFormat.content_fingerprint``) so compaction doesn't bust the
    cache; snapshot ids are an acceptable conservative fallback.

    ``edited_node`` salts exactly that node's payload, simulating a code
    edit; the baseline hashing path is byte-identical when it is unset
    (the payload only gains a key for the salted node).  The lint pass
    uses this to compute cache-invalidation blast radii.
    """
    fps: Dict[str, str] = {}
    for name in logical.order:
        node = logical.nodes[name]
        parents: Dict[str, str] = {}
        scans: Dict[str, str] = {}
        for p in node.parents:
            if p in logical.nodes:
                parents[p] = fps[p]
            else:
                scans[p] = input_fingerprints[p]
        payload = {
            "node": node.fingerprint,
            "parents": parents,
            "scans": scans,
            "params": run_params,
        }
        if name == edited_node:
            payload["edited"] = True
        fps[name] = stable_hash(payload)
    return fps


def fingerprint_blast_radius(
    logical: LogicalPlan,
    input_fingerprints: Optional[Dict[str, str]] = None,
    run_params: Optional[Dict[str, Any]] = None,
) -> Dict[str, List[str]]:
    """For every node: the downstream nodes whose transitive fingerprint
    changes when that node's code is edited — i.e. the differential
    cache's invalidation set.  Pure hash arithmetic, no I/O: the actual
    input fingerprints don't matter for *which* hashes move, only that
    they are fixed across the comparison, so dummy values are fine.
    """
    inputs = dict(input_fingerprints or {})
    for name in logical.order:
        for p in logical.nodes[name].parents:
            if p not in logical.nodes:
                inputs.setdefault(p, f"radius:{p}")
    params = run_params or {}
    baseline = compute_node_fingerprints(logical, inputs, params)
    radius: Dict[str, List[str]] = {}
    for name in logical.order:
        perturbed = compute_node_fingerprints(
            logical, inputs, params, edited_node=name
        )
        radius[name] = [
            n for n in logical.order
            if n != name and perturbed[n] != baseline[n]
        ]
    return radius


def _greedy_stages(
    logical: LogicalPlan,
    config: PlannerConfig,
    names: Sequence[str],
) -> Tuple[List[List[str]], Dict[str, int], Dict[str, int]]:
    """Greedy fusion grouping over ``names`` (topological subsequence of
    ``logical.order``): a node joins the stage that produced ALL its
    in-subset parents (expectations likewise); otherwise it opens a new
    stage.  Parents outside the subset — external tables, cache-restored
    artifacts — are boundaries, which is exactly how a fused chain gets
    cut at a cache hit: the cached prefix is absent from ``names`` and the
    uncached suffix starts a fresh (shorter) stage."""
    node_stage: Dict[str, int] = {}
    stage_nodes: List[List[str]] = []
    produced_in: Dict[str, int] = {}
    for name in names:
        node = logical.nodes[name]
        internal_parents = [p for p in node.parents if p in produced_in]
        target: Optional[int] = None
        if config.fusion and internal_parents:
            parent_stages = {produced_in[p] for p in internal_parents}
            if len(parent_stages) == 1:
                cand = parent_stages.pop()
                if len(stage_nodes[cand]) < config.max_stage_nodes:
                    target = cand
        # (fusion disabled → target stays None → every node its own stage,
        #  expectations included: the paper's "three separate executions")
        if target is None:
            stage_nodes.append([])
            target = len(stage_nodes) - 1
        stage_nodes[target].append(name)
        node_stage[name] = target
        if not node.is_expectation:
            produced_in[name] = target
    return stage_nodes, node_stage, produced_in


def _stage_outputs(
    logical: LogicalPlan,
    stage_nodes: List[List[str]],
    node_stage: Dict[str, int],
    produced_in: Dict[str, int],
) -> List[Tuple[str, ...]]:
    """Materialization points of a grouping: artifacts that are contract
    outputs or cross a stage boundary."""
    needed_later: Dict[str, List[int]] = {}
    for names in stage_nodes:
        for name in names:
            for p in logical.nodes[name].parents:
                if p in produced_in and produced_in[p] != node_stage[name]:
                    needed_later.setdefault(p, []).append(node_stage[name])
    outs: List[Tuple[str, ...]] = []
    for names in stage_nodes:
        outs.append(
            tuple(
                n
                for n in names
                if not logical.nodes[n].is_expectation
                and (n in logical.outputs or n in needed_later)
            )
        )
    return outs


def _legacy_stage_fingerprints(
    logical: LogicalPlan,
    snapshots: Dict[str, Snapshot],
    run_params: Dict[str, Any],
    stage_nodes: List[List[str]],
    produced_in: Dict[str, int],
    outputs_per_stage: List[Tuple[str, ...]],
) -> List[str]:
    """The legacy stage-keyed cache fingerprints, byte-for-byte: node code +
    upstream stage fingerprints + input snapshot ids + params.  Only used
    to match (and then upgrade) entries written by pre-node lakes."""
    fps: List[str] = []
    for sid, names in enumerate(stage_nodes):
        scan_tables = sorted(
            {
                p
                for n in names
                for p in logical.nodes[n].parents
                if p not in logical.nodes
            }
        )
        internal_inputs = {
            p
            for n in names
            for p in logical.nodes[n].parents
            if p in produced_in and produced_in[p] != sid
        }
        parent_stages = sorted({produced_in[p] for p in internal_inputs})
        fps.append(
            stable_hash(
                {
                    "nodes": [logical.nodes[n].fingerprint for n in names],
                    "outputs": sorted(outputs_per_stage[sid]),
                    "parents": [fps[p] for p in parent_stages],
                    "scans": {t: snapshots[t].snapshot_id for t in scan_tables},
                    "params": run_params,
                }
            )
        )
    return fps


def _consult_cache(
    cache: CacheView,
    logical: LogicalPlan,
    snapshots: Dict[str, Snapshot],
    run_params: Dict[str, Any],
    node_fp: Dict[str, str],
    natural: List[List[str]],
    nat_produced_in: Dict[str, int],
    nat_outputs: List[Tuple[str, ...]],
) -> Dict[str, NodeCacheEntry]:
    """Which nodes can the cache satisfy?  Node-keyed lookups first; any
    still-unsatisfied natural stage is then matched against legacy
    stage-keyed entries and, on a hit, staged for the one-way upgrade
    into node entries (so the *next* planner change still finds them).
    ``natural``/``nat_produced_in``/``nat_outputs`` describe the
    cache-unaware grouping of the CURRENT config (computed once by
    ``build_physical_plan``) — old lakes warm up as long as the config
    matches what wrote the legacy entry, and the adopted node entries
    are config-proof from then on."""
    satisfied: Dict[str, NodeCacheEntry] = {}
    for name in logical.order:
        node = logical.nodes[name]
        entry = cache.node(node_fp[name])
        if entry is None:
            continue
        if node.is_expectation:
            if entry.checks.get(name, False):
                satisfied[name] = entry
        elif name in entry.outputs:
            satisfied[name] = entry

    produced_in = nat_produced_in
    legacy_fps = _legacy_stage_fingerprints(
        logical, snapshots, run_params, natural, produced_in, nat_outputs
    )
    for sid, names in enumerate(natural):
        checks = [n for n in names if logical.nodes[n].is_expectation]
        missing = [
            n for n in (*nat_outputs[sid], *checks) if n not in satisfied
        ]
        if not missing:
            continue
        legacy = cache.legacy_stage(legacy_fps[sid])
        if legacy is None:
            continue
        if not set(nat_outputs[sid]) <= set(legacy.outputs):
            continue
        if not all(legacy.checks.get(c, False) for c in checks):
            continue
        per_node_bytes = legacy.output_bytes // max(len(nat_outputs[sid]), 1)
        # adopted entries are being used RIGHT NOW — fresh LRU clock, or a
        # TTL prune straight after the upgrade run would evict them (the
        # legacy timestamp can be arbitrarily old); created_at keeps the
        # provenance.  Names a live node entry already satisfies are NOT
        # re-adopted: overwriting would regress their clock and replace
        # accurate output_bytes with the legacy bytes//n estimate.
        now = time.time()
        adopted: List[NodeCacheEntry] = []
        for out in nat_outputs[sid]:
            if out in satisfied:
                continue
            entry = NodeCacheEntry(
                fingerprint=node_fp[out],
                outputs={out: legacy.outputs[out]},
                checks={},
                output_bytes=per_node_bytes,
                run_id=legacy.run_id,
                created_at=legacy.created_at,
                last_used_at=now,
                node=out,
            )
            adopted.append(entry)
            satisfied[out] = entry
        for c in checks:
            if c in satisfied:
                continue
            entry = NodeCacheEntry(
                fingerprint=node_fp[c],
                outputs={},
                checks={c: True},
                output_bytes=0,
                run_id=legacy.run_id,
                created_at=legacy.created_at,
                last_used_at=now,
                node=c,
            )
            adopted.append(entry)
            satisfied[c] = entry
        cache.adopt_legacy(legacy, adopted)
    return satisfied


def build_physical_plan(
    logical: LogicalPlan,
    snapshots: Dict[str, Snapshot],
    *,
    config: PlannerConfig = PlannerConfig(),
    ctx: Any = None,
    cost_model: Optional[CostModel] = None,
    cache: Optional[CacheView] = None,
    input_fingerprints: Optional[Dict[str, str]] = None,
    device: DeviceLike = None,
) -> PhysicalPlan:
    """Plan ``logical`` into fused stages, planning *around* the cache.

    ``cache`` (when given) is consulted at node granularity: satisfied
    nodes are never assigned to a stage — terminal ones become
    rehydrations, interior ones cut fused chains so only the uncached
    suffix executes, and nodes no executing consumer needs are elided.
    ``input_fingerprints`` carries the sharding-invariant content identity
    of each external table (defaults to snapshot ids, which are exact but
    conservatively miss after a compaction rewrite).
    ``device`` is where the stages' python nodes put the columns they
    return (None means ``cuda``); it is no part of any fingerprint.
    """
    cost_model = cost_model or CostModel()
    # run params feed python nodes through ctx, so they are part of every
    # node's cache identity (a param change must invalidate everything)
    run_params = dict(getattr(ctx, "params", None) or {})
    input_ids = input_fingerprints or {
        t: snap.snapshot_id for t, snap in snapshots.items()
    }
    node_fp = compute_node_fingerprints(logical, input_ids, run_params)

    # the natural (cache-unaware) grouping of this config — shared by the
    # legacy-entry match and the materialization-parity restore set below
    nat_stages, nat_node_stage, nat_produced = _greedy_stages(
        logical, config, list(logical.order)
    )
    nat_outputs_per_stage = _stage_outputs(
        logical, nat_stages, nat_node_stage, nat_produced
    )

    # ------------------------------------------------- cache consultation
    satisfied = (
        _consult_cache(
            cache, logical, snapshots, run_params, node_fp,
            nat_stages, nat_produced, nat_outputs_per_stage,
        )
        if cache is not None
        else {}
    )

    # ------------------------------------------ needed-set (reverse walk)
    # An unsatisfied audit or contract output must run; running a node
    # needs its parents' values; a satisfied parent is restored instead of
    # recomputed, so *its* parents are not needed on its account.
    value_needed: Set[str] = set()
    exec_set: Set[str] = set()
    for name in reversed(list(logical.order)):
        if name in satisfied:
            continue
        node = logical.nodes[name]
        if not (
            node.is_expectation
            or name in logical.outputs
            or name in value_needed
        ):
            continue  # every consumer is satisfied or elided
        exec_set.add(name)
        for p in node.parents:
            if p in logical.nodes:
                value_needed.add(p)

    # what the natural (cache-unaware) grouping would materialize — cheap
    # manifest-key commits that keep a warm re-run's artifacts identical
    # to the cold run's under the same config with an intact cache.
    # Parity is deliberately best-effort beyond that: an UNSATISFIED node
    # whose consumers are all cached is elided rather than recomputed —
    # whether it lost its entry to a config flip (it was never
    # materialized under the old grouping) or to `repro cache prune`.
    # Contract outputs (logical.outputs) are always produced; an interior
    # table the current config would have materialized cold may be absent
    # from the warm branch, and `--no-cache` forces a full materializing
    # recompute.  This is the acceptance trade-off: recomputing such
    # nodes would turn every planner flip into real work.
    natural_outputs = {n for outs in nat_outputs_per_stage for n in outs}
    restored = tuple(
        name
        for name in logical.order
        if name in satisfied
        and not logical.nodes[name].is_expectation
        and (
            name in logical.outputs
            or name in value_needed
            or name in natural_outputs
        )
    )
    restored_set = set(restored)
    cached_checks = tuple(
        name
        for name in logical.order
        if name in satisfied and logical.nodes[name].is_expectation
    )

    # ---------------------------------------------------- stage assignment
    exec_names = [n for n in logical.order if n in exec_set]
    stage_nodes, node_stage, produced_in = _greedy_stages(
        logical, config, exec_names
    )

    # --------------------------------------------- boundary identification
    needed_later: Dict[str, List[int]] = {}
    for name in exec_names:
        node = logical.nodes[name]
        for p in node.parents:
            if p in produced_in and produced_in[p] != node_stage[name]:
                needed_later.setdefault(p, []).append(node_stage[name])

    stages: List[Stage] = []
    transitive: Dict[int, str] = {}
    for sid, names in enumerate(stage_nodes):
        nodes = [logical.nodes[n] for n in names]
        artifact_names = {n.name for n in nodes if not n.is_expectation}

        # external scans for this stage
        scan_tables: List[str] = []
        for node in nodes:
            for p in node.parents:
                if p not in logical.nodes and p not in scan_tables:
                    scan_tables.append(p)

        # pushdown: only when a table feeds exactly one SQL node in-stage,
        # and (with joins) only predicates attributable to the FROM table
        rewrites: Dict[str, Query] = {}
        scans: Dict[str, ScanSpec] = {}
        for table in scan_tables:
            snapshot = snapshots[table]
            consumers_here = [
                n for n in nodes if table in n.parents
            ]
            predicates: List[Predicate] = []
            columns: Optional[List[str]] = None
            if (
                config.pushdown
                and len(consumers_here) == 1
                and consumers_here[0].kind == "sql"
                and consumers_here[0].query is not None
            ):
                consumer = consumers_here[0]
                query = consumer.query
                if query.filter_expr is not None and table == query.source:
                    pushed, residual = _split_primary_pushdown(query, snapshots)
                    if pushed:
                        predicates = pushed
                        rewrites[consumer.name] = replace(
                            query, filter_expr=residual
                        )
                columns = _columns_for_table(query, table, snapshot)
            plan = plan_scan(snapshot, columns=columns, predicates=predicates)
            scans[table] = ScanSpec(table, plan, _scan_bytes(plan))

        # inputs produced by other stages OR restored from the cache (the
        # rehydrate-then-shorter-stage cut)
        internal_inputs = tuple(
            sorted(
                {
                    p
                    for n in nodes
                    for p in n.parents
                    if (p in produced_in and produced_in[p] != sid)
                    or p in restored_set
                }
            )
        )
        outputs = tuple(
            n
            for n in names
            if n in artifact_names
            and (n in logical.outputs or n in needed_later)
        )
        checks = tuple(n.name for n in nodes if n.is_expectation)
        # kernel routing per SQL node: decided from shard statistics at
        # plan time, never fingerprinted (both engines produce identical
        # artifacts, so the cache stays warm across engine flips)
        routes: Dict[str, RouteDecision] = {}
        for node in nodes:
            if node.kind == "sql" and node.query is not None:
                stats, total_rows = column_stats_for_query(node.query, snapshots)
                routes[node.name] = plan_route(
                    node.query,
                    engine=config.sql_engine,
                    stats=stats,
                    total_rows=total_rows,
                )
        input_order = tuple(sorted(scans)) + internal_inputs
        fn = _make_stage_fn(
            nodes, rewrites, input_order, outputs, ctx, routes, device
        )
        total_bytes = sum(s.estimated_bytes for s in scans.values())
        # legacy stage fingerprint: parents are topologically earlier
        # stages, so their fingerprints are already in ``transitive``; a
        # restored parent contributes its node fingerprint instead (the
        # "restored" key is only present for cache-cut stages, keeping
        # cold-plan fingerprints byte-identical to legacy entries)
        parent_stages = sorted(
            {produced_in[p] for p in internal_inputs if p in produced_in}
        )
        payload: Dict[str, Any] = {
            "nodes": [logical.nodes[n].fingerprint for n in names],
            "outputs": sorted(outputs),
            "parents": [transitive[p] for p in parent_stages],
            "scans": {t: snapshots[t].snapshot_id for t in scans},
            "params": run_params,
        }
        restored_parents = {
            p: node_fp[p] for p in internal_inputs if p in restored_set
        }
        if restored_parents:
            payload["restored"] = restored_parents
        transitive[sid] = stable_hash(payload)
        stages.append(
            Stage(
                stage_id=sid,
                node_names=tuple(names),
                scans=scans,
                internal_inputs=internal_inputs,
                outputs=outputs,
                checks=checks,
                fn=fn,
                resources=cost_model.request_for_scan(total_bytes),
                fingerprint="-".join(logical.nodes[n].fingerprint for n in names),
                transitive_fingerprint=transitive[sid],
                parent_stages=tuple(parent_stages),
                sql_routes=routes,
            )
        )
    executed = {n for names in stage_nodes for n in names}
    elided = tuple(
        n
        for n in logical.order
        if n not in executed
        and n not in restored_set
        and n not in cached_checks
    )
    return PhysicalPlan(
        logical=logical,
        config=config,
        stages=stages,
        node_fingerprints=node_fp,
        cached_nodes=satisfied,
        rehydrate=restored,
        cached_checks=cached_checks,
        elided=elided,
    )


# ===================================================================== cost
# Scheduler v2: the per-stage cost model + the critical-path weights the
# wave scheduler orders its ready heap by.  The same longest-path
# arithmetic backs `repro trace`'s critical-path table (telemetry/tracing
# feeds it *observed* stage latencies instead of estimates) — one shared
# implementation, so the scheduler's priorities and the trace's critical
# path can never disagree about the graph math.

#: bytes-scanned fallback throughput: with no latency history for a
#: stage's function fingerprint, its runtime is estimated as
#: ``overhead + scanned_bytes / SCAN_BYTES_PER_S`` (a conservative
#: single-host read+filter rate; the estimate self-corrects as soon as
#: the stage has run once, via the persisted ``latencyhist`` medians)
SCAN_BYTES_PER_S = 200e6
#: fixed per-stage overhead (dispatch + trace/compile amortized) the
#: bytes heuristic starts from, so zero-scan stages still carry weight
STAGE_OVERHEAD_S = 0.01


def stage_function_spec(pipeline_name: str, stage: Stage) -> FunctionSpec:
    """The ``FunctionSpec`` the runner dispatches ``stage`` under.

    One construction site for the spec means the scheduler's cost lookup
    and the executor's latency-history key are the same fingerprint by
    definition — the cost model reads exactly the history the stage's
    past executions wrote.
    """
    return FunctionSpec(
        name=f"{pipeline_name}/stage{stage.stage_id}",
        fn=stage.fn,
        static_config={"fingerprint": stage.fingerprint},
        resources=stage.resources,
    )


@dataclass(frozen=True)
class StageCost:
    """One stage's scheduling estimate (see ``estimate_stage_costs``)."""

    stage_id: int
    #: estimated runtime seconds
    est_s: float
    #: "latency" = per-fingerprint history median, "bytes" = scan heuristic
    source: str
    #: estimated peak memory (the admission cap's unit), from the stage's
    #: ResourceRequest tier
    est_memory_gb: int
    #: longest-path-to-sink weight (this stage + its heaviest downstream
    #: chain) — the ready heap's priority
    cp_weight_s: float = 0.0
    #: rank by descending weight (0 = most critical, ties by stage id)
    cp_rank: int = 0


def longest_path_weights(
    costs: Dict[int, float], parents: Dict[int, Sequence[int]]
) -> Dict[int, float]:
    """Longest-path-to-sink weight per stage: ``w(s) = cost(s) +
    max(w(child))`` over the dependency DAG described by ``parents``
    (child -> parent ids; parent ids are always lower, as the physical
    planner guarantees).  A sink's weight is its own cost."""
    children: Dict[int, List[int]] = {}
    for sid, ps in parents.items():
        for p in ps:
            children.setdefault(p, []).append(sid)
    weights: Dict[int, float] = {}
    for sid in sorted(costs, reverse=True):  # reverse topological order
        down = [weights[c] for c in children.get(sid, ()) if c in weights]
        weights[sid] = costs.get(sid, 0.0) + (max(down) if down else 0.0)
    return weights


def critical_path_ids(
    costs: Dict[int, float], parents: Dict[int, Sequence[int]]
) -> List[int]:
    """The stage ids of one heaviest root-to-sink chain, in execution
    order.  Ties break toward the lowest stage id, deterministically."""
    if not costs:
        return []
    weights = longest_path_weights(costs, parents)
    children: Dict[int, List[int]] = {}
    roots = []
    for sid in sorted(costs):
        live = [p for p in parents.get(sid, ()) if p in costs]
        if not live:
            roots.append(sid)
        for p in live:
            children.setdefault(p, []).append(sid)
    if not roots:
        roots = sorted(costs)[:1]
    head = min(roots, key=lambda s: (-weights[s], s))
    path = [head]
    while True:
        nxt = [c for c in sorted(children.get(path[-1], ())) if c in weights]
        if not nxt:
            return path
        path.append(min(nxt, key=lambda c: (-weights[c], c)))


def estimate_stage_costs(
    stages: Sequence[Stage],
    pipeline_name: str,
    latency_medians: Dict[str, float],
    *,
    scan_bytes_per_s: float = SCAN_BYTES_PER_S,
    stage_overhead_s: float = STAGE_OVERHEAD_S,
) -> Dict[int, StageCost]:
    """Estimate every stage's runtime and critical-path weight.

    Primary source: the median of the persisted ``latencyhist`` durations
    for the stage's function fingerprint (``stage_function_spec`` — the
    executor records one duration per completed dispatch under the same
    key, and the SDK Client persists/seeds them across processes).
    Fallback: a bytes-scanned heuristic from the stage's pruned scan
    plans.  Weights are longest-path-to-sink over ``parent_stages``.
    """
    est: Dict[int, Tuple[float, str]] = {}
    for stage in stages:
        median = latency_medians.get(
            stage_function_spec(pipeline_name, stage).fingerprint
        )
        if median is not None and median > 0.0:
            est[stage.stage_id] = (float(median), "latency")
        else:
            scanned = sum(s.estimated_bytes for s in stage.scans.values())
            est[stage.stage_id] = (
                stage_overhead_s + scanned / scan_bytes_per_s,
                "bytes",
            )
    parents = {s.stage_id: s.parent_stages for s in stages}
    weights = longest_path_weights(
        {sid: e[0] for sid, e in est.items()}, parents
    )
    by_weight = sorted(weights, key=lambda s: (-weights[s], s))
    ranks = {sid: rank for rank, sid in enumerate(by_weight)}
    return {
        stage.stage_id: StageCost(
            stage_id=stage.stage_id,
            est_s=est[stage.stage_id][0],
            source=est[stage.stage_id][1],
            est_memory_gb=stage.resources.memory_gb,
            cp_weight_s=weights[stage.stage_id],
            cp_rank=ranks[stage.stage_id],
        )
        for stage in stages
    }
