"""The preflight orchestrator — DAG diagnostics + the three static passes.

``lint_pipeline`` is the single entry point the SDK, CLI, and run gate
all call.  It walks the resolved pipeline exactly once:

1. graph diagnostics — cycles (``G302``), unreachable nodes (``G303``),
   unknown source tables (``L004``), orphan expectations (``G301``),
   silent node redefinitions surfaced by ``api/project.py`` (``G304``);
2. topological schema propagation + the lineage checks (``L001``-``L003``)
   from :mod:`repro_torch.analysis.lineage`;
3. the cache-poison AST rules (``D101``-``D107``) from
   :mod:`repro_torch.analysis.rules` over every decorated function body;
4. the typed-dataflow rules (``T401``-``T404``) from
   :mod:`repro_torch.analysis.types` over every SQL node — join-key dtypes,
   2^24 f32-exactness (when shard stats are supplied), LEFT-JOIN
   zero-fill widening;
5. the concurrency-hazard rules (``C501``-``C503``) over the whole DAG —
   lake-table shadowing and shared-global traffic between co-schedulable
   nodes;
6. the cache-invalidation blast radius, computed by perturbing one
   node's fingerprint at a time through
   :func:`repro_torch.core.physical.fingerprint_blast_radius`.

Nothing here executes a node or touches an object store — the only
inputs are the pipeline object and (optionally) catalog schemas plus
already-loaded snapshot metadata.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.analysis.lineage import (
    Unknown,
    check_python_node,
    check_sql_node,
    propagate_schema,
)
from repro_torch.analysis.report import Finding, LintReport, Severity
from repro_torch.analysis.rules import run_concurrency_rules, run_function_rules
from repro_torch.analysis.types import check_node_types
from repro_torch.analysis.astpass import load_fn_source
from repro_torch.core.pipeline import Node, Pipeline
from repro_torch.table.schema import Schema

#: graph-diagnostic rules (kept next to the D-rule catalog for the README)
GRAPH_RULES = {
    "L001": "referenced column missing from the input schema",
    "L002": "GROUP BY key dtype the engine cannot group on",
    "L003": "ORDER BY column absent from the node's outputs",
    "L004": "source table neither produced by the pipeline nor in the catalog",
    "G301": "expectation audits no pipeline-produced artifact",
    "G302": "dependency cycle",
    "G303": "node unreachable from any external source (cycle fallout)",
    "G304": "node name silently redefined at registration time",
}


def _node_loc(node: Node) -> Tuple[Optional[str], Optional[int]]:
    return getattr(node, "source_file", None), getattr(node, "source_line", None)


def _toposort(pipeline: Pipeline) -> Tuple[List[str], List[Finding]]:
    """Kahn's algorithm tolerant of cycles: returns the sortable prefix
    plus G302/G303 findings for whatever could not be ordered."""
    findings: List[Finding] = []
    names = set(pipeline.nodes)
    indeg = {
        n: sum(1 for p in node.parents if p in names)
        for n, node in pipeline.nodes.items()
    }
    ready = sorted(n for n, d in indeg.items() if d == 0)
    order: List[str] = []
    while ready:
        n = ready.pop(0)
        order.append(n)
        for child, cnode in pipeline.nodes.items():
            if n in cnode.parents:
                indeg[child] -= 1
                if indeg[child] == 0:
                    ready.append(child)
        ready.sort()
    stuck = sorted(names - set(order))
    if stuck:
        # walk one actual cycle for the message: follow in-pipeline parents
        # through stuck nodes until a repeat
        chain = [stuck[0]]
        seen = {stuck[0]}
        while True:
            nxt = next(
                (
                    p
                    for p in pipeline.nodes[chain[-1]].parents
                    if p in stuck
                ),
                None,
            )
            if nxt is None or nxt in seen:
                if nxt is not None:
                    chain.append(nxt)
                break
            chain.append(nxt)
            seen.add(nxt)
        cycle_members = set(chain)
        loc_bits = []
        for member in chain:
            f, ln = _node_loc(pipeline.nodes[member])
            loc_bits.append(f"{member} ({f}:{ln})" if f else member)
        file, line = _node_loc(pipeline.nodes[chain[0]])
        findings.append(
            Finding(
                rule="G302",
                severity=Severity.ERROR,
                message="dependency cycle: " + " -> ".join(reversed(loc_bits)),
                node=chain[0],
                file=file,
                line=line,
            )
        )
        for n in stuck:
            if n in cycle_members:
                continue
            file, line = _node_loc(pipeline.nodes[n])
            findings.append(
                Finding(
                    rule="G303",
                    severity=Severity.WARNING,
                    message=(
                        f"node {n!r} is unreachable — it sits behind the "
                        "cycle and can never be scheduled"
                    ),
                    node=n,
                    file=file,
                    line=line,
                )
            )
    return order, findings


def _blast_radius(
    pipeline: Pipeline, order: List[str]
) -> Dict[str, List[str]]:
    """node -> downstream nodes whose transitive fingerprint changes when
    the node's code is edited.  Pure fingerprint arithmetic — no I/O."""
    from repro_torch.core.physical import fingerprint_blast_radius

    if not order or len(order) != len(pipeline.nodes):
        return {}  # cyclic graphs have no meaningful radius
    logical = SimpleNamespace(order=order, nodes=pipeline.nodes)
    externals = pipeline.external_sources()
    dummy_inputs = {t: f"lint:{t}" for t in externals}
    try:
        return fingerprint_blast_radius(logical, dummy_inputs, {})
    except Exception:  # diagnostics must never take the lint pass down
        return {}


def lint_pipeline(
    pipeline: Pipeline,
    *,
    external_schemas: Optional[Dict[str, Optional[Schema]]] = None,
    external_snapshots: Optional[Dict[str, Any]] = None,
    catalog_tables: Optional[Set[str]] = None,
) -> LintReport:
    """Run all static passes over ``pipeline``; executes nothing.

    ``external_schemas`` maps catalog table name -> :class:`Schema` for
    tables the pipeline reads from outside itself.  When the dict is
    provided (the SDK/CLI always provide it), a source table missing
    from both the pipeline and the dict is an ``L004`` error; when it is
    ``None`` (bare API use, no catalog at hand), table existence and all
    schema-dependent checks are skipped rather than guessed.

    ``external_snapshots`` (table -> Snapshot, already loaded — nothing
    is fetched here) feeds shard statistics to the stats-grounded typed
    checks (T403); ``catalog_tables`` (names at the lint branch head)
    powers the lake-table shadowing check (C501).  Both optional — bare
    callers lose those rules, not the pass.
    """
    findings: List[Finding] = []
    suppressed = 0

    order, graph_findings = _toposort(pipeline)
    findings.extend(graph_findings)

    # ---- table universe / L004 -----------------------------------------
    produced = set(pipeline.nodes)
    schemas: Dict[str, Optional[Schema]] = {}
    if external_schemas is not None:
        schemas.update(external_schemas)
    for node in pipeline.nodes.values():
        for parent in node.parents:
            if parent in produced or parent in schemas:
                continue
            if external_schemas is None:
                schemas[parent] = Unknown  # unknown, but not an error
                continue
            file, line = _node_loc(node)
            findings.append(
                Finding(
                    rule="L004",
                    severity=Severity.ERROR,
                    message=(
                        f"table {parent!r} is not produced by the pipeline "
                        "and does not exist in the catalog"
                    ),
                    node=node.name,
                    file=file,
                    line=line,
                )
            )
            schemas[parent] = Unknown  # report once per table

    # ---- orphan expectations / G301 ------------------------------------
    for name in pipeline.expectations:
        node = pipeline.nodes[name]
        if not any(p in produced for p in node.parents):
            file, line = _node_loc(node)
            findings.append(
                Finding(
                    rule="G301",
                    severity=Severity.WARNING,
                    message=(
                        f"expectation {name!r} audits no pipeline-produced "
                        f"artifact (parents: {list(node.parents)})"
                    ),
                    node=name,
                    file=file,
                    line=line,
                )
            )

    # ---- redefinitions / G304 ------------------------------------------
    for name, (old_loc, new_loc) in sorted(
        getattr(pipeline, "redefinitions", {}).items()
    ):
        node = pipeline.nodes.get(name)
        file, line = _node_loc(node) if node is not None else (None, None)
        findings.append(
            Finding(
                rule="G304",
                severity=Severity.WARNING,
                message=(
                    f"node {name!r} was registered twice with different "
                    f"code — {new_loc} silently replaced {old_loc}"
                ),
                node=name,
                file=file,
                line=line,
            )
        )

    # ---- lineage + typed-dataflow + cache-poison passes, topo order ----
    for name in order:
        node = pipeline.nodes[name]
        if node.kind == "sql" and node.query is not None:
            findings.extend(check_sql_node(node, schemas))
            stats: Dict[str, Tuple[int, int]] = {}
            total_rows: Optional[int] = None
            if external_snapshots:
                from repro_torch.engine.route import column_stats_for_query

                stats, total_rows = column_stats_for_query(
                    node.query, external_snapshots
                )
            t_findings, t_sup = check_node_types(
                node, schemas, stats=stats, total_rows=total_rows
            )
            findings.extend(t_findings)
            suppressed += t_sup
        elif node.fn is not None:
            py_findings, py_sup = check_python_node(node, schemas)
            findings.extend(py_findings)
            suppressed += py_sup
            src = load_fn_source(node.fn)
            if src is not None:
                d_findings, d_sup = run_function_rules(
                    src, node.name, node.parents
                )
                findings.extend(d_findings)
                suppressed += d_sup
        schemas[name] = propagate_schema(node, schemas)

    # ---- concurrency hazards over the whole DAG ------------------------
    c_findings, c_sup = run_concurrency_rules(
        pipeline, catalog_tables=catalog_tables
    )
    findings.extend(c_findings)
    suppressed += c_sup

    return LintReport(
        pipeline=pipeline.name,
        findings=findings,
        blast_radius=_blast_radius(pipeline, order),
        suppressed=suppressed,
    )
