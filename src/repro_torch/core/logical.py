"""Logical plan: the typed, validated DAG over catalog artifacts (4.4.1).

Parsing a Pipeline yields a LogicalPlan: nodes in topological order,
external sources resolved against a catalog commit (so the plan is pinned
to a data version), and per-node column requirements for pruning.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.pipeline import Node, Pipeline, PipelineError
from repro_torch.table.schema import Schema


@dataclass(frozen=True)
class LogicalPlan:
    pipeline_name: str
    pipeline_fingerprint: str
    #: topological order, expectations after the artifact they audit
    order: Sequence[str]
    nodes: Dict[str, Node]
    #: tables read from the catalog: name -> schema
    external_schemas: Dict[str, Schema]
    #: artifacts that must be written back (terminal or explicitly marked)
    outputs: Sequence[str]

    def consumers(self, name: str) -> List[str]:
        return [n.name for n in self.nodes.values() if name in n.parents]

    def artifact_consumers(self, name: str) -> List[str]:
        """Consumers that are artifacts (expectations don't force
        materialization — they fuse with their parent)."""
        return [
            n.name
            for n in self.nodes.values()
            if name in n.parents and not n.is_expectation
        ]


def _toposort(pipeline: Pipeline, produced: Set[str]) -> List[str]:
    state: Dict[str, int] = {}  # 0=unseen 1=visiting 2=done
    order: List[str] = []

    def visit(name: str, chain: List[str]) -> None:
        if state.get(name) == 2:
            return
        if state.get(name) == 1:
            cycle = " -> ".join(chain + [name])
            raise PipelineError(f"cycle in pipeline DAG: {cycle}")
        state[name] = 1
        for parent in pipeline.nodes[name].parents:
            if parent in produced:
                visit(parent, chain + [name])
        state[name] = 2
        order.append(name)

    for name in pipeline.nodes:
        visit(name, [])
    return order


def build_logical_plan(
    pipeline: Pipeline,
    *,
    external_schemas: Dict[str, Schema],
) -> LogicalPlan:
    """Validate references + types, return the pinned logical plan.

    ``external_schemas`` is what the catalog resolves at the base commit —
    passing it in (rather than a live catalog handle) keeps the planner a
    pure function, which is what makes run replay exact.
    """
    produced = set(pipeline.artifacts)
    # -- reference validation --------------------------------------------
    for node in pipeline.nodes.values():
        for parent in node.parents:
            if parent not in produced and parent not in external_schemas:
                raise PipelineError(
                    f"node {node.name!r} references unknown table {parent!r} "
                    f"(not produced by the pipeline, not in the catalog)"
                )
        if node.is_expectation and node.name in produced:
            raise PipelineError(
                f"{node.name!r} is an expectation but also an artifact"
            )
    order = _toposort(pipeline, produced | set(pipeline.expectations))

    # -- column-level validation for SQL nodes over external tables ------
    # Multi-source aware: qualified references are checked against the
    # schema their qualifier resolves to; plain references against the
    # union of all source schemas — but only when every source is a
    # catalog table (a node-produced source has no static schema here,
    # so plain names cannot be attributed and are left to the executor).
    for node in pipeline.nodes.values():
        if node.query is None:
            continue
        q = node.query
        qual_tables = dict(q.qualifiers())
        qual_schemas = {
            qual: external_schemas[table]
            for qual, table in qual_tables.items()
            if table in external_schemas
        }
        if not qual_schemas:
            continue
        all_known = len(qual_schemas) == len(qual_tables)
        union = {n for s in qual_schemas.values() for n in s.names}
        for c in q.referenced_columns():
            if "." in c:
                qual, tail = c.split(".", 1)
                if qual in qual_schemas and not qual_schemas[qual].has(tail):
                    raise PipelineError(
                        f"node {node.name!r} references column {c!r} "
                        f"missing from table {qual_tables[qual]!r} "
                        f"({sorted(qual_schemas[qual].names)})"
                    )
                if all_known and qual not in qual_schemas:
                    raise PipelineError(
                        f"node {node.name!r} references {c!r} but "
                        f"{qual!r} is not a table or alias of this query "
                        f"({sorted(qual_tables)})"
                    )
            elif all_known and c not in union:
                raise PipelineError(
                    f"node {node.name!r} references column {c!r} "
                    f"missing from table {q.source!r} ({sorted(union)})"
                )

    # -- outputs: terminal artifacts + explicitly materialized ------------
    outputs = [
        n.name
        for n in pipeline.nodes.values()
        if not n.is_expectation
        and (
            n.materialize
            or not [c for c in pipeline.consumers(n.name)]
        )
    ]
    # artifacts consumed ONLY by expectations are still terminal outputs
    for n in pipeline.nodes.values():
        if n.is_expectation:
            continue
        consumers = pipeline.consumers(n.name)
        if consumers and all(
            pipeline.nodes[c].is_expectation for c in consumers
        ) and n.name not in outputs:
            outputs.append(n.name)

    return LogicalPlan(
        pipeline_name=pipeline.name,
        pipeline_fingerprint=pipeline.fingerprint,
        order=tuple(order),
        nodes=dict(pipeline.nodes),
        external_schemas=dict(external_schemas),
        outputs=tuple(outputs),
    )
