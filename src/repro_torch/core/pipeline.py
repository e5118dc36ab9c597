"""Declarative pipeline definition — "functions are all you need" (4.1).

Users declare artifacts one by one; the DAG is *implicit*:

* a SQL node's parent is whatever its ``FROM`` references;
* a Python node's parents are its argument names (after ``ctx``);
* a function named ``<something>_expectation`` is an audit, not an artifact.

No imperative DAG wiring anywhere — exactly the paper's dbt-style
one-query-one-artifact pattern, with the Appendix code reproducible
almost verbatim (see examples/taxi_pipeline.py).
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.engine.query import Query
from repro_torch.engine.sql import parse_sql
from repro_torch.utils.hashing import fingerprint_fn, stable_hash


class PipelineError(ValueError):
    pass


@dataclass(frozen=True)
class Node:
    """One artifact (or one audit) in the DAG."""

    name: str
    kind: str  # "sql" | "python" | "expectation"
    parents: Tuple[str, ...]
    query: Optional[Query] = None
    fn: Optional[Callable] = None
    requirements: Dict[str, str] = field(default_factory=dict)
    #: force materialization of this artifact even if fused past
    materialize: bool = False
    #: where the node was declared (decoration/registration site) — lint
    #: diagnostics only, deliberately excluded from the fingerprint
    source_file: Optional[str] = field(default=None, compare=False)
    source_line: Optional[int] = field(default=None, compare=False)

    @property
    def is_expectation(self) -> bool:
        return self.kind == "expectation"

    @property
    def fingerprint(self) -> str:
        payload: Dict[str, Any] = {
            "name": self.name,
            "kind": self.kind,
            "parents": list(self.parents),
            "requirements": self.requirements,
            "materialize": self.materialize,
        }
        if self.query is not None:
            payload["query"] = self.query.to_json_dict()
        if self.fn is not None:
            payload["fn"] = fingerprint_fn(self.fn)
        return stable_hash(payload)


def requirements(reqs: Dict[str, str]) -> Callable:
    """The paper's ``@requirements({'pandas': '2.0.0'})`` decorator.

    In a single-process runtime the packages are fixed, so the pinned
    requirements become part of the node fingerprint (reproducibility key)
    rather than a pip install — see DESIGN.md 2.
    """

    def deco(fn: Callable) -> Callable:
        fn.__repro_requirements__ = dict(reqs)
        return fn

    return deco


class Pipeline:
    """A named collection of nodes. Purely declarative — running is the
    Runner's job (sync or async, Table 1)."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, Node] = {}

    # ----------------------------------------------------------- builders
    def _add(self, node: Node) -> None:
        if node.name in self.nodes:
            raise PipelineError(f"duplicate artifact {node.name!r}")
        for p in node.parents:
            if p == node.name:
                raise PipelineError(f"node {node.name!r} references itself")
        self.nodes[node.name] = node

    def add_node(self, node: Node) -> Node:
        """Add a fully-formed node (the SDK's ``Project`` assembles nodes
        from decorator registrations and installs them through here)."""
        self._add(node)
        return node

    def sql(self, name: str, sql_text: str, *, materialize: bool = False) -> Node:
        """Declare a SQL artifact; its parent is the FROM table."""
        query = parse_sql(sql_text)
        caller = inspect.currentframe().f_back
        node = Node(
            name=name,
            kind="sql",
            parents=tuple(query.source_tables()),
            query=query,
            materialize=materialize,
            source_file=caller.f_code.co_filename if caller else None,
            source_line=caller.f_lineno if caller else None,
        )
        self._add(node)
        return node

    def python(
        self, fn: Optional[Callable] = None, *, materialize: bool = False
    ) -> Callable:
        """Declare a Python artifact or expectation from a function.

        Usage::

            @p.python
            def pickups(ctx, trips): ...          # artifact "pickups"

            @p.python
            def trips_expectation(ctx, trips): ... # audit on "trips"
        """

        def deco(f: Callable) -> Callable:
            params = list(inspect.signature(f).parameters)
            if not params or params[0] != "ctx":
                raise PipelineError(
                    f"python node {f.__name__!r} must take ctx as first arg"
                )
            parents = tuple(params[1:])
            if not parents:
                raise PipelineError(
                    f"python node {f.__name__!r} references no parent tables"
                )
            kind = "expectation" if f.__name__.endswith("_expectation") else "python"
            node = Node(
                name=f.__name__,
                kind=kind,
                parents=parents,
                fn=f,
                requirements=getattr(f, "__repro_requirements__", {}),
                materialize=materialize and kind != "expectation",
                source_file=getattr(f.__code__, "co_filename", None),
                source_line=getattr(f.__code__, "co_firstlineno", None),
            )
            self._add(node)
            return f

        return deco(fn) if fn is not None else deco

    # ----------------------------------------------------------- analysis
    @property
    def artifacts(self) -> List[str]:
        return [n.name for n in self.nodes.values() if not n.is_expectation]

    @property
    def expectations(self) -> List[str]:
        return [n.name for n in self.nodes.values() if n.is_expectation]

    def consumers(self, name: str) -> List[str]:
        return [n.name for n in self.nodes.values() if name in n.parents]

    def external_sources(self) -> List[str]:
        """Referenced tables that no node in the pipeline produces."""
        produced = set(self.artifacts)
        out: List[str] = []
        for n in self.nodes.values():
            for p in n.parents:
                if p not in produced and p not in out:
                    out.append(p)
        return out

    @property
    def fingerprint(self) -> str:
        """The run-reproducibility key for the whole project (4.4.1)."""
        return stable_hash(
            {
                "name": self.name,
                "nodes": {k: v.fingerprint for k, v in self.nodes.items()},
            }
        )
