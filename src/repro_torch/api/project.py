"""Decorator-registered models — pipelines assembled by discovery.

Bauplan's SDK (paper 4.1) never asks the user to wire a DAG: functions
are declared with ``@bauplan.model()`` / ``@bauplan.expectation()`` and
the platform assembles the pipeline from what a module *defines*.  This
module reproduces that surface:

* ``@repro_torch.model()``       — a Python artifact node (parents = argument
  names after ``ctx``, exactly like ``Pipeline.python``);
* ``@repro_torch.expectation()`` — an audit node, whatever the function is
  called (no ``_expectation`` suffix needed);
* ``repro_torch.sql("name", "SELECT ...")`` — a SQL artifact node;
* ``@repro_torch.requirements({...})`` — pins packages into the fingerprint
  (re-exported from core unchanged).

Registrations land in a named ``Project``; the default project for a
registration is the defining module, so *importing a module yields its
DAG*: ``repro_torch.discover("pipeline.py")`` / ``Client.run("pipeline.py")``.
Re-registering a name overwrites the previous definition (a module
re-imported or reloaded redefines, it does not collide) — ``Project``
is a mutable registry; an immutable ``Pipeline`` is minted per run.
"""
from __future__ import annotations

import importlib.util
import inspect
import sys
import threading
import warnings
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.core.pipeline import Node, Pipeline, PipelineError, requirements
from repro_torch.engine.sql import parse_sql
from repro_torch.utils.hashing import stable_hash

__all__ = [
    "Project",
    "RedefinitionWarning",
    "project",
    "model",
    "expectation",
    "sql",
    "requirements",
    "discover",
    "resolve_pipeline",
]


class RedefinitionWarning(UserWarning):
    """A node name was re-registered with *different* code.

    Re-importing the same module re-registers identical nodes silently
    (same fingerprint, nothing changed); this fires only when the new
    definition would quietly shadow a different one."""

#: global project registry — module-level decorators register here
_PROJECTS: Dict[str, "Project"] = {}
_LOCK = threading.Lock()


class Project:
    """A mutable, named registry of decorator-declared nodes.

    ``pipeline()`` mints an immutable ``Pipeline`` from the current
    registrations (insertion order preserved); the fingerprint machinery
    downstream is untouched — a Project is purely the assembly surface.
    """

    def __init__(self, name: str):
        self.name = name
        self._nodes: Dict[str, Node] = {}
        #: modules that registered nodes here (discovery bookkeeping)
        self.modules: set = set()
        #: node name -> (old location, new location) for names that were
        #: re-registered with DIFFERENT code; the linter reports these (G304)
        self.redefinitions: Dict[str, Tuple[str, str]] = {}

    # ------------------------------------------------------- registration
    def _register(self, node: Node, module: Optional[str]) -> None:
        if node.name in node.parents:
            raise PipelineError(f"node {node.name!r} references itself")
        old = self._nodes.get(node.name)
        if old is not None and old.fingerprint != node.fingerprint:
            old_loc = _loc_str(old)
            new_loc = _loc_str(node)
            self.redefinitions[node.name] = (old_loc, new_loc)
            warnings.warn(
                f"project {self.name!r}: node {node.name!r} redefined with "
                f"different code — {new_loc} replaces {old_loc}",
                RedefinitionWarning,
                stacklevel=3,
            )
        self._nodes[node.name] = node  # overwrite = redefinition
        if module:
            self.modules.add(module)

    def model(
        self,
        fn: Optional[Callable] = None,
        *,
        name: Optional[str] = None,
        materialize: bool = False,
    ) -> Callable:
        """Declare a Python artifact: parents are the args after ``ctx``."""

        def deco(f: Callable) -> Callable:
            node_name, parents = _fn_signature(f, name)
            self._register(
                Node(
                    name=node_name,
                    kind="python",
                    parents=parents,
                    fn=f,
                    requirements=getattr(f, "__repro_requirements__", {}),
                    materialize=materialize,
                    source_file=getattr(f.__code__, "co_filename", None),
                    source_line=getattr(f.__code__, "co_firstlineno", None),
                ),
                f.__module__,
            )
            return f

        return deco(fn) if fn is not None else deco

    def expectation(
        self, fn: Optional[Callable] = None, *, name: Optional[str] = None
    ) -> Callable:
        """Declare an audit node — any function name, no suffix required."""

        def deco(f: Callable) -> Callable:
            node_name, parents = _fn_signature(f, name)
            self._register(
                Node(
                    name=node_name,
                    kind="expectation",
                    parents=parents,
                    fn=f,
                    requirements=getattr(f, "__repro_requirements__", {}),
                    source_file=getattr(f.__code__, "co_filename", None),
                    source_line=getattr(f.__code__, "co_firstlineno", None),
                ),
                f.__module__,
            )
            return f

        return deco(fn) if fn is not None else deco

    def sql(
        self,
        name: str,
        sql_text: str,
        *,
        materialize: bool = False,
        _module: Optional[str] = None,
        _source: Optional[Tuple[Optional[str], Optional[int]]] = None,
    ) -> None:
        """Declare a SQL artifact; its parent is the ``FROM`` table."""
        query = parse_sql(sql_text)
        if _source is None:
            caller = sys._getframe(1) if hasattr(sys, "_getframe") else None
            _source = (
                (caller.f_code.co_filename, caller.f_lineno)
                if caller is not None
                else (None, None)
            )
        self._register(
            Node(
                name=name,
                kind="sql",
                parents=tuple(query.source_tables()),
                query=query,
                materialize=materialize,
                source_file=_source[0],
                source_line=_source[1],
            ),
            _module or _caller_module(),
        )

    # ----------------------------------------------------------- assembly
    def pipeline(self) -> Pipeline:
        """Mint an immutable Pipeline from the current registrations."""
        if not self._nodes:
            raise PipelineError(f"project {self.name!r} has no nodes")
        p = Pipeline(self.name)
        for node in self._nodes.values():
            p.add_node(node)
        # plain attribute, not part of Pipeline's contract: the linter
        # surfaces these as G304 findings
        p.redefinitions = dict(self.redefinitions)
        return p

    @property
    def nodes(self) -> Dict[str, Node]:
        return dict(self._nodes)

    def clear(self) -> None:
        self._nodes.clear()
        self.modules.clear()
        self.redefinitions.clear()

    def __len__(self) -> int:
        return len(self._nodes)

    def __repr__(self) -> str:
        return f"Project({self.name!r}, nodes={sorted(self._nodes)})"


# ------------------------------------------------------------ module-level
def project(name: str) -> Project:
    """Get-or-create the named project (the decorators' target registry)."""
    with _LOCK:
        if name not in _PROJECTS:
            _PROJECTS[name] = Project(name)
        return _PROJECTS[name]


def _caller_module(depth: int = 2) -> Optional[str]:
    frame = sys._getframe(depth) if hasattr(sys, "_getframe") else None
    return frame.f_globals.get("__name__") if frame is not None else None


def _loc_str(node: Node) -> str:
    if node.source_file:
        return f"{node.source_file}:{node.source_line}"
    return "<unknown location>"


def _fn_signature(f: Callable, name: Optional[str]):
    params = list(inspect.signature(f).parameters)
    if not params or params[0] != "ctx":
        raise PipelineError(
            f"model {f.__name__!r} must take ctx as its first argument"
        )
    parents = tuple(params[1:])
    if not parents:
        raise PipelineError(
            f"model {f.__name__!r} references no parent tables"
        )
    return name or f.__name__, parents


def _resolve_project(proj: Union[None, str, Project], module: Optional[str]) -> Project:
    if isinstance(proj, Project):
        return proj
    if isinstance(proj, str):
        return project(proj)
    # default: one project per defining module — import a module, get a DAG
    return project(module or "__default__")


def model(
    fn: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    project: Union[None, str, Project] = None,
    materialize: bool = False,
) -> Callable:
    """``@repro_torch.model()`` — register a Python artifact into a project."""

    def deco(f: Callable) -> Callable:
        return _resolve_project(project, f.__module__).model(
            f, name=name, materialize=materialize
        )

    return deco(fn) if fn is not None else deco


def expectation(
    fn: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    project: Union[None, str, Project] = None,
) -> Callable:
    """``@repro_torch.expectation()`` — register an audit into a project."""

    def deco(f: Callable) -> Callable:
        return _resolve_project(project, f.__module__).expectation(f, name=name)

    return deco(fn) if fn is not None else deco


def sql(
    name: str,
    sql_text: str,
    *,
    project: Union[None, str, Project] = None,
    materialize: bool = False,
) -> None:
    """``repro_torch.sql("trips", "SELECT ...")`` — register a SQL artifact."""
    module = _caller_module()
    caller = sys._getframe(1) if hasattr(sys, "_getframe") else None
    source = (
        (caller.f_code.co_filename, caller.f_lineno)
        if caller is not None
        else (None, None)
    )
    _resolve_project(project, module).sql(
        name, sql_text, materialize=materialize, _module=module, _source=source
    )


# --------------------------------------------------------------- discovery
def _load_module(path: Union[str, Path]) -> ModuleType:
    """Import a pipeline file under a module name derived from its
    *resolved* path — two files that merely share a stem must not share a
    default project.  Re-importing the same file first clears its default
    project, so an edited file's deleted nodes do not linger in the DAG
    (explicitly-named projects keep overwrite semantics — they may be
    shared across modules)."""
    path = Path(path).resolve()
    # hash the resolved path rather than char-replacing it — sanitization
    # collapses distinct paths ("a_b.py" vs "a/b.py") onto one module name
    mod_name = (
        f"_repro_discovered_{path.stem}_{stable_hash(str(path), length=12)}"
    )
    with _LOCK:
        stale = _PROJECTS.get(mod_name)
    if stale is not None:
        stale.clear()
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import pipeline module {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def discover(target: Union[str, Path, ModuleType]) -> Project:
    """Import a module (by path or object) and return the Project its
    registrations landed in — "import a module, get the DAG".

    Resolution order: a project explicitly created/named inside the module
    whose nodes the module registered; else the module's default project.
    Exactly one candidate must remain, otherwise the caller has to name
    the project explicitly (``repro_torch.project(...)``).
    """
    mod = target if isinstance(target, ModuleType) else _load_module(target)
    with _LOCK:
        candidates = [
            p for p in _PROJECTS.values()
            if mod.__name__ in p.modules and len(p) > 0
        ]
    if len(candidates) == 1:
        return candidates[0]
    if not candidates:
        raise PipelineError(
            f"module {mod.__name__!r} registered no models — decorate "
            "functions with @repro_torch.model()/@repro_torch.expectation() or define "
            "PIPELINE = repro_torch.Pipeline(...)"
        )
    raise PipelineError(
        f"module {mod.__name__!r} populated {len(candidates)} projects "
        f"({sorted(p.name for p in candidates)}); pass the project name"
    )


def resolve_pipeline(
    target: Union[Pipeline, Project, str, Path, ModuleType]
) -> Pipeline:
    """Anything run-able → an immutable Pipeline.

    Accepts a ``Pipeline`` (used as-is), a ``Project`` (minted), a module
    object, or a path to a pipeline file.  A file may either use the
    decorator SDK or define a legacy ``PIPELINE`` global — the legacy
    spelling stays supported so pre-SDK pipeline files keep running.
    """
    if isinstance(target, Pipeline):
        return target
    if isinstance(target, Project):
        return target.pipeline()
    if isinstance(target, str) and target in _PROJECTS:
        return _PROJECTS[target].pipeline()
    if isinstance(target, ModuleType):
        legacy = getattr(target, "PIPELINE", None)
        if isinstance(legacy, Pipeline):
            return legacy
        return discover(target).pipeline()
    path = Path(target)
    if not path.exists():
        raise FileNotFoundError(
            f"no pipeline at {path} (and no project named {str(target)!r})"
        )
    mod = _load_module(path)
    legacy = getattr(mod, "PIPELINE", None)
    if isinstance(legacy, Pipeline):
        return legacy
    return discover(mod).pipeline()
