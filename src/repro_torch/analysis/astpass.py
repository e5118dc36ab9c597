"""AST plumbing for the static passes — source loading, noqa, column refs.

Everything here is *read-only over source code*: ``inspect.getsource`` on
decorated node functions, ``ast.parse`` on the dedented body, and a few
structural walks.  No node function is ever called — that is the whole
point of a preflight pass.

Suppression: a finding is silenced by a ``# repro: noqa`` comment on its
line (all rules) or ``# repro: noqa[D102]`` / ``# repro: noqa[D101,D105]``
(listed rules only).  A noqa on the ``def`` line or a decorator line
suppresses the whole function.
"""
from __future__ import annotations

import ast
import inspect
import re
import textwrap
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

_NOQA_RE = re.compile(
    r"#\s*repro:\s*noqa(?:\[(?P<rules>[A-Za-z0-9_,\s]+)\])?", re.IGNORECASE
)

#: Columnar methods whose first string argument names a column of self
_COLUMN_METHODS = {"sum", "mean", "min", "max", "column", "dtype_of"}


@dataclass
class FnSource:
    """A node function's source, parsed and line-mapped back to its file."""

    file: str
    #: absolute 1-based line of the first source line (decorators included)
    start_line: int
    lines: List[str]
    tree: ast.Module
    fn_def: ast.FunctionDef
    #: absolute line -> None (suppress all) or set of rule ids to suppress
    noqa: Dict[int, Optional[Set[str]]] = field(default_factory=dict)
    #: rules suppressed for the entire function (noqa on def/decorator line)
    fn_noqa: Optional[Set[str]] = None  # None = nothing; empty set = ALL
    _fn_noqa_all: bool = False

    def abs_line(self, node: ast.AST) -> int:
        return self.start_line + getattr(node, "lineno", 1) - 1

    def snippet(self, node: ast.AST) -> str:
        rel = getattr(node, "lineno", 1) - 1
        if 0 <= rel < len(self.lines):
            return self.lines[rel].rstrip()
        return ""

    def suppressed(self, rule: str, abs_line: int) -> bool:
        if self._fn_noqa_all:
            return True
        if self.fn_noqa is not None and rule in self.fn_noqa:
            return True
        if abs_line in self.noqa:
            rules = self.noqa[abs_line]
            return rules is None or rule in rules
        return False


def _parse_noqa(line: str) -> Optional[Optional[Set[str]]]:
    """``None`` if no noqa on the line; else the suppression spec
    (``None`` = all rules, or the explicit id set)."""
    m = _NOQA_RE.search(line)
    if not m:
        return None
    rules = m.group("rules")
    if rules is None:
        return (None,)  # wrapped so "bare noqa" is distinguishable
    return ({r.strip().upper() for r in rules.split(",") if r.strip()},)


def load_fn_source(fn: Callable) -> Optional[FnSource]:
    """Source + AST for a node function; ``None`` when source is
    unavailable (REPL/builtin) — AST rules are skipped, never guessed."""
    try:
        raw_lines, start = inspect.getsourcelines(fn)
        file = inspect.getsourcefile(fn) or fn.__code__.co_filename
    except (OSError, TypeError, AttributeError):
        return None
    source = textwrap.dedent("".join(raw_lines))
    try:
        tree = ast.parse(source)
    except SyntaxError:  # pragma: no cover - getsource gave a valid fn
        return None
    fn_def = next(
        (
            n
            for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ),
        None,
    )
    if fn_def is None:  # pragma: no cover - lambdas etc.
        return None

    src = FnSource(
        file=file,
        start_line=start,
        lines=source.splitlines(),
        tree=tree,
        fn_def=fn_def,
    )
    for i, line in enumerate(src.lines):
        spec = _parse_noqa(line)
        if spec is not None:
            src.noqa[start + i] = spec[0]
    # function-level suppression: noqa on the def line or any decorator line
    head_lines = [fn_def.lineno] + [d.lineno for d in fn_def.decorator_list]
    for rel in head_lines:
        spec = src.noqa.get(start + rel - 1)
        if start + rel - 1 in src.noqa:
            if spec is None:
                src._fn_noqa_all = True
            else:
                src.fn_noqa = (src.fn_noqa or set()) | spec
    return src


def line_suppresses(
    file: Optional[str], line: Optional[int], rule: str
) -> bool:
    """Whether a ``# repro: noqa`` on one *source line* silences ``rule``.

    The suppression surface for findings that anchor on a registration
    line rather than a function body — SQL nodes (``p.sql("x", ...)``)
    have no AST to walk, so the typed-dataflow (T) rules honor a noqa on
    the registration call's first line, with the same bare/[RULE] scoping
    the D rules use inside function bodies.
    """
    if not file or not line:
        return False
    import linecache

    text = linecache.getline(file, line)
    if not text:
        return False
    spec = _parse_noqa(text)
    if spec is None:
        return False
    rules = spec[0]
    return rules is None or rule.upper() in rules


# --------------------------------------------------------------- name walks
def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.random.default_rng`` -> that string; ``None`` for non-chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """The base ``Name`` a subscript/attribute chain hangs off, if any."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _subscript_key(node: ast.Subscript) -> Optional[str]:
    sl = node.slice
    # py3.8 wraps in ast.Index; 3.9+ is the expression itself
    if sl.__class__.__name__ == "Index":  # pragma: no cover - py38 only
        sl = sl.value  # type: ignore[attr-defined]
    return _const_str(sl)


def column_references(
    src: FnSource, parents: Tuple[str, ...]
) -> Iterator[Tuple[str, str, ast.AST]]:
    """Yield ``(parent, column, ast_node)`` for every statically-visible
    column access on a parent relation inside the function body:

    * ``trips["count"]`` and ``trips.columns["count"]`` subscripts;
    * ``trips.mean("count")`` / ``.sum`` / ``.min`` / ``.max`` /
      ``.column`` — the Columnar methods whose first argument names a
      column.

    Dynamic access (variables as keys, ``select`` lists, ``getattr``)
    is deliberately invisible — the pass under-reports rather than
    false-positives.
    """
    parent_set = set(parents)
    for node in ast.walk(src.fn_def):
        if isinstance(node, ast.Subscript):
            base = node.value
            if (
                isinstance(base, ast.Attribute)
                and base.attr == "columns"
                and isinstance(base.value, ast.Name)
            ):
                base = base.value
            if isinstance(base, ast.Name) and base.id in parent_set:
                key = _subscript_key(node)
                if key is not None:
                    yield base.id, key, node
        elif isinstance(node, ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in _COLUMN_METHODS
                and isinstance(fn.value, ast.Name)
                and fn.value.id in parent_set
                and node.args
            ):
                key = _const_str(node.args[0])
                if key is not None:
                    yield fn.value.id, key, node
