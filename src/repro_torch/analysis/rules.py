"""Cache-poison / nondeterminism rules over node function ASTs (D1xx).

Why these exist: the differential cache keys node results on
*code + inputs + params*.  "FaaS and Furious" shows that only pays off
when node functions are pure — a node that reads the wall clock, draws
unseeded randomness, or peeks at the environment produces different
output under the SAME fingerprint, so a warm cache silently serves stale
(or simply wrong) artifacts.  These rules flag the constructs *before*
a run instead of after a confusing replay mismatch.

Each rule is data (id, severity, summary, example) so the CLI/README rule
catalog is generated from the same table the engine matches against.
Suppress a deliberate use with ``# repro: noqa[D102]`` on the offending
line (see astpass.py).

Node functions in this package compute with torch, so D102 also flags
torch's draws from its global stream — ``torch.rand``, ``randn``,
``randint``, ``randperm``, ``normal``, ``bernoulli``, ``multinomial``
and the ``*_like`` forms — called without ``generator=``.  The numpy and
``jax.random`` matches are the JAX package's, so both packages report
the same findings on numpy code.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import (
    Callable, Dict, Iterator, List, Optional, Set, Tuple, TYPE_CHECKING,
)

from repro_torch.analysis.astpass import (
    FnSource, dotted_name, line_suppresses, load_fn_source, root_name,
)
from repro_torch.analysis.report import Finding, Severity

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.pipeline import Pipeline


@dataclass(frozen=True)
class Rule:
    id: str
    severity: Severity
    summary: str
    example: str
    suppression: str = "# repro: noqa[<id>]"


FUNCTION_RULES: Tuple[Rule, ...] = (
    Rule(
        "D101", Severity.WARNING,
        "wall-clock read — time/datetime calls make node output "
        "run-dependent, poisoning its cache fingerprint",
        "ts = time.time()",
    ),
    Rule(
        "D102", Severity.WARNING,
        "unseeded randomness — random/np.random without an explicit seed "
        "produces different artifacts under the same fingerprint",
        "rng = np.random.default_rng()  # no seed",
    ),
    Rule(
        "D103", Severity.WARNING,
        "uuid generation — uuids are fresh every run; derive ids from "
        "content hashes instead",
        "uuid.uuid4()",
    ),
    Rule(
        "D104", Severity.WARNING,
        "environment read — os.environ/os.getenv smuggles config past the "
        "fingerprint; pass it through run params instead",
        "os.environ['MODE']",
    ),
    Rule(
        "D105", Severity.WARNING,
        "file I/O — reading/writing paths bypasses the versioned lake; "
        "inputs must come from parent tables",
        "open('side_channel.csv')",
    ),
    Rule(
        "D106", Severity.WARNING,
        "global-state mutation — global/nonlocal writes leak state "
        "between stages and across fused plans",
        "global counter",
    ),
    Rule(
        "D107", Severity.WARNING,
        "input-table mutation — writing into a parent relation corrupts "
        "siblings that fuse over the same in-memory input",
        "trips.columns['count'] = fixed",
    ),
)

RULES_BY_ID = {r.id: r for r in FUNCTION_RULES}

# ------------------------------------------------------------- matchers
_TIME_CALLS = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
}
_TIME_ATTRS = {"now", "utcnow", "today"}  # datetime.now / date.today / ...
_SEEDLESS_OK = {"seed", "default_rng", "Generator", "SeedSequence", "PRNGKey"}
_UUID_CALLS = {"uuid1", "uuid3", "uuid4", "uuid5"}
_IO_METHODS = {"read_text", "read_bytes", "write_text", "write_bytes"}
_NP_IO = {"np.load", "np.save", "np.savez", "numpy.load", "numpy.save"}
#: torch draws that read the global stream unless given ``generator=``
_TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
}


def _call_findings(
    node: ast.Call, parents: Tuple[str, ...]
) -> Iterator[Tuple[str, str]]:
    """Yield ``(rule_id, detail)`` for one call site."""
    name = dotted_name(node.func)
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else None

    if name in _TIME_CALLS or (
        name is not None
        and attr in _TIME_ATTRS
        and ("datetime" in name or name.split(".")[0] in ("date", "dt"))
    ):
        yield "D101", f"calls {name}()"
        return
    if name is not None:
        head, _, tail = name.partition(".")
        if head == "random" and tail and tail not in ("seed", "Random"):
            yield "D102", f"calls {name}() (seed the generator instead)"
            return
        if name.startswith(("np.random.", "numpy.random.", "jax.random.")):
            # np.random.<fn> legacy globals; a local Generator's .random()
            # is NOT matched — the seed (or lack of it) lives at its
            # default_rng() construction site, flagged there instead
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "default_rng":
                if not node.args and not node.keywords:
                    yield "D102", f"{name}() called without a seed"
                return
            if leaf not in _SEEDLESS_OK:
                yield "D102", f"calls {name}() (global unseeded stream)"
                return
        if (
            head == "torch"
            and tail in _TORCH_DRAWS
            and not any(k.arg == "generator" for k in node.keywords)
        ):
            yield "D102", f"calls {name}() without generator= (global stream)"
            return
        if name.rsplit(".", 1)[-1] in _UUID_CALLS and head in ("uuid",):
            yield "D103", f"calls {name}()"
            return
        if name in ("os.getenv", "os.environ.get"):
            yield "D104", f"calls {name}()"
            return
        if name in _NP_IO:
            yield "D105", f"calls {name}()"
            return
    if isinstance(node.func, ast.Name) and node.func.id == "open":
        yield "D105", "calls open()"
        return
    if attr in _IO_METHODS:
        yield "D105", f"calls .{attr}()"


def _env_read(node: ast.AST) -> bool:
    """Bare ``os.environ`` access (subscript or attribute load)."""
    return dotted_name(node) == "os.environ"


def run_function_rules(
    src: FnSource,
    node_name: str,
    parents: Tuple[str, ...],
) -> Tuple[List[Finding], int]:
    """All D-rule findings for one node function; returns
    ``(findings, suppressed_count)``."""
    findings: List[Finding] = []
    suppressed = 0
    seen = set()  # (rule, line): os.environ.get fires call+attr matchers

    def emit(rule_id: str, detail: str, at: ast.AST) -> None:
        nonlocal suppressed
        line = src.abs_line(at)
        if (rule_id, line) in seen:
            return
        seen.add((rule_id, line))
        if src.suppressed(rule_id, line):
            suppressed += 1
            return
        rule = RULES_BY_ID[rule_id]
        findings.append(
            Finding(
                rule=rule.id,
                severity=rule.severity,
                message=f"{rule.summary.split(' — ')[0]}: {detail}",
                node=node_name,
                file=src.file,
                line=line,
                snippet=src.snippet(at),
            )
        )

    parent_set = set(parents)
    for stmt in ast.walk(src.fn_def):
        if isinstance(stmt, ast.Call):
            for rule_id, detail in _call_findings(stmt, parents):
                emit(rule_id, detail, stmt)
        elif isinstance(stmt, (ast.Global, ast.Nonlocal)):
            kw = "global" if isinstance(stmt, ast.Global) else "nonlocal"
            emit("D106", f"{kw} {', '.join(stmt.names)}", stmt)
        elif isinstance(stmt, ast.Subscript) and isinstance(
            stmt.ctx, (ast.Store, ast.Del)
        ):
            base = root_name(stmt)
            if base in parent_set:
                emit("D107", f"writes into input table {base!r}", stmt)
        elif isinstance(stmt, ast.Attribute):
            if isinstance(stmt.ctx, (ast.Store, ast.Del)):
                base = root_name(stmt)
                if base in parent_set:
                    emit("D107", f"writes attribute of input table {base!r}", stmt)
            elif _env_read(stmt):
                emit("D104", "reads os.environ", stmt)
    return findings, suppressed


# ===================================================================
# C-rules: concurrency hazards under the wave scheduler (parallelism>1)
# ===================================================================
#
# The async runner executes every node of a wave concurrently.  Two nodes
# are *co-schedulable* when neither is an ancestor of the other inside
# the pipeline — the scheduler is free to run them in the same wave, in
# either order, so any state they share outside the dataflow is a
# nondeterminism hazard the cache fingerprint cannot see.

CONCURRENCY_RULES: Tuple[Rule, ...] = (
    Rule(
        "C501", Severity.WARNING,
        "artifact shadows a lake table — a node materializes a name that "
        "already exists in the catalog, so parents elsewhere silently "
        "bind to the node output (or the table) depending on run order",
        'p.sql("orders", ...)  # "orders" is already a catalog table',
    ),
    Rule(
        "C502", Severity.WARNING,
        "co-schedulable nodes mutate the same global — at parallelism > 1 "
        "the fan-in order is scheduler-dependent, so the final state (and "
        "anything derived from it) is nondeterministic",
        "SEEN.append(...)  # in two nodes with no dependency path",
    ),
    Rule(
        "C503", Severity.WARNING,
        "co-schedulable global write/read — a node reads a global another "
        "node in the same wave mutates; the value observed depends on "
        "scheduling, not on the dataflow",
        "acc = TOTALS['x']  # while a sibling node writes TOTALS",
    ),
)

CONCURRENCY_RULES_BY_ID = {r.id: r for r in CONCURRENCY_RULES}

#: container-mutating method names — calling one on a *free* name whose
#: module-level binding is a mutable container counts as a global write
_MUTATOR_METHODS = {
    "append", "add", "update", "extend", "insert", "setdefault",
    "pop", "popitem", "clear", "remove", "discard",
}
_MUTABLE_CONTAINERS = (list, dict, set, bytearray)


def _local_names(fn_def: ast.FunctionDef) -> Set[str]:
    """Names bound inside the function — params plus every Name store
    (assignments, for targets, with-as, comprehensions, imports)."""
    a = fn_def.args
    out: Set[str] = {
        p.arg
        for p in (
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
            + ([a.vararg] if a.vararg else [])
            + ([a.kwarg] if a.kwarg else [])
        )
    }
    for n in ast.walk(fn_def):
        if isinstance(n, ast.Name) and isinstance(n.ctx, (ast.Store, ast.Del)):
            out.add(n.id)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for alias in n.names:
                out.add((alias.asname or alias.name).split(".")[0])
    # names declared ``global`` are explicitly NOT local
    for n in ast.walk(fn_def):
        if isinstance(n, ast.Global):
            out -= set(n.names)
    return out


@dataclass
class _GlobalUse:
    """Statically-visible shared-state traffic of one node function."""

    node: str
    fn: Callable
    src: FnSource
    writes: Dict[str, ast.AST] = field(default_factory=dict)
    reads: Dict[str, ast.AST] = field(default_factory=dict)


def _global_uses(name: str, fn: Callable) -> Optional[_GlobalUse]:
    src = load_fn_source(fn)
    if src is None:
        return None
    use = _GlobalUse(node=name, fn=fn, src=src)
    local = _local_names(src.fn_def)
    fglobals = getattr(fn, "__globals__", {})

    def free(n: str) -> bool:
        return n not in local

    for n in ast.walk(src.fn_def):
        if isinstance(n, ast.Global):
            for g in n.names:
                use.writes.setdefault(g, n)
        elif isinstance(n, (ast.Subscript, ast.Attribute)) and isinstance(
            n.ctx, (ast.Store, ast.Del)
        ):
            base = root_name(n)
            if base and free(base):
                use.writes.setdefault(base, n)
        elif isinstance(n, ast.Call):
            f = n.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATOR_METHODS
                and isinstance(f.value, ast.Name)
                and free(f.value.id)
                and isinstance(
                    fglobals.get(f.value.id), _MUTABLE_CONTAINERS
                )
            ):
                use.writes.setdefault(f.value.id, n)
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            if free(n.id):
                use.reads.setdefault(n.id, n)
    return use


def _pipeline_ancestors(pipeline: "Pipeline") -> Dict[str, Set[str]]:
    """Transitive in-pipeline ancestors per node (catalog parents are
    not edges; cycles — G302's problem — are guarded, not reported)."""
    anc: Dict[str, Set[str]] = {}

    def visit(name: str, stack: Set[str]) -> Set[str]:
        if name in anc:
            return anc[name]
        out: Set[str] = set()
        node = pipeline.nodes.get(name)
        if node is not None:
            for p in node.parents:
                if p in pipeline.nodes and p not in stack:
                    out.add(p)
                    out |= visit(p, stack | {name})
        anc[name] = out
        return out

    for n in pipeline.nodes:
        visit(n, {n})
    return anc


def _shares_binding(fa: Callable, fb: Callable, name: str) -> bool:
    """Do two functions see the SAME object under ``name``?  Identity
    when both modules bind it; same-module fallback otherwise (a name
    declared ``global`` may not be bound yet at lint time)."""
    ga = getattr(fa, "__globals__", {})
    gb = getattr(fb, "__globals__", {})
    if name in ga and name in gb:
        return ga[name] is gb[name]
    return ga is gb


def run_concurrency_rules(
    pipeline: "Pipeline",
    *,
    catalog_tables: Optional[Set[str]] = None,
) -> Tuple[List[Finding], int]:
    """All C-rule findings for a pipeline; ``(findings, suppressed)``.

    ``catalog_tables`` (names present at the lint branch head) powers
    C501; without it only the shared-global rules run.
    """
    findings: List[Finding] = []
    suppressed = 0

    def emit(
        rule_id: str,
        message: str,
        *,
        node: str,
        file: Optional[str],
        line: Optional[int],
        snippet: Optional[str],
        hint: str,
        src: Optional[FnSource] = None,
    ) -> None:
        nonlocal suppressed
        if src is not None and line is not None:
            if src.suppressed(rule_id, line):
                suppressed += 1
                return
        elif line_suppresses(file, line, rule_id):
            suppressed += 1
            return
        rule = CONCURRENCY_RULES_BY_ID[rule_id]
        findings.append(
            Finding(
                rule=rule.id,
                severity=rule.severity,
                message=message,
                node=node,
                file=file,
                line=line,
                snippet=snippet,
                hint=hint,
            )
        )

    # ------------------------------------------ C501: lake-table shadowing
    for node in pipeline.nodes.values():
        if node.is_expectation:
            continue
        if catalog_tables and node.name in catalog_tables:
            emit(
                "C501",
                f"artifact {node.name!r} shadows a lake table of the same "
                "name — siblings reading it bind to the node output, while "
                "anything planned before this node ran reads the table",
                node=node.name,
                file=node.source_file,
                line=node.source_line,
                snippet=None,
                hint=f"rename the artifact (e.g. {node.name + '_v2'!r}) or "
                "drop the catalog table first",
            )

    # ------------------------- C502/C503: shared globals across one wave
    uses = [
        u
        for n in pipeline.nodes.values()
        if n.fn is not None
        for u in (_global_uses(n.name, n.fn),)
        if u is not None
    ]
    if len(uses) < 2:
        return findings, suppressed
    anc = _pipeline_ancestors(pipeline)
    reported: Set[Tuple[frozenset, str]] = set()
    for i, ua in enumerate(uses):
        for ub in uses[i + 1:]:
            if ua.node in anc.get(ub.node, set()) or ub.node in anc.get(
                ua.node, set()
            ):
                continue  # ordered by the DAG — not co-schedulable
            pair = frozenset((ua.node, ub.node))
            # both write -> C502 (covers the read side too)
            for g in sorted(set(ua.writes) & set(ub.writes)):
                if not _shares_binding(ua.fn, ub.fn, g):
                    continue
                reported.add((pair, g))
                at = ua.writes[g]
                emit(
                    "C502",
                    f"nodes {ua.node!r} and {ub.node!r} both mutate shared "
                    f"global {g!r} and neither depends on the other — at "
                    "parallelism > 1 the final state depends on scheduler "
                    "fan-in order",
                    node=ua.node,
                    file=ua.src.file,
                    line=ua.src.abs_line(at),
                    snippet=ua.src.snippet(at),
                    hint=f"thread the state through an artifact (return it "
                    f"from one node, take it as a parent in the other) "
                    f"instead of module global {g!r}",
                    src=ua.src,
                )
            # one writes, the other reads -> C503
            for writer, reader in ((ua, ub), (ub, ua)):
                for g in sorted(set(writer.writes) & set(reader.reads)):
                    if (pair, g) in reported:
                        continue
                    if not _shares_binding(writer.fn, reader.fn, g):
                        continue
                    reported.add((pair, g))
                    at = writer.writes[g]
                    emit(
                        "C503",
                        f"node {reader.node!r} reads global {g!r} while "
                        f"co-schedulable node {writer.node!r} mutates it — "
                        "the value observed depends on scheduling, not on "
                        "the dataflow",
                        node=writer.node,
                        file=writer.src.file,
                        line=writer.src.abs_line(at),
                        snippet=writer.src.snippet(at),
                        hint=f"make {reader.node!r} a downstream consumer "
                        f"of the node that owns {g!r}, or freeze the value "
                        "into run params",
                        src=writer.src,
                    )
    return findings, suppressed
