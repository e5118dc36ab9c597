"""The rule catalog, generated from the registries the engine matches.

One source of truth: the D/T/C rules are :class:`Rule` tuples in
:mod:`repro_torch.analysis.rules` / :mod:`repro_torch.analysis.types`, the L/G rules
live in :data:`repro_torch.analysis.lint.GRAPH_RULES`, and the R route checks
in :data:`repro_torch.engine.route.ROUTE_CHECKS`.  The README's "Preflight
checks" section embeds :func:`rule_catalog_markdown` output between
markers, and a test asserts the embedded text equals the generated text
— documentation cannot drift from what the analyzer actually fires.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.lint import GRAPH_RULES
from repro_torch.analysis.report import Severity
from repro_torch.analysis.rules import CONCURRENCY_RULES, FUNCTION_RULES
from repro_torch.analysis.types import TYPE_RULES
from repro_torch.engine.route import ROUTE_CHECKS

#: markers the README embeds the generated catalog between
CATALOG_BEGIN = "<!-- rule-catalog:begin (generated; do not edit) -->"
CATALOG_END = "<!-- rule-catalog:end -->"

#: severities the lint orchestrator assigns to graph/lineage findings
#: (lint.py emits these inline; mirrored here for the catalog only)
_GRAPH_SEVERITY = {
    "L001": Severity.ERROR,
    "L002": Severity.ERROR,
    "L003": Severity.ERROR,
    "L004": Severity.ERROR,
    "G301": Severity.WARNING,
    "G302": Severity.ERROR,
    "G303": Severity.WARNING,
    "G304": Severity.WARNING,
}


def rule_catalog_markdown() -> str:
    """The full preflight rule catalog as a markdown fragment."""
    lines: List[str] = [
        "| id | severity | checks for |",
        "|----|----------|------------|",
    ]
    for rid in sorted(GRAPH_RULES):
        lines.append(
            f"| `{rid}` | {_GRAPH_SEVERITY[rid].value} | {GRAPH_RULES[rid]} |"
        )
    for rule in FUNCTION_RULES + TYPE_RULES + CONCURRENCY_RULES:
        summary = rule.summary.replace("\n", " ")
        lines.append(f"| `{rule.id}` | {rule.severity.value} | {summary} |")
    lines += [
        "",
        "Suppress a deliberate use with `# repro: noqa[RULE]` on the "
        "offending line (D rules: inside the function body; T/C rules: "
        "on the node registration line); bare `# repro: noqa` silences "
        "every rule on that line.",
        "",
        "**Route checks** — the eligibility checks `repro explain` "
        "reports per query (`R` ids in a route trace; these explain the "
        "kernel-vs-jnp verdict rather than gate a run):",
        "",
        "| id | check | verifies |",
        "|----|-------|----------|",
    ]
    for rid in sorted(ROUTE_CHECKS):
        slug, what, _hint = ROUTE_CHECKS[rid]
        lines.append(f"| `{rid}` | {slug} | {what} |")
    return "\n".join(lines)
