"""Static pipeline analysis — lineage, cache-poison rules, plan diagnostics.

Everything in this package runs with zero execution and zero store
writes: the inputs are a resolved :class:`~repro_torch.core.pipeline.Pipeline`
and (optionally) catalog schemas plus already-loaded snapshot metadata;
the outputs are a typed :class:`LintReport` and — for the explain plane
— :class:`ExplainedQuery` / :class:`PipelineExplanation`.
"""
from repro_torch.analysis.catalog import rule_catalog_markdown
from repro_torch.analysis.explain import (
    ExplainedNode,
    ExplainedQuery,
    PipelineExplanation,
    explain_pipeline,
    explain_query,
)
from repro_torch.analysis.lint import GRAPH_RULES, lint_pipeline
from repro_torch.analysis.report import Finding, LintFailed, LintReport, Severity
from repro_torch.analysis.rules import (
    CONCURRENCY_RULES,
    FUNCTION_RULES,
    RULES_BY_ID,
    Rule,
    run_concurrency_rules,
)
from repro_torch.analysis.types import TYPE_RULES, query_type_findings

__all__ = [
    "CONCURRENCY_RULES",
    "ExplainedNode",
    "ExplainedQuery",
    "Finding",
    "FUNCTION_RULES",
    "GRAPH_RULES",
    "LintFailed",
    "LintReport",
    "PipelineExplanation",
    "Rule",
    "RULES_BY_ID",
    "Severity",
    "TYPE_RULES",
    "explain_pipeline",
    "explain_query",
    "lint_pipeline",
    "query_type_findings",
    "rule_catalog_markdown",
    "run_concurrency_rules",
]
