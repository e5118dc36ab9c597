"""Typed lint results — findings, severities, and the report surface.

A ``LintReport`` is the static-analysis analog of a ``RunHandle``: one
typed object carrying everything the preflight pass found, consumable by
the SDK (``client.lint``), the CLI (``repro lint [--strict] [--json]``)
and the run gate (``Client.run(..., preflight=True)``).  Findings are
data, not log lines: each one names the rule that fired, the node it
fired on, and the ``file:line`` the user has to edit.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class Severity(str, enum.Enum):
    ERROR = "error"      # the run WILL fail (or silently corrupt) — gate it
    WARNING = "warning"  # likely footgun (cache poison, redefinition, ...)
    INFO = "info"        # diagnostics; never gates anything

    def __str__(self) -> str:
        return self.value


#: sort key: errors first, info last
_RANK = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}


@dataclass(frozen=True)
class Finding:
    """One rule firing at one location."""

    rule: str            # catalog id, e.g. "L001", "D102"
    severity: Severity
    message: str
    node: Optional[str] = None        # pipeline node the finding is about
    file: Optional[str] = None        # source file (decoration/definition site)
    line: Optional[int] = None        # 1-based line within ``file``
    #: the offending fragment — a source line, or the SQL slice at the
    #: parser/lineage position — so reports read without opening the file
    snippet: Optional[str] = None
    #: a concrete fix for THIS firing ("cast zone to int32"), when the
    #: rule can name one — rendered after the message, carried in JSON
    hint: Optional[str] = None

    @property
    def location(self) -> str:
        if self.file is None:
            return "<unknown>"
        return f"{self.file}:{self.line}" if self.line else self.file

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity.value,
            "message": self.message,
            "node": self.node,
            "file": self.file,
            "line": self.line,
            "snippet": self.snippet,
            "hint": self.hint,
        }

    def describe(self) -> str:
        loc = f"{self.location}  " if self.file else ""
        node = f"[{self.node}] " if self.node else ""
        out = f"{self.severity.value.upper():<7} {self.rule}  {loc}{node}{self.message}"
        if self.snippet:
            out += f"\n        > {self.snippet.strip()}"
        if self.hint:
            out += f"\n        fix: {self.hint}"
        return out


@dataclass
class LintReport:
    """Everything the static preflight pass found — zero execution behind it."""

    pipeline: str
    findings: List[Finding] = field(default_factory=list)
    #: node -> downstream nodes whose transitive cache fingerprint changes
    #: when the node's code is edited (the cache-invalidation blast radius)
    blast_radius: Dict[str, List[str]] = field(default_factory=dict)
    #: findings silenced by ``# repro: noqa[RULE]`` comments
    suppressed: int = 0

    def __post_init__(self) -> None:
        self.findings.sort(
            key=lambda f: (_RANK[f.severity], f.file or "", f.line or 0, f.rule)
        )

    # -------------------------------------------------------------- status
    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.WARNING]

    def ok(self, *, strict: bool = False) -> bool:
        """Clean enough to launch?  ``strict`` also counts warnings."""
        if self.errors:
            return False
        return not (strict and self.warnings)

    def by_rule(self, rule: str) -> List[Finding]:
        return [f for f in self.findings if f.rule == rule]

    # ------------------------------------------------------------ rendering
    def describe(self) -> str:
        lines = [
            f"lint report for {self.pipeline!r}: "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)"
            + (f", {self.suppressed} suppressed" if self.suppressed else "")
        ]
        for f in self.findings:
            lines.append("  " + f.describe().replace("\n", "\n  "))
        if self.blast_radius:
            lines.append("  cache blast radius (edit -> recompute):")
            for name, downstream in self.blast_radius.items():
                lines.append(
                    f"    {name}: {len(downstream)} downstream node(s)"
                    + (f" {downstream}" if downstream else "")
                )
        return "\n".join(lines)

    def to_json_dict(self) -> Dict[str, Any]:
        return {
            "pipeline": self.pipeline,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "suppressed": self.suppressed,
            "findings": [f.to_json_dict() for f in self.findings],
            "blast_radius": {k: list(v) for k, v in self.blast_radius.items()},
        }


class LintFailed(RuntimeError):
    """Raised when ``Client.run(..., preflight=True)`` refuses to launch.

    Carries the full ``LintReport`` so callers can render the findings
    (the CLI prints them; tests assert on them) without re-linting.
    """

    def __init__(self, report: LintReport):
        blocking = report.errors
        super().__init__(
            f"preflight found {len(blocking)} error(s) in "
            f"{report.pipeline!r} — run refused: "
            + "; ".join(f"{f.rule} {f.message}" for f in blocking[:3])
            + (" ..." if len(blocking) > 3 else "")
        )
        self.report = report
