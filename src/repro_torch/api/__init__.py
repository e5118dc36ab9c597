"""The unified SDK facade — ``repro_torch.Client`` and the decorator surface.

Everything user code needs lives here; the subsystem packages
(``repro_torch.core``, ``repro_torch.catalog``, ``repro_torch.table``, ``repro_torch.runtime``,
``repro_torch.maintenance``) are the engine room.
"""
from repro_torch.analysis import Finding, LintFailed, LintReport, Severity
from repro_torch.api.client import BranchHandle, CacheMaintenance, Client
from repro_torch.api.handles import AsyncRunHandle, RunFailed, RunHandle, RunState
from repro_torch.api.project import (
    Project,
    RedefinitionWarning,
    discover,
    expectation,
    model,
    project,
    requirements,
    resolve_pipeline,
    sql,
)

__all__ = [
    "AsyncRunHandle",
    "BranchHandle",
    "CacheMaintenance",
    "Client",
    "Finding",
    "LintFailed",
    "LintReport",
    "Project",
    "RedefinitionWarning",
    "RunFailed",
    "RunHandle",
    "RunState",
    "Severity",
    "discover",
    "expectation",
    "model",
    "project",
    "requirements",
    "resolve_pipeline",
    "sql",
]
