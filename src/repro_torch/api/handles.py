"""Typed run results — one handle, three states, lazy artifact reads.

``Client.run`` (and ``BranchHandle.run``) always hands back a
``RunHandle`` instead of the legacy mix of ``RunResult`` on success and
``ExpectationFailed`` raised on audit failure:

* ``SUCCESS``       — transform-audit-write completed, merged_commit set;
* ``AUDIT_FAILED``  — an expectation failed, the ephemeral branch was
  rolled back, nothing merged (a *domain outcome*, not an exception);
* ``ERROR``         — the run itself blew up (infrastructure/user code);
  raised by default, captured into a handle with ``raise_errors=False``.

``artifact(name)`` reads lazily through the table format — nothing is
deserialized until asked for.

``Client.run_async`` returns an ``AsyncRunHandle`` instead: a future-like
wrapper (``.state`` reads ``RUNNING`` until resolution, ``.poll()`` is
the non-blocking probe, ``.result()`` the blocking join) that resolves to
exactly the same typed ``RunHandle``.
"""
from __future__ import annotations

import concurrent.futures as cf
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.physical import PhysicalPlan
from repro_torch.table.format import TableFormat


class RunState(str, enum.Enum):
    SUCCESS = "SUCCESS"
    AUDIT_FAILED = "AUDIT_FAILED"
    ERROR = "ERROR"
    #: an async run still executing (``AsyncRunHandle.state`` only —
    #: a resolved ``RunHandle`` is always one of the three final states)
    RUNNING = "RUNNING"

    def __str__(self) -> str:  # `print(handle.state)` reads cleanly
        return self.value


class RunFailed(RuntimeError):
    """Raised by ``RunHandle.raise_for_state()`` on a non-SUCCESS handle."""

    def __init__(self, handle: "RunHandle"):
        detail = (
            f"failed checks: {handle.failed_checks}"
            if handle.state is RunState.AUDIT_FAILED
            else repr(handle.error)
        )
        super().__init__(f"run {handle.run_id}: {handle.state} ({detail})")
        self.handle = handle


@dataclass
class RunHandle:
    """Everything a caller can ask about one run, success or not."""

    state: RunState
    run_id: int
    branch: str
    merged_commit: Optional[str]
    #: artifact name -> snapshot manifest key (content-addressed)
    artifacts: Dict[str, str] = field(default_factory=dict)
    checks: Dict[str, bool] = field(default_factory=dict)
    stats: Dict[str, Any] = field(default_factory=dict)
    plan: Optional[PhysicalPlan] = None
    #: set when this handle replays an earlier run (never merges)
    replay_of: Optional[int] = None
    #: the captured exception for ERROR handles
    error: Optional[BaseException] = None
    #: reader for lazy artifact access (bound by the Client)
    _fmt: Optional[TableFormat] = None
    #: run-log reader for trace() (bound by the Client when telemetry on)
    _runlog: Optional[Any] = None

    # ------------------------------------------------------------- status
    @property
    def ok(self) -> bool:
        return self.state is RunState.SUCCESS

    @property
    def failed_checks(self) -> List[str]:
        return sorted(k for k, v in self.checks.items() if not v)

    def raise_for_state(self) -> "RunHandle":
        """Raise ``RunFailed`` unless the run succeeded; chainable."""
        if self.state is not RunState.SUCCESS:
            if self.error is not None:
                raise RunFailed(self) from self.error
            raise RunFailed(self)
        return self

    # --------------------------------------------------------------- data
    @property
    def cache(self) -> Dict[str, Any]:
        """Node-level cache accounting (hits/rehydrated/elided/...)."""
        return dict(self.stats.get("cache", {}))

    @property
    def io(self) -> Dict[str, int]:
        """Object-store traffic this run moved (bytes/puts/gets deltas)."""
        return dict(self.stats.get("io", {}))

    def artifact(self, name: str) -> Dict[str, np.ndarray]:
        """Lazily read one produced artifact as columnar numpy arrays.

        Works for merged runs and replays; for an AUDIT_FAILED run the
        manifest keys still resolve until a GC sweep reclaims the rolled-
        back blobs (they are not rooted by any branch).
        """
        if name not in self.artifacts:
            raise KeyError(
                f"run {self.run_id} produced no artifact {name!r} "
                f"(have {sorted(self.artifacts)})"
            )
        if self._fmt is None:
            raise RuntimeError("handle is not bound to a table format")
        return self._fmt.read(self._fmt.load_snapshot(self.artifacts[name]))

    # ------------------------------------------------------- observability
    def trace(self) -> Any:
        """This run's :class:`repro_torch.telemetry.tracing.RunTrace` — the
        span tree (run → stage → node/scan) assembled from the persisted
        run log, with queue/exec/commit breakdown, critical path and
        Chrome-trace export.  Works for every final state (a failed audit
        still records its trace).
        """
        if self._runlog is None:
            raise RuntimeError(
                "handle is not bound to a run log (telemetry disabled?)"
            )
        from repro_torch.telemetry.tracing import RunTrace

        return RunTrace.from_events(
            self._runlog.get(self.run_id), run_id=self.run_id
        )

    def __repr__(self) -> str:
        merged = (
            self.merged_commit[:12] if self.merged_commit else None
        )
        return (
            f"RunHandle(run_id={self.run_id}, state={self.state}, "
            f"branch={self.branch!r}, merged={merged}, "
            f"artifacts={sorted(self.artifacts)})"
        )


class AsyncRunHandle:
    """Future-like handle for ``Client.run_async`` (paper Table 1).

    The run executes on a background thread; this handle wraps its
    future.  ``state`` is ``RunState.RUNNING`` until the run resolves,
    then the underlying ``RunHandle``'s state (``SUCCESS`` /
    ``AUDIT_FAILED`` / ``ERROR``) — same semantics as a synchronous run.
    ``poll()`` is the non-blocking probe (``None`` while running),
    ``result()`` the blocking join.
    """

    def __init__(self, future: "cf.Future[RunHandle]", *, branch: str):
        self._future = future
        self.branch = branch

    # ------------------------------------------------------------- status
    def done(self) -> bool:
        return self._future.done()

    @property
    def state(self) -> RunState:
        """Non-blocking: RUNNING until resolved, then the final state."""
        if not self._future.done():
            return RunState.RUNNING
        if self._future.exception() is not None:
            # run_async(raise_errors=True) let an infra error escape; the
            # exception itself surfaces on result()
            return RunState.ERROR
        return self._future.result().state

    @property
    def running(self) -> bool:
        return not self._future.done()

    # -------------------------------------------------------------- joins
    def poll(self) -> Optional[RunHandle]:
        """The resolved ``RunHandle``, or ``None`` while still running.
        Re-raises the run's exception if one escaped capture."""
        if not self._future.done():
            return None
        return self._future.result()

    def result(self, timeout: Optional[float] = None) -> RunHandle:
        """Block until the run resolves and return its ``RunHandle``
        (raises ``concurrent.futures.TimeoutError`` on timeout)."""
        return self._future.result(timeout)

    def raise_for_state(self) -> RunHandle:
        """Block, then raise ``RunFailed`` unless the run succeeded."""
        return self.result().raise_for_state()

    def trace(self) -> Any:
        """Block until resolved, then the run's trace (``RunHandle.trace``)."""
        return self.result().trace()

    def __repr__(self) -> str:
        if not self._future.done():
            return f"AsyncRunHandle(branch={self.branch!r}, state=RUNNING)"
        return f"AsyncRunHandle(resolved={self.poll()!r})"
