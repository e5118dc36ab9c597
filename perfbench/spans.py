"""Each device operation of a traced window put down to the program span
that launched it: the port's ``lm.*`` spans (``repro_torch.telemetry.spans``)
or the job's ``score.*`` spans (``perfbench/job.py``).

The window (``perfbench/tracing.py``) keeps each operation's name and times
but not the profiler's link from a device operation to its launch, so the
pairing goes by order.  The cells run one stream, on which the device runs
its operations in the order the host launched them.  The launch calls the
host made in the window (``LAUNCHES``) are paired with the window's device
operations from the end; operations left over at the start were launched
before the window (the warm-up step issues the first traced batch) and stay
unmatched.

The anchor check holds the pairing to what is known of each launch: a
``flash_*`` kernel is launched by the port's own binding under
``lm.attention.kernel``, with no ``aten::`` op around the call, and every
other operation is launched inside an ``aten::`` op.  Where either fails the
pairing has slipped (the profiler dropped a device operation, or a launch
call is missing from ``LAUNCHES``), and ``attribute`` gives None.  A program
without the spans fails it too: its ``flash_*`` launches lie under no
``lm.attention.kernel``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Tuple

from perfbench.tracing import Op, Window, merged

#: the host calls that put an operation on the device's stream: kernel
#: launches through the CUDA runtime (``cuda*``) and its lower API
#: (``cu*``, cuBLAS's), and the copies and fills
LAUNCHES = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
    "cudaMemcpyAsync", "cudaMemsetAsync",
})
#: the spans operations are put down to
SPAN_PREFIXES = ("lm.", "score.")
#: the span of a ``flash_*`` launch
KERNEL_SPAN = "lm.attention.kernel"
UNSPANNED = "unspanned"


@dataclass
class Attribution:
    """The matched operations, each with the program spans open at its
    launch (outermost first), and the operations left unmatched."""
    matched: List[Tuple[Op, Tuple[str, ...]]]
    unmatched: List[Op]

    @property
    def matched_s(self) -> float:
        return sum(op.seconds for op, _ in self.matched)

    def share(self, name: str) -> Optional[float]:
        """The device seconds of the matched operations launched inside
        span ``name``, its children's included, over the matched seconds,
        in %; None where none was."""
        under = [op.seconds for op, path in self.matched if name in path]
        return 100.0 * sum(under) / self.matched_s if under else None


def innermost(path: Tuple[str, ...]) -> str:
    return path[-1] if path else UNSPANNED


def open_spans(spans: List[Op], times: List[float]) -> List[Tuple[str, ...]]:
    """For each of ``times`` (in order), the spans open then, outermost
    first; ``spans`` nest, as one thread's do."""
    spans = sorted(spans, key=lambda o: (o.start, -o.end))
    out: List[Tuple[str, ...]] = []
    stack: List[Op] = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end < spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        out.append(tuple(s.name for s in stack))
    return out


def inside_any(intervals: List[Tuple[float, float]], t: float) -> bool:
    """Whether ``t`` lies in one of ``intervals`` (merged, in order)."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def attribute(window: Window) -> Optional[Attribution]:
    """The window's device operations put down to their spans, or None
    where the window has none or the anchor check fails."""
    ops = sorted(window.device_ops, key=lambda o: o.start)
    calls = sorted((h for h in window.host if h.name in LAUNCHES), key=lambda o: o.start)
    n = min(len(ops), len(calls))
    if not n:
        return None
    ops_m, calls_m = ops[len(ops) - n:], calls[len(calls) - n:]
    times = [c.start for c in calls_m]
    paths = open_spans([h for h in window.host if h.name.startswith(SPAN_PREFIXES)], times)
    aten = merged([h for h in window.host if h.name.startswith("aten::")])
    for op, t, path in zip(ops_m, times, paths):
        in_aten = inside_any(aten, t)
        if "flash_" in op.name:
            if in_aten or innermost(path) != KERNEL_SPAN:
                return None
        elif not in_aten:
            return None
    return Attribution(matched=list(zip(ops_m, paths)), unmatched=ops[:len(ops) - n])


def share(window: Window, name: str) -> Optional[float]:
    """The share (%) of the matched device time launched inside span
    ``name``; None where ``attribute`` gives None or nothing ran there."""
    found = attribute(window)
    return None if found is None else found.share(name)

