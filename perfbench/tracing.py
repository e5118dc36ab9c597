"""The traced run: ``torch.profiler`` over a few batches of the closed loop,
reduced to a window that the per-layer readers read.

The profiler's schedule gives one warm-up step, whose events are thrown
away (the profiler has been seen to drop the first kernels of a window),
then ``active`` steps; a step ends when a batch's scores reach the host.
The window runs from the first active step's start to the last one's end,
on the profiler's clock, which the host's and the card's events share.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from perfbench import roofline

#: host gaps shorter than this between two device operations are launch
#: latency; they are summed under one label, not looked up
SHORT_GAP_S = 20e-6
#: entries kept in each list of the breakdown
TOP = 10


@dataclass(frozen=True)
class Op:
    name: str
    start: float  # seconds on the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Work:
    """What one batch asks of the card, as the cell's model module counts
    it; ``flash_launch_bound_s`` is None for a model with no flash launch."""
    batch_flops: float
    flash_launch_bound_s: Optional[float]
    peak_flops: float = roofline.PEAK_BF16_FLOPS


@dataclass
class Window:
    """What the readers see: the traced span, the device's operations that
    began in it (kernels, and copies and fills apart, each whole), the
    host's spans and calls, and the work of a batch."""
    start: float
    window_s: float
    batches: int
    work: Work
    kernels: List[Op] = field(default_factory=list)
    transfers: List[Op] = field(default_factory=list)
    host: List[Op] = field(default_factory=list)

    @property
    def end(self) -> float:
        return self.start + self.window_s

    @property
    def device_ops(self) -> List[Op]:
        return self.kernels + self.transfers

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device
        (the union of their intervals)."""
        return sum(b - a for a, b in merged(self.device_ops, self.end))


def merged(ops: List[Op], end: float = float("inf")) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, cut at ``end``, in order."""
    spans: List[Tuple[float, float]] = []
    for op in sorted(ops, key=lambda o: o.start):
        op = Op(op.name, op.start, min(op.end, end))
        if spans and op.start <= spans[-1][1]:
            spans[-1] = (spans[-1][0], max(spans[-1][1], op.end))
        else:
            spans.append((op.start, op.end))
    return spans


def is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_annotation(e) -> bool:
    """A span of the host's (``score.*``, ``ProfilerStep#``) that the
    profiler also draws on the device's timeline: no device work."""
    return getattr(e, "is_user_annotation", False) or e.name.startswith(
        ("score.", "ProfilerStep#"))


def from_profile(events, batches: int, work: Work) -> Window:
    """The window of a finished ``torch.profiler.profile``'s events."""
    steps = [e for e in events if e.name.startswith("ProfilerStep#")]
    span = steps or list(events)
    lo = min(e.time_range.start for e in span) / 1e6
    hi = max(e.time_range.end for e in span) / 1e6
    window = Window(start=lo, window_s=hi - lo, batches=batches, work=work)
    for e in events:
        op = Op(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type.name == "CUDA":
            if lo <= op.start < hi and not is_annotation(e):
                (window.transfers if is_transfer(e.name) else window.kernels).append(op)
        elif op.end > lo and op.start < hi and not e.name.startswith("ProfilerStep#"):
            window.host.append(op)
    return window


#: wrappers around the functor that says what a PyTorch kernel computes
_WRAPPERS = {"BinaryFunctor", "gpu_kernel_impl", "gpu_kernel_impl_nocast", "ReduceOp",
             "AUnaryFunctor", "BUnaryFunctor"}


def short_name(name: str) -> str:
    """A device operation's name without its arguments: ``flash_wgmma<bf16,
    128>`` for the port's kernels, a library's own name for its kernels,
    and for PyTorch's templated kernels the kernel with the functor or copy
    it runs (``elementwise_kernel MulFunctor<float>``)."""
    if is_transfer(name):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    m = re.match(r"(?:\w+::)*(\w+)<([^<>]*)>\(", name)
    if m:
        types = {"__nv_bfloat16": "bf16", "__half": "f16", "float": "f32"}
        args = [types.get(a.strip(), a.strip().replace("(int)", ""))
                for a in m.group(2).split(",")]
        return f"{m.group(1)}<{', '.join(args)}>"
    outer = re.match(r"(?:\w+::)*(\w*)", name).group(1)
    inner = [f for f in re.findall(r"(\w+(?:Functor|Ops|_kernel_cuda))(<[\w:, ]*>)?", name)
             if f[0] not in _WRAPPERS]
    if outer and inner:
        return f"{outer} {''.join(inner[-1])}"[:96]
    return name.split("(")[0][:96]


def device_table(window: Window) -> List[List]:
    """The device operations that took most time: [name, seconds]."""
    total: Dict[str, float] = {}
    for op in window.device_ops:
        key = short_name(op.name)
        total[key] = total.get(key, 0.0) + op.seconds
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def host_at(host: List[Op], starts: List[float], t: float) -> str:
    """The innermost host span or call running at ``t``."""
    i = bisect.bisect_right(starts, t)
    for op in reversed(host[max(0, i - 4096):i]):
        if op.end >= t:  # the latest to start of those running: the innermost
            return op.name
    return "host outside any span"


def idle_table(window: Window) -> List[List]:
    """The device's idle time in the window by what the host was doing:
    [label, seconds], gaps under SHORT_GAP_S summed apart."""
    host = sorted(window.host, key=lambda o: o.start)
    starts = [op.start for op in host]
    spans = merged(window.device_ops, window.end)
    if not spans:
        return []
    edges = ([(window.start, spans[0][0])] + [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
             + [(spans[-1][1], window.end)])
    total: Dict[str, float] = {}
    for a, b in edges:
        if b <= a:
            continue
        key = ("launch gaps under 20 us" if b - a < SHORT_GAP_S
               else host_at(host, starts, (a + b) / 2))
        total[key] = total.get(key, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def read(window: Window, readers: Dict[str, Callable]) -> Dict[str, float]:
    """Every reader that finds something to read, by name."""
    out = {}
    for name, reader in readers.items():
        value = reader(window)
        if value is not None:
            out[name] = value
    return out
