"""Wall-clock timing helpers used by the runtime and the benchmark harness."""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List


@dataclass
class Timer:
    """Accumulating named timer (microsecond resolution)."""

    samples: Dict[str, List[float]] = field(default_factory=dict)

    @contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.samples.get(name, []))

    def mean(self, name: str) -> float:
        xs = self.samples.get(name, [])
        return sum(xs) / len(xs) if xs else 0.0

    def report(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self.samples.items()}


@contextmanager
def timed() -> Iterator[List[float]]:
    """``with timed() as t: ...`` — ``t[0]`` holds elapsed seconds after."""
    box = [0.0]
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        box[0] = time.perf_counter() - t0
