"""Warm-start accounting — the analog of the paper's frozen containers.

The paper freezes initialized containers so a "cold" Spark-session start
(seconds-minutes) becomes a ~300 ms thaw.  In the JAX package the cold
start is tracing + XLA compilation, made explicit with
``jax.jit(fn).lower(...).compile()``.  Eager PyTorch compiles nothing
here: ``get_or_compile`` returns ``spec.fn`` itself and only keeps the
accounting — one cold start per (fingerprint, abstract inputs) the first
time it is seen, a warm hit every time after — so the ``StartupStats``
contract is the JAX package's.  What a first call does pay in the port
lands inside the stage that makes it: PyTorch's lazy CUDA set-up, the
caching allocator's growth and, for a stage routed to the fused kernel,
the kernel's one nvcc build (``kernels/build.py``).  No ``torch.compile``.

The abstract key walks tensors, numpy arrays, tuples, lists, dicts and
``Columnar`` relations (their columns in sorted name order, then the
validity mask, as the JAX package's pytree flattening orders them) and
records each leaf's shape, dtype and device.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List, Set, Tuple

from repro_torch.engine.columnar import Columnar
from repro_torch.runtime.function import FunctionSpec
from repro_torch.utils.hashing import stable_hash
from repro_torch.utils.logging import get_logger

log = get_logger("runtime.warm")


@dataclass
class StartupStats:
    cold_starts: int = 0
    warm_hits: int = 0

    @property
    def warm_ratio(self) -> float:
        total = self.cold_starts + self.warm_hits
        return self.warm_hits / total if total else 0.0


def _walk(tree: Any, leaves: List[Tuple[str, str, str]]) -> Any:
    """The structure of ``tree`` with every array leaf appended to
    ``leaves`` as (shape, dtype, device)."""
    if isinstance(tree, Columnar):
        names = sorted(tree.columns)
        for n in names:
            _walk(tree.columns[n], leaves)
        _walk(tree.valid, leaves)
        return {"Columnar": names}
    if isinstance(tree, (tuple, list)):
        return [type(tree).__name__, [_walk(x, leaves) for x in tree]]
    if isinstance(tree, dict):
        return {str(k): _walk(tree[k], leaves) for k in sorted(tree, key=str)}
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        leaves.append((
            str(tuple(tree.shape)), str(tree.dtype), str(getattr(tree, "device", "cpu")),
        ))
        return "*"
    return repr(type(tree).__name__)


def _abstract_key(tree: Any) -> str:
    leaves: List[Tuple[str, str, str]] = []
    treedef = _walk(tree, leaves)
    return stable_hash({"leaves": leaves, "treedef": treedef})


@dataclass
class WarmFunctionCache:
    """fingerprint × abstract-input-key → start accounting."""

    stats: StartupStats = field(default_factory=StartupStats)
    _seen: Set[Tuple[str, str]] = field(default_factory=set)

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def get_or_compile(self, spec: FunctionSpec, *example_inputs: Any) -> Callable:
        """Return the callable for ``spec`` at these input shapes: the
        function itself, counted as a cold start the first time this
        (fingerprint, abstract inputs) pair is seen and warm after."""
        if not spec.jit:
            return spec.fn
        key = (spec.fingerprint, _abstract_key(example_inputs))
        with self._lock:
            if key in self._seen:
                self.stats.warm_hits += 1
                return spec.fn
            self._seen.add(key)
            self.stats.cold_starts += 1
        log.debug("cold start %s", spec.name)
        return spec.fn

    def has_fingerprint(self, fingerprint: str) -> bool:
        """True when ANY input shape of this function fingerprint has
        already paid its cold start.  The wave scheduler stamps this onto
        ``StageScheduled`` as the warm/cold admission hint — shapes are
        only known once the stage's scans complete, so the fingerprint is
        the honest pre-dispatch signal."""
        with self._lock:
            return any(k[0] == fingerprint for k in self._seen)

    def invalidate(self) -> None:
        with self._lock:
            self._seen.clear()
