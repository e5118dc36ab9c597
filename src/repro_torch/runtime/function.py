"""FunctionSpec — the unit of serverless execution.

One spec == one node of a physical plan (or one training/serving step).
The fingerprint plays the role of the paper's pinned environment
(`@requirements`): since the OS/container/interpreter layers are fixed in
a single process, the degrees of freedom left are exactly (code, static
config, dtype policy) — so they are what we hash.  Same fingerprint +
same abstract inputs → a warm start; anything else is a cold start (see
runtime/warm.py for what a start means in eager PyTorch).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.runtime.resources import ResourceRequest
from repro_torch.utils.hashing import fingerprint_fn, stable_hash


@dataclass(frozen=True)
class FunctionSpec:
    name: str
    fn: Callable[..., Any]
    static_config: Dict[str, Any] = field(default_factory=dict)
    resources: Optional[ResourceRequest] = None
    #: kept from the JAX package, where it selects ``jax.jit``; part of the
    #: fingerprint.  Here every function runs eagerly either way, and
    #: ``jit=False`` only keeps the call out of the warm cache's start
    #: counts (still retried/speculated like any other task)
    jit: bool = True

    @property
    def fingerprint(self) -> str:
        return stable_hash(
            {
                "name": self.name,
                "code": fingerprint_fn(self.fn),
                "config": self.static_config,
                "jit": self.jit,
            }
        )

    def __hash__(self) -> int:
        return hash(self.fingerprint)
