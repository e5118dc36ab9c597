"""Vertical elasticity: size the runtime to the artifact (paper 4.5).

"The same transformation logic should run with 10GB or 20GB of memory
depending on the underlying artifacts."  The cost model estimates a
stage's working set from its scan plan (bytes to read after pruning ×
an operator expansion factor) and rounds up to a memory tier; model jobs
additionally request a device submesh sized by parameter + activation
footprint.  The Reasonable-Scale insight (3.1) is encoded in the tier
distribution: most stages land in the smallest tiers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

#: power-of-two "container sizes" in GB — vertical elasticity ladder
MEMORY_TIERS_GB = (1, 2, 4, 8, 16, 32, 64, 128)


@dataclass(frozen=True)
class ResourceRequest:
    memory_gb: int = 1
    devices: int = 1
    #: estimated working set that produced this request (for telemetry)
    estimated_bytes: int = 0

    def fits_tier(self) -> bool:
        return self.memory_gb in MEMORY_TIERS_GB


@dataclass
class CostModel:
    """Bytes/FLOPs → ResourceRequest.

    * ``expansion``: transient multiplier for sort/group buffers (sort-based
      group-by keeps key copies + permutations ≈ 4x input columns).
    * ``headroom``: safety margin before rounding to a tier.
    """

    expansion: float = 4.0
    headroom: float = 1.3

    def request_for_scan(
        self, bytes_after_pruning: int, *, devices: int = 1
    ) -> ResourceRequest:
        working = int(bytes_after_pruning * self.expansion * self.headroom)
        return ResourceRequest(
            memory_gb=self._tier(working), devices=devices, estimated_bytes=working
        )

    def request_for_params(
        self, param_bytes: int, activation_bytes: int, *, devices: int = 1
    ) -> ResourceRequest:
        # params + grads + 2x optimizer state + activations
        working = int((param_bytes * 4 + activation_bytes) * self.headroom)
        return ResourceRequest(
            memory_gb=self._tier(math.ceil(working / max(devices, 1))),
            devices=devices,
            estimated_bytes=working,
        )

    @staticmethod
    def _tier(nbytes: int) -> int:
        gb = max(nbytes / (1 << 30), 1e-9)
        for tier in MEMORY_TIERS_GB:
            if gb <= tier:
                return tier
        return MEMORY_TIERS_GB[-1]


def tier_histogram(requests) -> Dict[int, int]:
    """Distribution of memory tiers across stages (Reasonable-Scale check)."""
    hist: Dict[int, int] = {}
    for r in requests:
        hist[r.memory_gb] = hist.get(r.memory_gb, 0) + 1
    return dict(sorted(hist.items()))
