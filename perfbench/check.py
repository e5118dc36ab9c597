"""The comparison that decides ``correct``.

Once the window has closed, ``check_batches`` batches of those it scored
are drawn from the seed, every row of each: the plain reference of the
cell's model (its module's ``score_rows``) scores the same token ids from
the same weights in float32, and the program's scores, as they reached the
host in the window, are held to it.  Two numbers are compared, each with the limit
of ``perfbench/limits/<workload>.json``:

* ``max_gap``: the widest gap |program - reference| over every score of the
  sampled rows, in nats;
* ``mean_gap``: the mean of those gaps.

A score that is not finite fails both.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from perfbench.weights import sub_seeds

NUMBERS = ("max_gap", "mean_gap")


def sample(seed: int, batches: int, k: int) -> List[int]:
    """``k`` distinct batch indices of ``range(batches)``, drawn from the
    seed (all of them where there are no more)."""
    rng = np.random.default_rng(sub_seeds(seed, 3)[2])
    return sorted(int(i) for i in rng.choice(batches, size=min(k, batches), replace=False))


def readings(got: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    gap = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if not np.isfinite(gap).all():
        return {name: math.inf for name in NUMBERS}
    return {"max_gap": float(gap.max()), "mean_gap": float(gap.mean())}


def judge(values: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": values[name], "limit": limits[name]["limit"]} for name in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
