"""The paper's NYC-taxi working example (4.1, Appendix A).

Schema and the synthetic data generator, identical to the JAX package's,
so the same seed writes the same lake through either package.
"""
from __future__ import annotations

import datetime as dt

import numpy as np

from repro_torch.table import Schema

TAXI_SCHEMA = Schema.of(
    pickup_at="int32",  # days since epoch (see engine/sql.py literals)
    pickup_location_id="int32",
    passenger_count="int32",
    dropoff_location_id="int32",
)

APRIL_1 = (dt.date(2019, 4, 1) - dt.date(1970, 1, 1)).days


def make_taxi_data(n: int, rng: np.random.Generator, *, mean_count: float = 30.0):
    """Synthetic taxi trips; sorted by date so pushdown can prune shards."""
    days = np.sort(rng.integers(APRIL_1 - 60, APRIL_1 + 30, n)).astype(np.int32)
    return {
        "pickup_at": days,
        "pickup_location_id": rng.integers(0, 64, n).astype(np.int32),
        "passenger_count": rng.poisson(mean_count, n).astype(np.int32),
        "dropoff_location_id": rng.integers(0, 64, n).astype(np.int32),
    }
