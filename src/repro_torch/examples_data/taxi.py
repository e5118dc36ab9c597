"""The paper's NYC-taxi working example (4.1, Appendix A).

Schema, synthetic data generator and the Appendix pipeline (SQL verbatim
from the paper), identical to the JAX package's: the same seed writes the
same lake through either package, and ``build_taxi_pipeline``'s text is
the same, so its nodes have the same fingerprints in both.
"""
from __future__ import annotations

import datetime as dt

import numpy as np

from repro_torch.core import Pipeline, requirements
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


def build_taxi_pipeline(threshold: float = 10.0) -> Pipeline:
    """The Appendix pipeline, SQL verbatim from the paper."""
    p = Pipeline("taxi_demo")

    # Step 1 (trips)
    p.sql(
        "trips",
        """
        SELECT
         pickup_location_id,
         passenger_count as count,
         dropoff_location_id
        FROM
         taxi_table
        WHERE
         pickup_at >= '2019-04-01'
        """,
    )

    # Step 2 (trips_expectation)
    @p.python
    @requirements({"pandas": "2.0.0"})
    def trips_expectation(ctx, trips):
        m = trips.mean("count")
        return m > threshold

    # Step 3 (pickups)
    p.sql(
        "pickups",
        """
        SELECT
         pickup_location_id,
         dropoff_location_id,
         COUNT(*) AS counts
        FROM
         trips
        GROUP BY
         pickup_location_id,
         dropoff_location_id
        ORDER BY
         counts DESC
        """,
    )
    return p
