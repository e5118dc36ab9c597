"""The paper's Appendix pipeline, end to end — SDK edition (Fig. 3 + 4),
on the PyTorch port.

The edition of ``examples/taxi_pipeline.py`` for ``repro_torch``.  SQL
text is verbatim from the paper; the expectation uses the
``@repro.requirements`` decorator exactly as printed.  The whole platform
is constructed through ``repro_torch.Client`` and the DAG is assembled
from decorator registrations.  Stages run on the card; ``--device cpu``
runs them on the CPU.  ``pickups`` groups by two keys, so no stage
reaches the ``fused_filter_agg`` kernel, as in the JAX edition.

Demonstrates: decorator-declared models, branch-scoped handles
(merge-on-success / rollback-on-audit-failure), fusion + pushdown
(compare the two plans), typed RunHandles, and run replay.

Run: PYTHONPATH=src python examples/torch_taxi_pipeline.py [--device cpu]
"""
import argparse
from typing import List, Optional

import numpy as np

import repro_torch as repro
from repro_torch.examples_data import TAXI_SCHEMA, make_taxi_data

# ----------------------------------------------------------------- the DAG
taxi = repro.project("taxi_demo")

taxi.sql(
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


@taxi.expectation()
@repro.requirements({"pandas": "2.0.0"})
def trips_expectation(ctx, trips):
    return trips.mean("count") > 10.0


taxi.sql(
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


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    with repro.Client.ephemeral(shard_rows=8192, device=args.device) as client:
        client.write_table(
            "taxi_table", make_taxi_data(100_000, rng), schema=TAXI_SCHEMA
        )

        # fused run on a feature branch (the paper's optimized plan);
        # the branch handle merges into main on clean exit
        with client.branch("feat_1") as branch:
            res = branch.run(taxi).raise_for_state()
            print("== fused plan ==")
            print(res.plan.describe())
            print(f"io: {res.io}")
        assert "pickups" in client.tables("main")  # merged on success

        # naive isomorphic plan (the paper's first version) for contrast —
        # cache=False so the comparison measures genuine recompute
        res_naive = client.run(
            taxi, branch="feat_naive", fusion=False, pushdown=False,
            cache=False,
        )
        print("== isomorphic plan ==")
        print(res_naive.plan.describe())
        print(f"io: {res_naive.io}")
        ratio = res_naive.io["bytes_written"] / max(res.io["bytes_written"], 1)
        print(f"fusion avoided {ratio:.1f}x object-store writes")

        # audit failure → typed AUDIT_FAILED handle, branch rolled back
        low = make_taxi_data(5_000, rng, mean_count=1.0)
        main_head = client.catalog.head("main").commit_id
        with client.branch("feat_bad") as bad_branch:
            bad_branch.write_table("taxi_table", low, schema=TAXI_SCHEMA)
            failed = bad_branch.run(taxi)
            assert failed.state is repro.RunState.AUDIT_FAILED
            print(f"audit failed as expected: {failed.failed_checks}")
        # rollback: the branch is gone and main never saw the bad data
        assert "feat_bad" not in client.branches()
        assert client.catalog.head("main").commit_id == main_head
        assert client.query("SELECT COUNT(*) AS n FROM taxi_table")["n"][0] == 100_000

        # replay: same code, same data version, identical artifacts
        again = client.replay(res.run_id, taxi)
        assert again.artifacts == res.artifacts
        print(f"replay of run {res.run_id} is bit-identical "
              f"({len(again.artifacts)} artifacts)")


if __name__ == "__main__":
    main()
