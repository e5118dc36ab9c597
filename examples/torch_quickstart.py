"""Quickstart on the PyTorch port: the lakehouse in 60 seconds — one
client, three decorators.

The edition of ``examples/quickstart.py`` for ``repro_torch``: builds a
lake, seeds a table, runs a two-node pipeline with an expectation on a
feature branch, queries the result with time travel.  Queries and stages
run on the card; ``--device cpu`` runs them on the CPU.  The query has
no aggregate the kernel takes, so it runs the engine's operators.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
from typing import List, Optional

import numpy as np

import repro_torch as repro

# --- declare a pipeline: implicit DAG, one artifact per node
revenue = repro.project("revenue_report")

revenue.sql(
    "big_orders",
    "SELECT user_id, country, amount FROM orders WHERE amount >= 100",
)


@revenue.expectation()
def big_orders_expectation(ctx, big_orders):
    return big_orders.min("amount") >= 100.0  # audit the artifact


revenue.sql(
    "revenue_by_country",
    "SELECT country, SUM(amount) AS revenue, COUNT(*) AS n "
    "FROM big_orders GROUP BY country ORDER BY revenue DESC",
)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    with repro.Client.ephemeral(device=args.device) as client:
        # --- seed raw data on main
        client.write_table(
            "orders",
            {
                "user_id": rng.integers(0, 1000, 50_000).astype(np.int32),
                "amount": (rng.random(50_000) * 200).astype(np.float32),
                "country": rng.integers(0, 30, 50_000).astype(np.int32),
            },
            message="seed",
        )

        # --- transform-audit-write on a feature branch (kept, not merged)
        feat = client.branch("feat_revenue", ephemeral=False)
        result = feat.run(revenue).raise_for_state()
        print(f"run {result.run_id}: state={result.state} "
              f"checks={result.checks}")
        print(result.plan.describe())

        # --- synchronous Query+Wrangle against the new artifact
        top = feat.query("SELECT country, revenue FROM revenue_by_country LIMIT 3")
        print("top countries:", dict(zip(top["country"].tolist(),
                                         np.round(top["revenue"]).tolist())))

        # --- production (main) never saw any of it
        assert "revenue_by_country" not in client.tables("main")
        print("main untouched:", sorted(client.tables("main")))


if __name__ == "__main__":
    main()
