"""TensorTable — the Iceberg-like table format (paper 4.2).

Decouples a table's *logical* identity (``taxi_table``) from its physical
storage (content-addressed shards in the object store), and gives each table
a snapshot lineage so any historical version can be read ("time travel").
Column min/max statistics per shard power scan-level predicate pushdown —
the metadata the code-intelligence layer (core/physical.py) uses to avoid
reading data it can prove away.
"""
from repro_torch.table.schema import Column, Schema
from repro_torch.table.format import Snapshot, ShardMeta, TableFormat, TableData
from repro_torch.table.scan import ScanPlan, Predicate, plan_scan, execute_scan

__all__ = [
    "Column",
    "Schema",
    "Snapshot",
    "ShardMeta",
    "TableFormat",
    "TableData",
    "ScanPlan",
    "Predicate",
    "plan_scan",
    "execute_scan",
]
