"""Storage layer: content-addressed object store + tensor serialization.

This is the "data lake" of the lakehouse (paper Fig. 2, bottom): raw files
live in object storage; every higher layer (table format, catalog,
checkpoints, run snapshots) addresses immutable blobs through this store.
"""
from repro_torch.io.objectstore import ObjectStore, StoreStats
from repro_torch.io.serialization import (
    array_to_bytes,
    bytes_to_array,
    dumps_json,
    loads_json,
)

__all__ = [
    "ObjectStore",
    "StoreStats",
    "array_to_bytes",
    "bytes_to_array",
    "dumps_json",
    "loads_json",
]
