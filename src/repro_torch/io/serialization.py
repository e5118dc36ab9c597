"""Tensor/manifest (de)serialization.

We use a small self-describing binary framing (the 'parquet of spare parts'):
an 8-byte magic + JSON header (dtype/shape) + raw C-contiguous bytes.  It is
deliberately simple — the table format layers column statistics and shard
manifests on top (table/format.py), mirroring how Parquet + Iceberg split
responsibilities.
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

_MAGIC = b"RPRTNSR1"


def array_to_bytes(arr: np.ndarray) -> bytes:
    shape = list(np.shape(arr))  # BEFORE ascontiguousarray (it 1-d-ifies 0-d)
    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": str(arr.dtype), "shape": shape}).encode()
    return _MAGIC + len(header).to_bytes(4, "little") + header + arr.tobytes()


def bytes_to_array(data: bytes) -> np.ndarray:
    if data[:8] != _MAGIC:
        raise ValueError("not a repro tensor blob")
    hlen = int.from_bytes(data[8:12], "little")
    header = json.loads(data[12 : 12 + hlen].decode())
    raw = data[12 + hlen :]
    arr = np.frombuffer(raw, dtype=np.dtype(header["dtype"]))
    return arr.reshape(header["shape"]).copy()


def dumps_json(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def loads_json(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode())
