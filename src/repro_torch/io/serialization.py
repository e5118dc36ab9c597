"""Tensor/manifest (de)serialization.

We use a small self-describing binary framing (the 'parquet of spare parts'):
an 8-byte magic + JSON header (dtype/shape) + raw C-contiguous bytes.  It is
deliberately simple — the table format layers column statistics and shard
manifests on top (table/format.py), mirroring how Parquet + Iceberg split
responsibilities.

Tensors cross the same framing: :func:`tensor_to_bytes` and
:func:`bytes_to_tensor` write and read what the JAX package's
``array_to_bytes`` writes for the same values, bfloat16 included (header
dtype ``"bfloat16"``, two bytes an element), without ``ml_dtypes``: a
bfloat16 payload is carried as its ``uint16`` bits.
"""
from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

_MAGIC = b"RPRTNSR1"


def array_to_bytes(arr: np.ndarray) -> bytes:
    shape = list(np.shape(arr))  # BEFORE ascontiguousarray (it 1-d-ifies 0-d)
    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": str(arr.dtype), "shape": shape}).encode()
    return _MAGIC + len(header).to_bytes(4, "little") + header + arr.tobytes()


def _split(data: bytes):
    """(header, payload): the payload a view of ``data``, not a copy."""
    if data[:8] != _MAGIC:
        raise ValueError("not a repro tensor blob")
    hlen = int.from_bytes(data[8:12], "little")
    header = json.loads(data[12 : 12 + hlen].decode())
    return header, memoryview(data)[12 + hlen :]


def bytes_to_array(data: bytes) -> np.ndarray:
    header, raw = _split(data)
    arr = np.frombuffer(raw, dtype=np.dtype(header["dtype"]))
    return arr.reshape(header["shape"]).copy()


def tensor_to_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor in :func:`array_to_bytes`' framing, byte for byte what
    the JAX package writes for the same values; the payload is copied
    once, into the blob."""
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        dtype, arr = "bfloat16", t.view(torch.int16).numpy()
    else:
        arr = t.numpy()
        dtype = str(arr.dtype)
    header = json.dumps({"dtype": dtype, "shape": list(t.shape)}).encode()
    return b"".join([_MAGIC, len(header).to_bytes(4, "little"), header,
                     memoryview(np.ascontiguousarray(arr)).cast("B")])


def bytes_to_tensor(data: bytes) -> torch.Tensor:
    """The CPU tensor a blob holds (a bfloat16 blob as ``torch.bfloat16``)."""
    header, raw = _split(data)
    if header["dtype"] == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(header["shape"]).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(bytes_to_array(data))


def dumps_json(obj: Dict[str, Any]) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def loads_json(data: bytes) -> Dict[str, Any]:
    return json.loads(data.decode())
