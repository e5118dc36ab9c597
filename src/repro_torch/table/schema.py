"""Table schemas: named, typed columns over columnar numpy/JAX arrays."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_ALLOWED_KINDS = {"i", "u", "f", "b"}  # int, uint, float, bool


@dataclass(frozen=True)
class Column:
    name: str
    dtype: str  # numpy dtype string, e.g. "int32", "float32"

    def __post_init__(self) -> None:
        kind = np.dtype(self.dtype).kind
        if kind not in _ALLOWED_KINDS:
            raise TypeError(
                f"column {self.name!r}: dtype {self.dtype} unsupported "
                f"(kind={kind}); the engine is numeric/boolean-columnar"
            )

    def to_json_dict(self) -> Dict[str, str]:
        return {"name": self.name, "dtype": self.dtype}


@dataclass(frozen=True)
class Schema:
    columns: Tuple[Column, ...]

    @staticmethod
    def of(**cols: str) -> "Schema":
        return Schema(tuple(Column(n, d) for n, d in cols.items()))

    @staticmethod
    def from_json_dict(d: Dict) -> "Schema":
        return Schema(tuple(Column(c["name"], c["dtype"]) for c in d["columns"]))

    def to_json_dict(self) -> Dict:
        return {"columns": [c.to_json_dict() for c in self.columns]}

    @property
    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def dtype_of(self, name: str) -> np.dtype:
        for c in self.columns:
            if c.name == name:
                return np.dtype(c.dtype)
        raise KeyError(f"no column {name!r} in schema {self.names}")

    def has(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    def get(self, name: str) -> Optional[Column]:
        """The column named ``name``, or None — the non-raising lookup the
        static lineage pass uses."""
        for c in self.columns:
            if c.name == name:
                return c
        return None

    def select(self, names: List[str]) -> "Schema":
        by_name = {c.name: c for c in self.columns}
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(f"columns {missing} not in schema {self.names}")
        return Schema(tuple(by_name[n] for n in names))

    def validate_batch(self, batch: Dict[str, np.ndarray]) -> int:
        """Check a columnar batch against the schema; return row count."""
        if set(batch.keys()) != set(self.names):
            raise ValueError(
                f"batch columns {sorted(batch)} != schema columns {sorted(self.names)}"
            )
        nrows = None
        for c in self.columns:
            arr = batch[c.name]
            if arr.ndim != 1:
                raise ValueError(f"column {c.name!r} must be 1-D, got shape {arr.shape}")
            if np.dtype(arr.dtype) != np.dtype(c.dtype):
                raise TypeError(
                    f"column {c.name!r}: dtype {arr.dtype} != schema {c.dtype}"
                )
            if nrows is None:
                nrows = len(arr)
            elif len(arr) != nrows:
                raise ValueError("ragged columnar batch")
        return int(nrows or 0)
