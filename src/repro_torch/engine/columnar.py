"""The engine's relation type: fixed-shape columns + validity mask."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device

#: numpy dtypes the JAX package narrows (x64 disabled): the port applies
#: the same rules so both packages hold identical column dtypes
_NARROW = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}

_UNSIGNED = {torch.uint8, torch.uint16, torch.uint32, torch.uint64}


def dtype_kind(dtype: torch.dtype) -> str:
    """numpy's one-letter kind of a torch dtype: b, i, u, f or c."""
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    return "u" if dtype in _UNSIGNED else "i"


def dtype_name(dtype: torch.dtype) -> str:
    """``int32`` for ``torch.int32``: the name numpy and JAX print."""
    return str(dtype).replace("torch.", "")


def dtype_extreme(dtype: torch.dtype, sign: int):
    if dtype.is_floating_point:
        return sign * float("inf")
    info = torch.iinfo(dtype)
    return info.max if sign > 0 else info.min


@dataclass
class Columnar:
    """A columnar relation with masked-row semantics.

    ``valid`` marks live rows; operators never change column length, they
    only flip validity — every op is shape-stable, so a query chain never
    materializes a compacted intermediate on the device.
    """

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool[n]

    # ------------------------------------------------------------ helpers
    @staticmethod
    def from_arrays(
        columns: Dict[str, Union[torch.Tensor, np.ndarray]],
        *,
        device: DeviceLike = None,
    ) -> "Columnar":
        if not columns:
            raise ValueError("empty relation")
        dev = resolve_device(device)
        n = len(next(iter(columns.values())))
        for name, arr in columns.items():
            if len(arr) != n:
                raise ValueError(f"ragged column {name!r}")
        return Columnar(
            {k: _to_tensor(v, dev) for k, v in columns.items()},
            torch.ones((n,), dtype=torch.bool, device=dev),
        )

    @staticmethod
    def from_numpy(
        columns: Dict[str, np.ndarray], *, device: DeviceLike = None
    ) -> "Columnar":
        return Columnar.from_arrays(columns, device=device)

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def names(self) -> List[str]:
        return sorted(self.columns)

    def num_valid(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def column(self, name: str) -> torch.Tensor:
        if name not in self.columns:
            raise KeyError(f"no column {name!r}; have {self.names}")
        return self.columns[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.column(name)

    # ---------------------------------------- masked statistics (for
    # expectations — the paper's trips['count'].mean() > 10 pattern)
    def sum(self, name: str) -> torch.Tensor:
        vals = self.column(name)
        # integer sums stay int32, as jnp.sum does with x64 disabled
        acc = vals.dtype if dtype_kind(vals.dtype) in "fc" else torch.int32
        return torch.where(self.valid, vals, torch.zeros((), dtype=vals.dtype,
                           device=vals.device)).sum(dtype=acc)

    def count(self) -> torch.Tensor:
        return self.num_valid()

    def mean(self, name: str) -> torch.Tensor:
        total = self.sum(name).to(torch.float32)
        return total / self.num_valid().clamp(min=1).to(torch.float32)

    def min(self, name: str) -> torch.Tensor:
        vals = self.column(name)
        big = torch.full((), dtype_extreme(vals.dtype, +1), dtype=vals.dtype, device=vals.device)
        return torch.where(self.valid, vals, big).min()

    def max(self, name: str) -> torch.Tensor:
        vals = self.column(name)
        small = torch.full((), dtype_extreme(vals.dtype, -1), dtype=vals.dtype, device=vals.device)
        return torch.where(self.valid, vals, small).max()

    def with_columns(self, new: Dict[str, torch.Tensor]) -> "Columnar":
        cols = dict(self.columns)
        cols.update(new)
        return Columnar(cols, self.valid)

    def select(self, names: List[str]) -> "Columnar":
        return Columnar({n: self.column(n) for n in names}, self.valid)

    def mask_where(self, keep: torch.Tensor) -> "Columnar":
        return Columnar(self.columns, self.valid & keep)

    # --------------------------------------------------- host-side export
    def to_numpy(self, *, compact: bool = True) -> Dict[str, np.ndarray]:
        """Pull to host; ``compact`` drops invalid rows."""
        valid = self.valid.cpu().numpy()
        out = {}
        for name, arr in self.columns.items():
            host = arr.cpu().numpy()
            out[name] = host[valid] if compact else host
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Columnar(cols={self.names}, capacity={self.capacity})"


def _to_tensor(v: Union[torch.Tensor, np.ndarray], device: torch.device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device)
    arr = np.asarray(v)
    # torch.tensor copies, as jnp.asarray does: the relation never aliases
    # the caller's array
    return torch.tensor(arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False),
                        device=device)
