"""Token data pipeline over lakehouse tables.

Training data is a TensorTable of token ids (one row per token, with a
document id column), versioned in the catalog like any other table — so a
training run is pinned to a *data commit* (the same reproducibility story
as SQL pipelines: same code + same data version = same run).

Sampling is **stateless**: ``batch_at(step)`` derives the batch purely
from (seed, step), so a restarted run resumes bit-identically without a
sampler checkpoint — the fault-tolerance primitive the training loop
relies on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.catalog.nessie import Catalog
from repro_torch.table.format import TableFormat
from repro_torch.table.schema import Schema

TOKEN_SCHEMA = Schema.of(token="int32", doc_id="int32")


def write_token_table(
    fmt: TableFormat,
    catalog: Catalog,
    name: str,
    tokens: np.ndarray,
    *,
    branch: str = "main",
    doc_ids: Optional[np.ndarray] = None,
) -> str:
    data = {
        "token": tokens.astype(np.int32),
        "doc_id": (
            doc_ids if doc_ids is not None else np.zeros(len(tokens))
        ).astype(np.int32),
    }
    snap = fmt.write(name, TOKEN_SCHEMA, data)
    key = fmt.manifest_key(snap)
    catalog.commit(branch, {name: key}, message=f"tokens {name}", author="data")
    return key


@dataclass
class TokenDataset:
    """Deterministic, stateless batch sampler over a token table snapshot."""

    fmt: TableFormat
    manifest_key: str
    batch_size: int
    seq_len: int
    seed: int = 0

    def __post_init__(self) -> None:
        snap = self.fmt.load_snapshot(self.manifest_key)
        self._tokens = self.fmt.read(snap, columns=["token"])["token"]
        self._n = len(self._tokens)
        if self._n < self.seq_len + 1:
            raise ValueError(
                f"token table has {self._n} tokens < seq_len+1={self.seq_len + 1}"
            )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — restart-exact."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        starts = rng.integers(0, self._n - self.seq_len - 1, self.batch_size)
        rows = np.stack(
            [self._tokens[s : s + self.seq_len + 1] for s in starts]
        )
        return {"tokens": rows.astype(np.int32)}
