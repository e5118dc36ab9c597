"""Versioned data catalog — the Nessie-like layer (paper 4.3, Fig. 4).

The catalog versions *the whole namespace at once*: a commit maps every
table (and model artifact) name to an immutable snapshot manifest key.
Branches are mutable refs onto the commit DAG; runs execute in ephemeral
branches and merge atomically (transform-audit-write).
"""
from repro_torch.catalog.nessie import Catalog, Commit, CatalogError, MergeConflict

__all__ = ["Catalog", "Commit", "CatalogError", "MergeConflict"]
