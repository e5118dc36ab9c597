"""Checkpointing INTO the lakehouse catalog — transform-audit-write for
model state.

A checkpoint is a content-addressed manifest {param_path: blob_key}
committed to a catalog branch like any table.  Properties inherited from
the data layer for free:

* **atomicity** — the commit lands only after every blob is durably in
  the store (a crashed save can never leave a half-checkpoint visible);
* **dedup** — unchanged leaves re-use their blobs across checkpoints
  (content addressing), and two runs that reach the same state write it
  once;
* **device-agnostic restore** — leaves are stored as host bytes and
  placed on whatever device the restoring process asks for;
* **lineage/time travel** — every checkpoint is a commit; rollback is a
  branch reset; runs record which commit they started from.

The format is the JAX package's: the same manifest keys (``leaves``,
``step``, ``saved_at``, ``meta``), the leaf paths of
``utils.tree.flatten_with_paths`` (``0/seg0/b0/attn/wq/w``, ``1/step``,
``1/step``), the stacked shapes, the dtypes, and ``io.serialization``'s
blobs, bfloat16 leaves included.  A checkpoint committed by either
package restores in the other.

``save_async`` copies every leaf to host memory before it returns (the
port's optimizer updates in place, so a background thread must never read
a live tensor), then serializes and uploads on a background thread,
overlapping the next training steps.

A save and a restore move IO_THREADS leaves at a time: each leaf's copy
to or from the host, framing, sha256 (the content address, which the
store checks again on every read) and file I/O, most of which release
the interpreter lock.  At a 14.6 GB checkpoint the hash alone is 12 s on
one core.  The manifest does not depend on the order.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.catalog.nessie import Catalog, CatalogError
from repro_torch.io.serialization import (
    bytes_to_tensor,
    dumps_json,
    loads_json,
    tensor_to_bytes,
)
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import flatten_with_paths, unflatten_like

log = get_logger("train.checkpoint")

#: leaves in flight at once in a save or a restore (each holds its host
#: copy and its blob: a few GB at most for the largest leaves)
IO_THREADS = 4


@dataclass
class CheckpointManager:
    catalog: Catalog
    prefix: str = "models/default"

    def _artifact(self) -> str:
        return f"{self.prefix}/checkpoint"

    # ----------------------------------------------------------------- save
    def _write(self, flat: Dict[str, torch.Tensor], *, branch: str, step: int,
               extra_meta: Optional[Dict[str, Any]], message: str) -> str:
        """Blobs → manifest → catalog commit.  Each leaf comes to the host
        in its worker, so at most IO_THREADS are there at once."""
        store = self.catalog.store

        def put(item):
            path, leaf = item
            return path, store.put(tensor_to_bytes(leaf.detach().cpu()))

        with ThreadPoolExecutor(IO_THREADS, thread_name_prefix="ckpt-io") as pool:
            leaves = dict(pool.map(put, flat.items()))
        manifest: Dict[str, Any] = {"leaves": leaves, "step": step,
                                    "saved_at": time.time(),
                                    "meta": extra_meta or {}}
        key = store.put(dumps_json(manifest))
        self.catalog.commit(branch, {self._artifact(): key}, message=message,
                            author="trainer")
        return key

    def save(
        self,
        tree: Any,
        *,
        branch: str,
        step: int,
        extra_meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Synchronous save."""
        return self._write(flatten_with_paths(tree), branch=branch, step=step,
                           extra_meta=extra_meta, message=f"checkpoint step={step}")

    def save_async(
        self,
        tree: Any,
        *,
        branch: str,
        step: int,
        extra_meta: Optional[Dict[str, Any]] = None,
    ) -> threading.Thread:
        """Copy every leaf to host memory now, serialize and upload in the
        background; the caller may update ``tree`` in place at once."""
        flat = {path: leaf.detach().to("cpu", copy=True)
                for path, leaf in flatten_with_paths(tree).items()}

        def work():
            self._write(flat, branch=branch, step=step, extra_meta=extra_meta,
                        message=f"checkpoint step={step} (async)")
            log.info("async checkpoint step=%d committed on %r", step, branch)

        t = threading.Thread(target=work, name=f"ckpt-{step}", daemon=True)
        t.start()
        return t

    # -------------------------------------------------------------- restore
    def latest_step(self, *, branch: str) -> Optional[int]:
        try:
            key = self.catalog.table_key(self._artifact(), branch=branch)
        except CatalogError:
            return None
        manifest = loads_json(self.catalog.store.get(key))
        return int(manifest["step"])

    def restore(
        self,
        tree_like: Any,
        *,
        branch: str,
        commit_id: Optional[str] = None,
        device: DeviceLike = None,
    ) -> Tuple[Any, int]:
        """Restore into the structure of ``tree_like`` (shapes validated,
        each leaf cast to its like's dtype) on ``device`` (None: the card).
        ``tree_like``'s leaves only give shapes and dtypes: meta tensors
        do.  It may name a part of what was saved: ``params`` alone out
        of a ``(params, state)`` checkpoint is ``(params_like,)``."""
        dev = resolve_device(device)
        store = self.catalog.store
        key = self.catalog.table_key(self._artifact(), branch=branch, commit_id=commit_id)
        manifest = loads_json(store.get(key))
        flat_like = flatten_with_paths(tree_like)
        missing = set(flat_like) - set(manifest["leaves"])
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")

        def get(item):
            path, like = item
            host = bytes_to_tensor(store.get(manifest["leaves"][path]))
            if tuple(host.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch at {path}: ckpt {tuple(host.shape)} vs "
                    f"expected {tuple(like.shape)} — incompatible architecture"
                )
            return path, host.to(device=dev, dtype=like.dtype)

        with ThreadPoolExecutor(IO_THREADS, thread_name_prefix="ckpt-io") as pool:
            out = dict(pool.map(get, flat_like.items()))
        return unflatten_like(tree_like, out), int(manifest["step"])
