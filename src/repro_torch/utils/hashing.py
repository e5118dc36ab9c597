"""Deterministic hashing for content addressing and run fingerprinting.

The paper (4.4.1) snapshots the full project into object storage and
fingerprints it in a database so that "the same code on the same data version
will produce identical results".  Everything in the lakehouse that needs an
identity — blobs, table snapshots, commits, run ids, compiled-function cache
keys — goes through the helpers here so identities are stable across
processes and platforms.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import re
from typing import Any

import numpy as np

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _canonical(obj: Any) -> Any:
    """Convert ``obj`` into a deterministically-serializable structure."""
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        # repr is stable for finite floats; normalize NaN/inf.
        if obj != obj:
            return "__nan__"
        return repr(obj)
    if isinstance(obj, bytes):
        return {"__bytes__": hashlib.sha256(obj).hexdigest()}
    if isinstance(obj, (list, tuple)):
        return [_canonical(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canonical(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, set):
        return sorted(str(x) for x in obj)
    if isinstance(obj, np.dtype):
        return str(obj)
    if isinstance(obj, np.ndarray):
        return {
            "__ndarray__": hashlib.sha256(np.ascontiguousarray(obj).tobytes()).hexdigest(),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if hasattr(obj, "to_json_dict"):
        return _canonical(obj.to_json_dict())
    if callable(obj):
        return {"__callable__": fingerprint_fn(obj)}
    return {"__repr__": repr(obj)}


def stable_hash(obj: Any, *, length: int = 16) -> str:
    """Deterministic hex digest of an arbitrary (JSON-able-ish) structure."""
    payload = json.dumps(_canonical(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:length]


def content_hash(data: bytes, *, length: int = 32) -> str:
    """Content address for a blob (the object-store key)."""
    return hashlib.sha256(data).hexdigest()[:length]


def fingerprint_fn(fn: Any, *, length: int = 16) -> str:
    """Fingerprint a Python function by source + captured values (4.4.1).

    Closure cell contents and defaults are part of the identity: two
    pipelines built from the same source with different captured
    parameters are different code ("code is data" taken literally).
    Falls back to qualified name for builtins whose source is unavailable.
    """
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        src = getattr(fn, "__qualname__", repr(fn))
    captured = []
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            captured.append(repr(cell.cell_contents))
        except ValueError:  # empty cell
            captured.append("<empty>")
    defaults = repr(getattr(fn, "__defaults__", None))
    payload = src + "||" + "|".join(captured) + "||" + defaults
    # reprs of captured functions/objects embed memory addresses, which
    # would make semantically-identical closures fingerprint differently
    # (and bust the warm compiled-fn cache) — strip them
    payload = _ADDR_RE.sub("0xADDR", payload)
    return hashlib.sha256(payload.encode("utf-8")).hexdigest()[:length]
