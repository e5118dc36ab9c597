"""Shared utilities: hashing, logging, device selection."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.hashing import stable_hash, content_hash, fingerprint_fn
from repro_torch.utils.logging import get_logger

__all__ = [
    "stable_hash",
    "content_hash",
    "fingerprint_fn",
    "get_logger",
    "resolve_device",
]
