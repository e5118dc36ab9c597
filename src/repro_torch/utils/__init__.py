"""Shared utilities: hashing, logging, timing, device selection."""
from repro_torch.utils.device import resolve_device
from repro_torch.utils.hashing import stable_hash, content_hash, fingerprint_fn
from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer, timed

__all__ = [
    "stable_hash",
    "content_hash",
    "fingerprint_fn",
    "Timer",
    "timed",
    "get_logger",
    "resolve_device",
]
