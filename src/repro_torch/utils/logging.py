"""Tiny structured logger (keeps the framework dependency-free)."""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("repro_torch")
        root.setLevel(level)
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    return logging.getLogger(f"repro_torch.{name}")
