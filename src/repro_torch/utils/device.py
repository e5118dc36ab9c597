"""Device selection for the port's entry points.

Every entry point takes ``device``.  ``None`` means the card: it resolves
to ``cuda`` and raises when no CUDA device exists, so a caller that meant
to run on the GPU never silently runs on the CPU.  The CPU is used only
when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
