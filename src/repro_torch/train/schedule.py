"""LR schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(
    step: torch.Tensor,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_frac: float = 0.1,
) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``: a float32 tensor on
    ``step``'s device, computed in float32 in the JAX package's order."""
    step = step.to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
