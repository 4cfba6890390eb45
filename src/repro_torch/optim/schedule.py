"""LR schedules: linear warmup + cosine decay (the zoo default)."""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """Scale factor in [floor, 1]: linear warmup then cosine to floor.

    ``step`` is a number or a tensor (the optimizer's 0-d step on the
    card); the factor is a float32 tensor on the step's device, computed
    there with no sync to the host."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(1.0, float(warmup)), max=1.0)
    prog = torch.clamp((step - warmup) / max(1.0, float(total - warmup)),
                       0.0, 1.0)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * cos
