"""Plain version: the WAMI gradient (same math as apps.wami.components)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gradient_ref"]


def gradient_ref(gray: torch.Tensor):
    p = F.pad(gray[None], (1, 1, 1, 1), mode="replicate")[0]   # edge pad
    gx = (p[1:-1, 2:] - p[1:-1, :-2]) * 0.5
    gy = (p[2:, 1:-1] - p[:-2, 1:-1]) * 0.5
    return gx, gy
