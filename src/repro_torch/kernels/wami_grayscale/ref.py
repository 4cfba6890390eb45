"""Plain version: BT.601 luma (same math as apps.wami.components)."""

from __future__ import annotations

import torch

__all__ = ["grayscale_ref"]


def grayscale_ref(rgb: torch.Tensor) -> torch.Tensor:
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2])
