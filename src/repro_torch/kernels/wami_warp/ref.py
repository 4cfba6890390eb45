"""Plain version: bilinear affine warp (same math as
apps.wami.components)."""

from __future__ import annotations

import torch

__all__ = ["warp_affine_ref"]


def warp_affine_ref(img: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of ``img`` by affine params p=(p1..p6):
    x' = (1+p1) x + p2 y + p3 ;  y' = p4 x + (1+p5) y + p6."""
    H, W = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    sx = (1.0 + p[0]) * xx + p[1] * yy + p[2]
    sy = p[3] * xx + (1.0 + p[4]) * yy + p[5]
    x0 = torch.clamp(torch.floor(sx), 0, W - 2)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy
