"""Plain versions: LK steepest-descent images + Gauss-Newton Hessian
(same math as apps.wami.components)."""

from __future__ import annotations

import torch

__all__ = ["steepest_descent_ref", "hessian_ref"]


def steepest_descent_ref(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    H, W = gx.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=gx.dtype, device=gx.device),
        torch.arange(W, dtype=gx.dtype, device=gx.device), indexing="ij")
    return torch.stack([gx * xx, gx * yy, gx, gy * xx, gy * yy, gy], dim=-1)


def hessian_ref(sd: torch.Tensor) -> torch.Tensor:
    flat = sd.reshape(-1, 6)
    return flat.T @ flat
