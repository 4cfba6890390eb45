"""The WAMI warp stage: the kernel on the card, the plain version on the
CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import grid_steps, vmem_bytes, warp_affine_cuda
from .ref import warp_affine_ref

__all__ = ["warp_affine", "warp_affine_oracle", "vmem_bytes", "grid_steps"]


def warp_affine(img: torch.Tensor, p: torch.Tensor, *, ports: int = 1,
                unrolls: int = 8) -> torch.Tensor:
    """(H, W) image, (6,) affine params -> warped (H, W) at knobs (ports,
    unrolls): the CUDA kernel for an image on the card, the plain version
    for one on the CPU."""
    knob_blocks(img.shape[0], img.shape[1], ports=ports, unrolls=unrolls)
    if img.is_cuda:
        return warp_affine_cuda(img, p, ports=ports, unrolls=unrolls)
    return warp_affine_ref(img, p)


def warp_affine_oracle(img: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return warp_affine_ref(img, p)
