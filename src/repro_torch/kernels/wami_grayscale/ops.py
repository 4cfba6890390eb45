"""The WAMI grayscale stage: the kernel on the card, the plain version
on the CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import grayscale_cuda, grid_steps, vmem_bytes
from .ref import grayscale_ref

__all__ = ["grayscale", "grayscale_oracle", "vmem_bytes", "grid_steps"]


def grayscale(rgb: torch.Tensor, *, ports: int = 1,
              unrolls: int = 8) -> torch.Tensor:
    """(H, W, 3) -> (H, W) luma at knobs (ports, unrolls): the CUDA
    kernel for a tensor on the card, the plain version for one on the
    CPU (where the knobs are checked, and change nothing)."""
    knob_blocks(rgb.shape[0], rgb.shape[1], ports=ports, unrolls=unrolls)
    if rgb.is_cuda:
        return grayscale_cuda(rgb, ports=ports, unrolls=unrolls)
    return grayscale_ref(rgb)


def grayscale_oracle(rgb: torch.Tensor) -> torch.Tensor:
    return grayscale_ref(rgb)
