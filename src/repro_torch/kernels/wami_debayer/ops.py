"""The WAMI debayer stage: the kernel on the card, the plain version on
the CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import debayer_cuda, grid_steps, vmem_bytes
from .ref import debayer_ref

__all__ = ["debayer", "debayer_oracle", "vmem_bytes", "grid_steps"]


def debayer(bayer: torch.Tensor, *, ports: int = 1,
            unrolls: int = 8) -> torch.Tensor:
    """(H, W) RGGB mosaic -> (H, W, 3) float32 RGB at knobs (ports,
    unrolls): the CUDA kernel for a tensor on the card (cast to float32
    first, as the plain version does), the plain version for one on the
    CPU."""
    knob_blocks(bayer.shape[0], bayer.shape[1], ports=ports, unrolls=unrolls)
    if bayer.is_cuda:
        return debayer_cuda(bayer.to(torch.float32), ports=ports,
                            unrolls=unrolls)
    return debayer_ref(bayer)


def debayer_oracle(bayer: torch.Tensor) -> torch.Tensor:
    return debayer_ref(bayer)
