"""The WAMI gradient stage: the kernel on the card, the plain version on
the CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import gradient_cuda, grid_steps, vmem_bytes
from .ref import gradient_ref

__all__ = ["gradient", "gradient_oracle", "vmem_bytes", "grid_steps"]


def gradient(gray: torch.Tensor, *, ports: int = 1, unrolls: int = 8):
    """(H, W) -> (gx, gy) at knobs (ports, unrolls): the CUDA kernel for
    a tensor on the card, the plain version for one on the CPU."""
    knob_blocks(gray.shape[0], gray.shape[1], ports=ports, unrolls=unrolls)
    if gray.is_cuda:
        return gradient_cuda(gray, ports=ports, unrolls=unrolls)
    return gradient_ref(gray)


def gradient_oracle(gray: torch.Tensor):
    return gradient_ref(gray)
