"""The WAMI change-detection stage: the kernel on the card, the plain
version on the CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import change_detection_cuda, grid_steps, vmem_bytes
from .ref import change_detection_ref

__all__ = ["change_detection", "change_detection_oracle",
           "vmem_bytes", "grid_steps"]


def change_detection(gray: torch.Tensor, mu: torch.Tensor,
                     var: torch.Tensor, w: torch.Tensor, *, ports: int = 1,
                     unrolls: int = 8):
    """(H, W) frame and (H, W, 3) mixture state -> (mask, mu', var', w')
    at knobs (ports, unrolls), with the default rate and thresholds: the
    CUDA kernel for tensors on the card, the plain version for tensors on
    the CPU."""
    knob_blocks(gray.shape[0], gray.shape[1], ports=ports, unrolls=unrolls)
    if gray.is_cuda:
        return change_detection_cuda(gray, mu, var, w, ports=ports,
                                     unrolls=unrolls)
    return change_detection_ref(gray, mu, var, w)


def change_detection_oracle(gray: torch.Tensor, mu: torch.Tensor,
                            var: torch.Tensor, w: torch.Tensor):
    return change_detection_ref(gray, mu, var, w)
