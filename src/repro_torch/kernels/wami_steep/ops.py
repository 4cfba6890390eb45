"""The WAMI steepest-descent and Hessian stages: the kernels on the card,
the plain versions on the CPU."""

from __future__ import annotations

import torch

from ..wami_common import knob_blocks
from .kernel import (grid_steps, hessian_cuda, hessian_vmem_bytes,
                     steepest_descent_cuda, vmem_bytes)
from .ref import hessian_ref, steepest_descent_ref

__all__ = ["steepest_descent", "steepest_descent_oracle",
           "hessian", "hessian_oracle",
           "vmem_bytes", "grid_steps", "hessian_vmem_bytes"]


def steepest_descent(gx: torch.Tensor, gy: torch.Tensor, *, ports: int = 1,
                     unrolls: int = 8) -> torch.Tensor:
    """(H, W) gradients -> (H, W, 6) sd images at knobs (ports, unrolls):
    the CUDA kernel for tensors on the card, the plain version for
    tensors on the CPU."""
    knob_blocks(gx.shape[0], gx.shape[1], ports=ports, unrolls=unrolls)
    if gx.is_cuda:
        return steepest_descent_cuda(gx, gy, ports=ports, unrolls=unrolls)
    return steepest_descent_ref(gx, gy)


def steepest_descent_oracle(gx: torch.Tensor,
                            gy: torch.Tensor) -> torch.Tensor:
    return steepest_descent_ref(gx, gy)


def hessian(sd: torch.Tensor, *, ports: int = 1,
            unrolls: int = 8) -> torch.Tensor:
    """(H, W, 6) sd images -> (6, 6) Hessian at knobs (ports, unrolls):
    the CUDA kernels for a tensor on the card, the plain version for one
    on the CPU."""
    knob_blocks(sd.shape[0], sd.shape[1], ports=ports, unrolls=unrolls)
    if sd.is_cuda:
        return hessian_cuda(sd, ports=ports, unrolls=unrolls)
    return hessian_ref(sd)


def hessian_oracle(sd: torch.Tensor) -> torch.Tensor:
    return hessian_ref(sd)
