"""ctypes bindings of ``csrc/wami_steep.cu``: steepest-descent images and
the Gauss-Newton Hessian, on the knob grid of :mod:`..wami_common`.

The Hessian is two launches behind one wrapper call: per-CTA partial
sums into a scratch buffer allocated here, then one CTA that sums them
in index order (deterministic, no float atomics).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, launch_grid,
                           vmem_bytes_model)

__all__ = ["steepest_descent_kernel", "hessian_kernel",
           "steepest_descent_cuda", "hessian_cuda", "vmem_bytes",
           "grid_steps", "hessian_vmem_bytes"]

_N_IN, _N_OUT = 2, 6      # steepest descent: gx, gy -> 6 sd planes

# both entry points: three device pointers, H, W, ports, unrolls, stream
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
steepest_descent_kernel = CudaKernel("wami_steep", "wami_steepest_descent",
                                     _ARGS)
hessian_kernel = CudaKernel("wami_steep", "wami_hessian", _ARGS)


def steepest_descent_cuda(gx: torch.Tensor, gy: torch.Tensor, *,
                          ports: int = 1, unrolls: int = 8) -> torch.Tensor:
    """gx, gy: (H, W) float32 on the card -> sd images (H, W, 6)."""
    H, W = gx.shape
    require_cuda_f32("gx", gx, (H, W))
    require_cuda_f32("gy", gy, (H, W))
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    sd = torch.empty((H, W, 6), dtype=gx.dtype, device=gx.device)
    with torch.cuda.device(gx.device):
        steepest_descent_kernel.launch(gx.data_ptr(), gy.data_ptr(),
                                       sd.data_ptr(), H, W, ports, unrolls,
                                       current_stream(gx.device))
    return sd


def hessian_cuda(sd: torch.Tensor, *, ports: int = 1,
                 unrolls: int = 8) -> torch.Tensor:
    """sd: (H, W, 6) float32 on the card -> Hessian (6, 6)."""
    H, W = sd.shape[0], sd.shape[1]
    require_cuda_f32("sd", sd, (H, W, 6))
    rows, cols = launch_grid(H, W, ports=ports, unrolls=unrolls)
    partials = torch.empty((rows * cols, 36), dtype=sd.dtype,
                           device=sd.device)
    out = torch.empty((6, 6), dtype=sd.dtype, device=sd.device)
    with torch.cuda.device(sd.device):
        hessian_kernel.launch(sd.data_ptr(), partials.data_ptr(),
                              out.data_ptr(), H, W, ports, unrolls,
                              current_stream(sd.device))
    return out


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model


def hessian_vmem_bytes(H: int, W: int, *, ports: int, unrolls: int,
                       dtype_bytes: int = 4) -> int:
    """Six sd input blocks + the resident (6, 6) accumulator."""
    return (6 * unrolls * (W // ports) + 36) * dtype_bytes
