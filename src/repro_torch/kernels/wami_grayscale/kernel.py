"""ctypes binding of ``csrc/wami_grayscale.cu`` (BT.601 luma).

Pure elementwise stage: the interleaved (H, W, 3) frame in, one plane
out, on the knob grid of :mod:`..wami_common`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import grid_steps_model, knob_blocks, vmem_bytes_model

__all__ = ["grayscale_kernel", "grayscale_cuda", "vmem_bytes", "grid_steps"]

# three planes in, one out: the blocks a grid cell works on
_N_IN, _N_OUT = 3, 1

grayscale_kernel = CudaKernel(
    "wami_grayscale", "wami_grayscale",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def grayscale_cuda(rgb: torch.Tensor, *, ports: int = 1,
                   unrolls: int = 8) -> torch.Tensor:
    """rgb: (H, W, 3) float32 on the card, W % ports == 0 and
    H % unrolls == 0 -> (H, W)."""
    H, W = rgb.shape[0], rgb.shape[1]
    require_cuda_f32("rgb", rgb, (H, W, 3))
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    y = torch.empty((H, W), dtype=rgb.dtype, device=rgb.device)
    with torch.cuda.device(rgb.device):
        grayscale_kernel.launch(rgb.data_ptr(), y.data_ptr(), H, W, ports,
                                unrolls, current_stream(rgb.device))
    return y


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
