"""ctypes binding of ``csrc/wami_gradient.cu`` (central differences).

The kernel reads the unpadded frame once and clamps its neighbour
indices (edge padding is a clamp); a thread takes a run of 4 adjacent
pixels with 16-byte loads and stores, and a CTA up to 1,024 threads
(:func:`gradient_geometry` is the C source's launch formula).  Its cost
model stays the one the stage is priced by: four shifted input views and
two output planes per grid cell.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, run4_geometry,
                           vmem_bytes_model)

__all__ = ["gradient_kernel", "gradient_cuda", "vmem_bytes", "grid_steps",
           "gradient_geometry"]

# left/right/up/down views in, gx/gy out: the blocks a grid cell works on
_N_IN, _N_OUT = 4, 2

gradient_kernel = CudaKernel(
    "wami_gradient", "wami_gradient",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def gradient_cuda(gray: torch.Tensor, *, ports: int = 1, unrolls: int = 8):
    """gray: (H, W) float32 on the card, W % ports == 0 and
    H % unrolls == 0 -> (gx, gy)."""
    H, W = gray.shape
    require_cuda_f32("gray", gray, (H, W))
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    gx = torch.empty_like(gray)
    gy = torch.empty_like(gray)
    with torch.cuda.device(gray.device):
        gradient_kernel.launch(gray.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                               H, W, ports, unrolls,
                               current_stream(gray.device))
    return gx, gy


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
# (threads per CTA, passes of the widest CTA): a thread per run of 4
gradient_geometry = run4_geometry
