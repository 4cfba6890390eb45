"""ctypes binding of ``csrc/wami_grayscale.cu`` (BT.601 luma).

Pure elementwise stage: the interleaved (H, W, 3) frame in, one plane
out, on the knob grid of :mod:`..wami_common`.  A thread takes a run of
4 adjacent pixels (48 bytes of RGB in, one 16-byte store out; one pixel
in tiles of at most 256), and a CTA up to 1,024 threads
(:func:`grayscale_geometry` is the C source's launch formula).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, run4_geometry,
                           vmem_bytes_model)

__all__ = ["grayscale_kernel", "grayscale_cuda", "vmem_bytes", "grid_steps",
           "grayscale_geometry"]

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
SCALAR_PIXELS = 256      # tiles up to this size: one pixel a thread


def grayscale_geometry(H: int, W: int, *, ports: int, unrolls: int):
    """(threads per CTA, passes of the widest CTA) of a launch on 16-byte
    aligned tensors, the C entry point's formula: one thread a pixel for
    tiles of at most :data:`SCALAR_PIXELS` pixels, else a thread per run
    of 4 (:func:`run4_geometry`)."""
    return run4_geometry(H, W, ports=ports, unrolls=unrolls,
                         scalar_pixels=SCALAR_PIXELS)
