"""ctypes binding of ``csrc/wami_warp.cu`` (affine warp, bilinear).

The kernel fuses the source-address computation and the 4-neighbour
gather that the JAX package leaves to XLA, and reads ``p`` from device
memory.  A tile of at most 1,024 pixels takes a thread a pixel; a
larger one a thread per run of 4 adjacent output pixels (four source
cells, then 16 gathers in flight, then one 16-byte store); a CTA takes
up to 1,024 threads either way (:func:`warp_geometry` is the C source's
launch formula).  Its cost
model stays the one the stage is priced by: six gathered input planes
and one output plane per grid cell.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, run4_geometry,
                           vmem_bytes_model)

__all__ = ["warp_kernel", "warp_affine_cuda", "vmem_bytes", "grid_steps",
           "warp_geometry"]

# i00, i01, i10, i11, fx, fy in, the warped plane out
_N_IN, _N_OUT = 6, 1

warp_kernel = CudaKernel(
    "wami_warp", "wami_warp",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def warp_affine_cuda(img: torch.Tensor, p: torch.Tensor, *, ports: int = 1,
                     unrolls: int = 8) -> torch.Tensor:
    """img: (H, W) float32 on the card, H, W >= 2; p: (6,) float32 on the
    same card; W % ports == 0 and H % unrolls == 0 -> warped (H, W)."""
    H, W = img.shape
    require_cuda_f32("img", img, (H, W))
    require_cuda_f32("p", p, (6,))
    if p.device != img.device:
        raise ValueError(f"p: expected a tensor on {img.device}, got "
                         f"{p.device}")
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    if H < 2 or W < 2:
        raise ValueError(f"warp: the bilinear cell needs H, W >= 2, got "
                         f"({H}, {W})")
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        warp_kernel.launch(img.data_ptr(), p.data_ptr(), out.data_ptr(), H,
                           W, ports, unrolls, current_stream(img.device))
    return out


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
SCALAR_PIXELS = 1024     # tiles up to this size: one pixel a thread


def warp_geometry(H: int, W: int, *, ports: int, unrolls: int):
    """(threads per CTA, passes of the widest CTA) of a launch whose
    output is 16-byte aligned, the C entry point's formula: one thread a
    pixel for tiles of at most :data:`SCALAR_PIXELS` pixels, else a
    thread per run of 4 (:func:`run4_geometry`)."""
    return run4_geometry(H, W, ports=ports, unrolls=unrolls,
                         scalar_pixels=SCALAR_PIXELS)
