"""ctypes binding of ``csrc/wami_debayer.cu`` (bilinear RGGB demosaic).

The kernel reads the unpadded mosaic once and maps its neighbour
indices through the reflect padding; a thread takes a run of 4 adjacent
pixels with 16-byte loads and stores (one pixel in tiles of at most 256),
and a CTA up to 1,024 threads (:func:`debayer_geometry` is the C
source's launch formula).  Its cost
model stays the one the stage is priced by: nine shifted input views and
three output planes per grid cell.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, run4_geometry,
                           vmem_bytes_model)

__all__ = ["debayer_kernel", "debayer_cuda", "vmem_bytes", "grid_steps",
           "debayer_geometry"]

# centre + 8 neighbour views in, R/G/B planes out: the blocks a grid cell
# works on
_N_IN, _N_OUT = 9, 3

debayer_kernel = CudaKernel(
    "wami_debayer", "wami_debayer",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def debayer_cuda(bayer: torch.Tensor, *, ports: int = 1,
                 unrolls: int = 8) -> torch.Tensor:
    """bayer: (H, W) float32 mosaic on the card, H, W >= 2,
    W % ports == 0 and H % unrolls == 0 -> (H, W, 3) RGB."""
    H, W = bayer.shape
    require_cuda_f32("bayer", bayer, (H, W))
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    if H < 2 or W < 2:
        raise ValueError(f"debayer: reflect padding needs H, W >= 2, got "
                         f"({H}, {W})")
    rgb = torch.empty((H, W, 3), dtype=bayer.dtype, device=bayer.device)
    with torch.cuda.device(bayer.device):
        debayer_kernel.launch(bayer.data_ptr(), rgb.data_ptr(), H, W, ports,
                              unrolls, current_stream(bayer.device))
    return rgb


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
SCALAR_PIXELS = 256      # tiles up to this size: one pixel a thread


def debayer_geometry(H: int, W: int, *, ports: int, unrolls: int):
    """(threads per CTA, passes of the widest CTA) of a launch on 16-byte
    aligned tensors, the C entry point's formula: one thread a pixel for
    tiles of at most :data:`SCALAR_PIXELS` pixels, else a thread per run
    of 4 (:func:`run4_geometry`)."""
    bh, bw = knob_blocks(H, W, ports=ports, unrolls=unrolls)
    if bh * bw <= SCALAR_PIXELS:
        return -(-bh * bw // 32) * 32, 1
    return run4_geometry(H, W, ports=ports, unrolls=unrolls)
