"""ctypes bindings of ``csrc/wami_steep.cu``: steepest-descent images and
the Gauss-Newton Hessian, on the knob grid of :mod:`..wami_common`.

Steepest descent takes a run of 4 adjacent pixels a thread (two 16-byte
loads, 96 contiguous bytes of output; one pixel in tiles of at most 128)
and a CTA up to 1,024 threads (:func:`steepest_descent_geometry` is the
C source's launch formula).

The Hessian is one launch: per-CTA partial sums into a scratch buffer,
then the CTA that finishes last sums them in index order (deterministic,
no float atomics).  The partials and the ticket counter that picks that
CTA are cached per device (:func:`hessian_scratch`), so a call
allocates nothing but its output.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, launch_grid,
                           run4_geometry, vmem_bytes_model)

__all__ = ["steepest_descent_kernel", "hessian_kernel",
           "steepest_descent_cuda", "hessian_cuda", "HessianScratch",
           "hessian_scratch", "vmem_bytes", "grid_steps",
           "hessian_vmem_bytes", "steepest_descent_geometry"]

_N_IN, _N_OUT = 2, 6      # steepest descent: gx, gy -> 6 sd planes

# both entry points end with H, W, ports, unrolls and the stream
_KNOB_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p]
# gx, gy, sd
steepest_descent_kernel = CudaKernel("wami_steep", "wami_steepest_descent",
                                     [ctypes.c_void_p] * 3 + _KNOB_ARGS)
# sd, partials, ticket, out
hessian_kernel = CudaKernel("wami_steep", "wami_hessian",
                            [ctypes.c_void_p] * 4 + _KNOB_ARGS)


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


class HessianScratch:
    """The Hessian's scratch per device: the partials, float32 with at
    least as many rows of 36 as the largest grid asked for, and the
    ticket counter, one int32 made zeroed, which the kernel leaves at 0.
    Sharing one counter assumes the calls on a device run on one stream,
    as the DSE makes them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: Dict[torch.device,
                          Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device, blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(partials, ticket) on ``device`` for a grid of ``blocks`` CTAs;
        the partials are made anew only when the grid outgrows them."""
        dev = torch.device(device)
        with self._lock:
            partials, ticket = self._cache.get(dev, (None, None))
            if ticket is None:
                ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            if partials is None or partials.shape[0] < blocks:
                partials = torch.empty((blocks, 36), dtype=torch.float32,
                                       device=dev)
            self._cache[dev] = (partials, ticket)
            return partials, ticket


hessian_scratch = HessianScratch()


def hessian_cuda(sd: torch.Tensor, *, ports: int = 1,
                 unrolls: int = 8) -> torch.Tensor:
    """sd: (H, W, 6) float32 on the card -> Hessian (6, 6), one launch
    on the current stream."""
    H, W = sd.shape[0], sd.shape[1]
    require_cuda_f32("sd", sd, (H, W, 6))
    rows, cols = launch_grid(H, W, ports=ports, unrolls=unrolls)
    partials, ticket = hessian_scratch.get(sd.device, rows * cols)
    out = torch.empty((6, 6), dtype=sd.dtype, device=sd.device)
    with torch.cuda.device(sd.device):
        hessian_kernel.launch(sd.data_ptr(), partials.data_ptr(),
                              ticket.data_ptr(), out.data_ptr(), H, W,
                              ports, unrolls, current_stream(sd.device))
    return out


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
SCALAR_PIXELS = 128      # tiles up to this size: one pixel a thread


def steepest_descent_geometry(H: int, W: int, *, ports: int, unrolls: int):
    """(threads per CTA, passes of the widest CTA) of a steepest-descent
    launch on 16-byte aligned tensors, the C entry point's formula: one
    thread a pixel for tiles of at most :data:`SCALAR_PIXELS` pixels,
    else a thread per run of 4 (:func:`run4_geometry`)."""
    return run4_geometry(H, W, ports=ports, unrolls=unrolls,
                         scalar_pixels=SCALAR_PIXELS)


def hessian_vmem_bytes(H: int, W: int, *, ports: int, unrolls: int,
                       dtype_bytes: int = 4) -> int:
    """Six sd input blocks + the resident (6, 6) accumulator."""
    return (6 * unrolls * (W // ports) + 36) * dtype_bytes
