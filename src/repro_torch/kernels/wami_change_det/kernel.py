"""ctypes binding of ``csrc/wami_change_det.cu`` (per-pixel GMM, K=3).

The kernel works on the (H, W, 3) state layout directly, with the
plain version's default rate and thresholds compiled in; a thread takes
a run of 4 adjacent pixels with 16-byte loads and stores, and a CTA up
to 1,024 threads (:func:`change_det_geometry` is the C source's launch
formula).  Its cost model stays the one the stage is priced by: ten
input planes (x and three K=3 state tensors) and ten output planes per
grid cell.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..build import CudaKernel, current_stream, require_cuda_f32
from ..wami_common import (grid_steps_model, knob_blocks, run4_geometry,
                           vmem_bytes_model)

__all__ = ["change_det_kernel", "change_detection_cuda", "vmem_bytes",
           "grid_steps", "change_det_geometry"]

_K = 3
# gray + 3 state planes of K=3 in; mask + 3 state planes of K=3 out
_N_IN, _N_OUT = 1 + 3 * _K, 1 + 3 * _K

change_det_kernel = CudaKernel(
    "wami_change_det", "wami_change_det",
    [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
       ctypes.c_void_p])


def change_det_geometry(H: int, W: int, *, ports: int, unrolls: int):
    """(threads per CTA, passes of the widest CTA) of a launch on 16-byte
    aligned tensors: :func:`run4_geometry`, a thread per run of 4
    pixels, at most 1,024 a CTA."""
    return run4_geometry(H, W, ports=ports, unrolls=unrolls)


def change_detection_cuda(gray: torch.Tensor, mu: torch.Tensor,
                          var: torch.Tensor, w: torch.Tensor, *,
                          ports: int = 1, unrolls: int = 8):
    """gray: (H, W), mu/var/w: (H, W, 3), all float32 on the card,
    W % ports == 0 and H % unrolls == 0 -> (mask (H, W) bool, mu', var',
    w')."""
    H, W = gray.shape
    require_cuda_f32("gray", gray, (H, W))
    for name, t in (("mu", mu), ("var", var), ("w", w)):
        require_cuda_f32(name, t, (H, W, _K))
        if t.device != gray.device:
            raise ValueError(f"{name}: expected a tensor on {gray.device}, "
                             f"got {t.device}")
    knob_blocks(H, W, ports=ports, unrolls=unrolls)
    mask = torch.empty((H, W), dtype=torch.bool, device=gray.device)
    mu_n, var_n, w_n = (torch.empty_like(mu) for _ in range(3))
    with torch.cuda.device(gray.device):
        change_det_kernel.launch(
            gray.data_ptr(), mu.data_ptr(), var.data_ptr(), w.data_ptr(),
            mask.data_ptr(), mu_n.data_ptr(), var_n.data_ptr(),
            w_n.data_ptr(), H, W, ports, unrolls,
            current_stream(gray.device))
    return mask, mu_n, var_n, w_n


vmem_bytes = functools.partial(vmem_bytes_model, n_in=_N_IN, n_out=_N_OUT)
grid_steps = grid_steps_model
