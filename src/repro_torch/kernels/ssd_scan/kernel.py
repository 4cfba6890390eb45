"""ctypes binding of ``csrc/ssd_scan.cu``: one launch per call, float32.

The kernel runs one CTA per (head, batch) and slice of the head dim P:
:func:`ssd_p_split` splits P (exact, see the C source) while Bz * H
alone would leave SMs idle.  A chunk whose staging exceeds the card's
opt-in shared memory is refused here, before the launch
(:func:`ssd_smem_bytes` is the C source's formula).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import (CudaKernel, current_stream, require_cuda_tensor,
                     smem_optin)

__all__ = ["ssd_scan_kernel", "ssd_scan_cuda", "ssd_smem_bytes",
           "ssd_p_split"]

_F32 = (torch.float32,)
_MIN_SLICE = 16          # the narrowest slice of P one CTA takes

# x, dt, A, B, C, y, h_final; Bz, S, H, P, N, chunk, p_split; stream
ssd_scan_kernel = CudaKernel(
    "ssd_scan", "ssd_scan_fwd",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def ssd_smem_bytes(chunk: int, p_slice: int, N: int) -> int:
    """Shared memory one CTA stages: the x slice (chunk, p_slice), B and
    C (chunk, N + 1), dt and cum (chunk), W (chunk, chunk) and the state
    slice (p_slice, N + 1), all float32."""
    return 4 * (chunk * p_slice + 2 * chunk * (N + 1) + 2 * chunk
                + chunk * chunk + p_slice * (N + 1))


def ssd_p_split(Bz: int, H: int, P: int, sms: int) -> int:
    """Slices of P per (head, batch): doubled while the grid has fewer
    CTAs than the card has SMs and a slice stays 16 wide or more."""
    split = 1
    while (Bz * H * split < sms and P % (2 * split) == 0
           and P // (2 * split) >= _MIN_SLICE):
        split *= 2
    return split


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *,
                  chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bz,S,H,P); dt: (Bz,S,H); A: (H,); B, C: (Bz,S,N), float32 on
    the card, contiguous; S % chunk == 0 -> (y (Bz,S,H,P), h_final
    (Bz,H,P,N))."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    require_cuda_tensor("x", x, (Bz, S, H, P), _F32)
    require_cuda_tensor("dt", dt, (Bz, S, H), _F32, dev)
    require_cuda_tensor("A", A, (H,), _F32, dev)
    require_cuda_tensor("B", B, (Bz, S, N), _F32, dev)
    require_cuda_tensor("C", C, (Bz, S, N), _F32, dev)
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S={S}")
    props = torch.cuda.get_device_properties(dev)
    split = ssd_p_split(Bz, H, P, props.multi_processor_count)
    smem, cap = ssd_smem_bytes(chunk, P // split, N), smem_optin(dev)
    if smem > cap:
        raise ValueError(f"chunk {chunk} at P/{split}={P // split}, N={N} "
                         f"stages {smem} B of shared memory; the card "
                         f"allows {cap} B per block")
    y = torch.empty_like(x)
    h = torch.empty((Bz, H, P, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        ssd_scan_kernel.launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), Bz, S, H, P, N, chunk,
            split, current_stream(dev))
    return y, h
