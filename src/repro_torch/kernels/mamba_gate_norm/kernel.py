"""ctypes binding of ``csrc/mamba_gate_norm.cu``: the Mamba2 mixer's
epilogue (D skip, SiLU gate, gated RMSNorm), forward
(:data:`gate_norm_kernel`) and backward (:data:`gate_norm_bwd_kernel`,
whose entry point also launches the sum of the parameters' partials).

The kernels read y (float32) and the model-dtype x and z in place
through their row strides; :func:`gate_norm_operand` hands a view over
as it is where its rows start on the 16-byte grid, else a contiguous
copy.  The C library owns the launch geometry: it says which widths the
kernels take and how large the backward's partials are
(:func:`gate_norm_bwd_scratch_floats`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..build import (CudaKernel, aligned_16, current_stream, load_library,
                     require_cuda_tensor)

__all__ = ["gate_norm_kernel", "gate_norm_bwd_kernel",
           "gate_norm_bwd_scratch_floats", "gate_norm_operand",
           "gate_norm_aligned", "gate_norm_fwd_cuda", "gate_norm_bwd_cuda"]

_DTYPES = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)

_OPERAND = ([ctypes.c_void_p] + [ctypes.c_longlong] * 2)
# y, x, z (each with its batch and row strides), D, scale, out, rstd;
# Bz, S, H, P; eps; bf16; stream
gate_norm_kernel = CudaKernel(
    "mamba_gate_norm", "mamba_gate_norm_fwd",
    _OPERAND * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# y, x, z (with strides), dout, D, scale, rstd, dy, dx, dz, dD, dscale,
# scratch; its floats; Bz, S, H, P, bf16; stream
gate_norm_bwd_kernel = CudaKernel(
    "mamba_gate_norm", "mamba_gate_norm_bwd",
    _OPERAND * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_longlong]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# H, P, bf16 -> floats (0: widths refused; below 0: minus a CUDA error)
_SCRATCH_QUERY = ("mamba_gate_norm_bwd_scratch_floats", [ctypes.c_int] * 3,
                  ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def _scratch_floats(device_index: int, H: int, P: int, bf16: bool) -> int:
    name, argtypes, restype = _SCRATCH_QUERY
    fn = getattr(load_library("mamba_gate_norm"), name)
    fn.argtypes, fn.restype = argtypes, restype
    with torch.cuda.device(device_index):
        n = fn(H, P, int(bf16))
    if n < 0:
        raise RuntimeError(f"{name} failed: cudaError {-n}")
    return n


def gate_norm_bwd_scratch_floats(H: int, P: int, dtype: torch.dtype,
                                 device: torch.device) -> int:
    """The backward's partials, in floats, at ``H`` heads of ``P``
    features in ``dtype`` on the card ``device``: a slot per row of every
    CTA the C library finds resident at once (5.5 and 6.1 MB at
    mamba2-780m's and zamba2-2.7b's widths on an H100).  0 where the
    kernels do not take such heads."""
    return _scratch_floats(torch.device(device).index or 0, H, P,
                           dtype == torch.bfloat16)


def gate_norm_operand(t: torch.Tensor, inner: int
                      ) -> Tuple[torch.Tensor, int, int]:
    """(tensor, batch stride, row stride) of a (Bz, S, ...) operand whose
    last ``inner`` dims hold a row's features: ``t`` itself where they
    are contiguous and every row starts on the 16-byte grid, else a
    contiguous copy.  Strides in elements."""
    want = 1
    ok = True
    for d in range(t.dim() - 1, t.dim() - 1 - inner, -1):
        ok = ok and (t.shape[d] == 1 or t.stride(d) == want)
        want *= t.shape[d]
    es = t.element_size()
    ok = ok and ((t.data_ptr() | t.stride(0) * es | t.stride(1) * es)
                 & 15) == 0
    if not ok:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


# scale and dout, which the kernels read in 16-byte words from their start
gate_norm_aligned = aligned_16


def _check(y, xh, z, D, scale) -> Tuple[int, int, int, int, int]:
    """(Bz, S, H, P, the backward's scratch floats) of operands the
    kernels take; raises ``ValueError`` otherwise."""
    Bz, S, H, P = y.shape
    W = H * P
    dev = y.device
    if not y.is_cuda or y.dtype != torch.float32:
        raise ValueError(f"y: expected a float32 CUDA tensor, got "
                         f"{y.dtype} on {y.device}")
    for name, t, shape in (("xh", xh, (Bz, S, H, P)), ("z", z, (Bz, S, W))):
        if t.device != dev or t.dtype not in _DTYPES:
            raise ValueError(f"{name}: expected bf16 or float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if z.dtype != xh.dtype:
        raise ValueError(f"z: expected {xh.dtype}, got {z.dtype}")
    require_cuda_tensor("D", D, (H,), _F32, dev)
    require_cuda_tensor("scale", scale, (W,), (xh.dtype,), dev)
    floats = gate_norm_bwd_scratch_floats(H, P, xh.dtype, dev)
    if floats == 0:
        raise ValueError(f"{H} heads of P={P}: the kernels take heads of "
                         f"whole 16-byte vectors (P % 8 == 0) in a row "
                         f"one CTA holds")
    return Bz, S, H, P, floats


def gate_norm_fwd_cuda(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                       D: torch.Tensor, scale: torch.Tensor, eps: float, *,
                       save_rstd: bool
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y (Bz,S,H,P) float32; xh (Bz,S,H,P) and z (Bz,S,H P) in the model
    dtype (bf16 or float32), views in place; D (H,) float32; scale (H P,)
    model dtype -> (out (Bz,S,H P) model dtype, r (Bz S,) float32 with
    ``save_rstd``, else None)."""
    Bz, S, H, P, _ = _check(y, xh, z, D, scale)
    dev = y.device
    scale = gate_norm_aligned(scale)
    (y, ysb, yss), (xh, xsb, xss), (z, zsb, zss) = (
        gate_norm_operand(y, 2), gate_norm_operand(xh, 2),
        gate_norm_operand(z, 1))
    out = torch.empty((Bz, S, H * P), dtype=xh.dtype, device=dev)
    rstd = (torch.empty(Bz * S, dtype=torch.float32, device=dev)
            if save_rstd else None)
    with torch.cuda.device(dev):
        gate_norm_kernel.launch(
            y.data_ptr(), ysb, yss, xh.data_ptr(), xsb, xss, z.data_ptr(),
            zsb, zss, D.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if rstd is None else rstd.data_ptr(), Bz, S, H, P,
            float(eps), int(xh.dtype == torch.bfloat16), current_stream(dev))
    return out, rstd


def gate_norm_bwd_cuda(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                       dout: torch.Tensor, D: torch.Tensor,
                       scale: torch.Tensor, rstd: torch.Tensor
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradients (dy, dxh, dz, dD, dscale) of the forward on these
    inputs that left ``rstd``, given dout (Bz,S,H P) in the model dtype:
    dy float32 and dxh of y's and xh's shapes, dz of z's, all
    contiguous; dD float32, dscale in the model dtype."""
    Bz, S, H, P, floats = _check(y, xh, z, D, scale)
    W = H * P
    dev = y.device
    require_cuda_tensor("dout", dout, (Bz, S, W), (xh.dtype,), dev)
    require_cuda_tensor("rstd", rstd, (Bz * S,), _F32, dev)
    scale, dout = gate_norm_aligned(scale), gate_norm_aligned(dout)
    (y, ysb, yss), (xh, xsb, xss), (z, zsb, zss) = (
        gate_norm_operand(y, 2), gate_norm_operand(xh, 2),
        gate_norm_operand(z, 1))
    dy = torch.empty((Bz, S, H, P), dtype=torch.float32, device=dev)
    dxh = torch.empty((Bz, S, H, P), dtype=xh.dtype, device=dev)
    dz = torch.empty((Bz, S, W), dtype=xh.dtype, device=dev)
    dD = torch.empty_like(D)
    dscale = torch.empty_like(scale)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        gate_norm_bwd_kernel.launch(
            y.data_ptr(), ysb, yss, xh.data_ptr(), xsb, xss, z.data_ptr(),
            zsb, zss, dout.data_ptr(), D.data_ptr(), scale.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dxh.data_ptr(), dz.data_ptr(),
            dD.data_ptr(), dscale.data_ptr(), scratch.data_ptr(), floats,
            Bz, S, H, P, int(xh.dtype == torch.bfloat16),
            current_stream(dev))
    return dy, dxh, dz, dD, dscale
