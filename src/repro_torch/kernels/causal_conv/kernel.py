"""ctypes binding of ``csrc/mamba_causal_conv.cu``: the Mamba2 mixer's
depthwise causal conv with its bias and SiLU, forward
(:data:`causal_conv_kernel`) and backward (:data:`causal_conv_bwd_kernel`,
whose entry point also launches the sum of the taps' and the bias's
partials).

The kernels read xbc (and the backward dy) in place through their batch
and row strides; :func:`conv_operand` hands a view over as it is where
its channels are contiguous and, at widths of whole 16-byte words
(C % 8 == 0), its rows start on the 16-byte grid, else a contiguous copy.
Other widths take the kernels element by element.  The C library says
how large the backward's partials are
(:func:`causal_conv_bwd_scratch_floats`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..build import (CudaKernel, aligned_16, current_stream, load_library,
                     require_cuda_tensor)

__all__ = ["causal_conv_kernel", "causal_conv_bwd_kernel", "MAX_TAPS",
           "causal_conv_bwd_scratch_floats", "conv_operand",
           "causal_conv_fwd_cuda", "causal_conv_bwd_cuda"]

_DTYPES = (torch.bfloat16, torch.float32)
MAX_TAPS = 8             # kMaxTaps in csrc/mamba_causal_conv.cu

_OPERAND = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
# x (with its batch and row strides), state, w, b, y; Bz, S, C, K, bf16;
# stream
causal_conv_kernel = CudaKernel(
    "mamba_causal_conv", "mamba_causal_conv_fwd",
    _OPERAND + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])
# x (with strides), state, w, b, dy (with strides), dx, dstate, dw, db,
# scratch; its floats; Bz, S, C, K, bf16; stream
causal_conv_bwd_kernel = CudaKernel(
    "mamba_causal_conv", "mamba_causal_conv_bwd",
    _OPERAND + [ctypes.c_void_p] * 3 + _OPERAND + [ctypes.c_void_p] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# Bz, S, C, K -> floats (0: a shape the kernels do not take)
_SCRATCH_QUERY = ("mamba_causal_conv_bwd_scratch_floats", [ctypes.c_int] * 4,
                  ctypes.c_longlong)


@functools.lru_cache(maxsize=None)
def causal_conv_bwd_scratch_floats(Bz: int, S: int, C: int, K: int) -> int:
    """The backward's float32 partials at (Bz, S, C) with K taps: K + 1
    rows of C for each row of its grid (5.3 and 6.7 MB at mamba2-780m's
    and zamba2-2.7b's layers); 0 where the kernels do not take the
    shape."""
    name, argtypes, restype = _SCRATCH_QUERY
    fn = getattr(load_library("mamba_causal_conv"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn(Bz, S, C, K)


def conv_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(tensor, batch stride, row stride) of a (Bz, S, C) operand: ``t``
    itself where its channels are contiguous and, at C % 8 == 0, it and
    its rows start on the 16-byte grid; else a contiguous copy.  Strides
    in elements."""
    C = t.shape[2]
    ok = t.stride(2) == 1 or C == 1
    if ok and C % 8 == 0:
        es = t.element_size()
        ok = ((t.data_ptr() | t.stride(0) * es | t.stride(1) * es)
              & 15) == 0
    if not ok:
        t = t.contiguous()
    return t, t.stride(0), t.stride(1)


def _check(x, w, b, state) -> Tuple[int, int, int, int]:
    """(Bz, S, C, K) of operands the kernels take; raises ``ValueError``
    otherwise: a CUDA xbc (Bz, S, C) in bf16 or float32, w (K, C) with
    1 <= K <= 8, b (C,) and a state (Bz, K - 1, C), each contiguous and
    of xbc's dtype, on its card."""
    if not x.is_cuda or x.dtype not in _DTYPES:
        raise ValueError(f"xbc: expected a bf16 or float32 CUDA tensor, "
                         f"got {x.dtype} on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"xbc: expected (Bz, S, C), got shape "
                         f"{tuple(x.shape)}")
    Bz, S, C = x.shape
    if w.dim() != 2 or not 1 <= w.shape[0] <= MAX_TAPS:
        raise ValueError(f"w: expected (K, C) with 1 <= K <= {MAX_TAPS}, "
                         f"got shape {tuple(w.shape)}")
    K = w.shape[0]
    dev = x.device
    require_cuda_tensor("w", w, (K, C), (x.dtype,), dev)
    require_cuda_tensor("b", b, (C,), (x.dtype,), dev)
    if state is not None:
        require_cuda_tensor("state", state, (Bz, K - 1, C), (x.dtype,), dev)
    if min(Bz, S, C) <= 0 or Bz > 65535:
        raise ValueError(f"xbc: the kernels take 1 to 65,535 rows of at "
                         f"least one token and channel, got "
                         f"{tuple(x.shape)}")
    return Bz, S, C, K


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def causal_conv_fwd_cuda(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         state: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """silu(the causal conv of [state, xbc] with w, + b): xbc (Bz, S, C),
    a view in place; w (K, C); b (C,); state (Bz, K - 1, C) or None for
    zeros; all in one dtype, bf16 or float32 -> y (Bz, S, C) contiguous,
    in that dtype."""
    Bz, S, C, K = _check(xbc, w, b, state)
    dev = xbc.device
    x, sb, ss = conv_operand(xbc)
    w, b = aligned_16(w), aligned_16(b)
    state = None if state is None else aligned_16(state)
    y = torch.empty((Bz, S, C), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        causal_conv_kernel.launch(
            x.data_ptr(), sb, ss, _ptr(state), w.data_ptr(), b.data_ptr(),
            y.data_ptr(), Bz, S, C, K, int(x.dtype == torch.bfloat16),
            current_stream(dev))
    return y


def causal_conv_bwd_cuda(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         state: Optional[torch.Tensor], dy: torch.Tensor, *,
                         state_grad: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    Optional[torch.Tensor]]:
    """The gradients (dx, dw, db, dstate) of the forward on these inputs
    given dy (Bz, S, C) in their dtype: dx contiguous of xbc's shape, dw
    and db of w's and b's, and, with ``state_grad`` and a state, the
    state's (else None), all in the inputs' dtype."""
    Bz, S, C, K = _check(xbc, w, b, state)
    dev = xbc.device
    if dy.device != dev or dy.dtype != xbc.dtype or dy.shape != xbc.shape:
        raise ValueError(f"dy: expected {xbc.dtype} of shape "
                         f"{tuple(xbc.shape)} on {dev}, got {dy.dtype} of "
                         f"{tuple(dy.shape)} on {dy.device}")
    x, sb, ss = conv_operand(xbc)
    g, gsb, gss = conv_operand(dy)
    w, b = aligned_16(w), aligned_16(b)
    state = None if state is None else aligned_16(state)
    floats = causal_conv_bwd_scratch_floats(Bz, S, C, K)
    dx = torch.empty((Bz, S, C), dtype=x.dtype, device=dev)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    dstate = (torch.empty_like(state) if state_grad and state is not None
              else None)
    scratch = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        causal_conv_bwd_kernel.launch(
            x.data_ptr(), sb, ss, _ptr(state), w.data_ptr(), b.data_ptr(),
            g.data_ptr(), gsb, gss, dx.data_ptr(), _ptr(dstate),
            dw.data_ptr(), db.data_ptr(), scratch.data_ptr(), floats,
            Bz, S, C, K, int(x.dtype == torch.bfloat16), current_stream(dev))
    return dx, dw, db, dstate
