"""The Mamba2 mixer's epilogue on the card, with its gradient: the
forward kernel and the backward kernel of ``csrc/mamba_gate_norm.cu`` in
one ``torch.autograd.Function``.

:func:`gate_norm` raises ``ValueError`` for dtypes or widths the kernels
do not take, before any launch.  Where a gradient will be asked for, the
forward saves its inputs and each row's r for the backward; else (a
prefill under ``no_grad``) it runs alone and saves nothing.
"""

from __future__ import annotations

import torch

from .kernel import gate_norm_bwd_cuda, gate_norm_fwd_cuda

__all__ = ["gate_norm"]


class _GateNorm(torch.autograd.Function):
    """(y, xh, z, D, scale) -> out by the forward kernel; backward by the
    backward kernel from the saved inputs and r."""

    @staticmethod
    def forward(ctx, y, xh, z, D, scale, eps: float):
        out, rstd = gate_norm_fwd_cuda(y, xh, z, D, scale, eps,
                                       save_rstd=True)
        ctx.save_for_backward(y, xh, z, D, scale, rstd)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, xh, z, D, scale, rstd = ctx.saved_tensors
        return gate_norm_bwd_cuda(y, xh, z, dout.contiguous(), D, scale,
                                  rstd) + (None,)


def gate_norm(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              D: torch.Tensor, scale: torch.Tensor,
              eps: float) -> torch.Tensor:
    """y (Bz,S,H,P) float32; xh (Bz,S,H,P), z (Bz,S,H P) in the model
    dtype; D (H,) float32; scale (H P,) -> the out_proj input (Bz,S,H P)
    in the model dtype, differentiable in every tensor."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, xh, z, D, scale)):
        return _GateNorm.apply(y, xh, z, D, scale, eps)
    return gate_norm_fwd_cuda(y, xh, z, D, scale, eps, save_rstd=False)[0]
