"""The Mamba2 mixer's depthwise causal conv (with its bias and SiLU) on
the card, with its gradient: the forward kernel and the backward kernel
of ``csrc/mamba_causal_conv.cu`` in one ``torch.autograd.Function``.

:func:`causal_conv` raises ``ValueError`` for dtypes or taps the kernels
do not take, before any launch.  Where a gradient will be asked for, the
forward saves its inputs (xbc as the view it was given: nothing larger)
for the backward, which recomputes the pre-activation; else (a prefill
under ``no_grad``) it runs alone and saves nothing.  The new conv state
is built as the model's plain lines build it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import causal_conv_bwd_cuda, causal_conv_fwd_cuda

__all__ = ["causal_conv", "conv_new_state"]


class _CausalConv(torch.autograd.Function):
    """(xbc, w, b, state) -> y by the forward kernel; backward by the
    backward kernel from the saved inputs."""

    @staticmethod
    def forward(ctx, xbc, w, b, state):
        y = causal_conv_fwd_cuda(xbc, w, b, state)
        ctx.save_for_backward(xbc, w, b, state)
        return y

    @staticmethod
    def backward(ctx, dy):
        xbc, w, b, state = ctx.saved_tensors
        return causal_conv_bwd_cuda(xbc, w, b, state, dy,
                                    state_grad=ctx.needs_input_grad[3])


def conv_new_state(xbc: torch.Tensor, state: Optional[torch.Tensor],
                   K: int) -> torch.Tensor:
    """The trailing K - 1 rows of [state, xbc] along time (zeros for a
    state of None), as ``models/ssm.py::_causal_conv`` builds them."""
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    if K == 1:
        return state
    return torch.cat([state, xbc[:, -(K - 1):]], dim=1)[:, -(K - 1):]


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xbc (B, S, C), a view in place; w (K, C); b (C,); state
    (B, K - 1, C) or None for zeros; one dtype, bf16 or float32 ->
    (silu(conv + b) (B, S, C), the new conv state (B, K - 1, C)),
    differentiable in every tensor."""
    w, b = w.contiguous(), b.contiguous()
    st = None if state is None else state.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xbc, w, b, st)):
        y = _CausalConv.apply(xbc, w, b, st)
    else:
        y = causal_conv_fwd_cuda(xbc, w, b, st)
    return y, conv_new_state(xbc, state, w.shape[0])
