"""The model's chunked SSD on the card, with its gradient: the forward
kernel (``csrc/ssd_scan.cu``) and the backward kernel
(``csrc/ssd_scan_bwd.cu``) in one ``torch.autograd.Function``.

Where a gradient will be asked for, :func:`ssd_train`'s forward saves
its scratch (the state entering each chunk and each chunk's decay) for
the backward, which runs at the same chunk
(:func:`~.kernel.ssd_grad_plan`); else the forward runs alone at its
own plan.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .kernel import (SsdGradPlan, _card, ssd_fwd_launch, ssd_grad_plan,
                     ssd_scan_bwd_cuda, ssd_scan_cuda)

__all__ = ["ssd_train", "pad_to_chunks"]


class _SsdScan(torch.autograd.Function):
    """(x, dt, A, B, C) -> (y, h_final) by the forward kernel at
    ``plan``; backward by the backward kernel from the saved scratch."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, plan: SsdGradPlan):
        y, h, scratch = ssd_fwd_launch(x, dt, A, B, C, plan.fwd)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, scratch)
        ctx.plan = plan
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, scratch = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dh = None if dh is None else dh.contiguous()
        return ssd_scan_bwd_cuda(x, dt, A, B, C, dy, dh, scratch,
                                 ctx.plan) + (None,)


def ssd_train(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bz,S,H,P); dt: (Bz,S,H); A: (H,); B, C: (Bz,S,N), on the card
    -> (y (Bz,S,H,P), h_final (Bz,H,P,N)), float32, differentiable in
    every input.  As the plain body: the chunk clipped to S, and S
    padded with zeros to whole chunks (dt 0 there: the state passes
    through unchanged).  A call no gradient will reach (a prefill under
    ``no_grad``) runs the forward alone, at its own plan
    (:func:`~.kernel.ssd_plan`), and saves nothing."""
    Bz, S, H, P = x.shape
    q = min(chunk, S)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, B, C))
    x, dt, B, C = (t.contiguous() for t in pad_to_chunks(
        q, *(t.float() for t in (x, dt, B, C))))
    A = A.float().contiguous()
    if not grad:
        y, h = ssd_scan_cuda(x, dt, A, B, C, chunk=q)
        return y[:, :S], h
    plan = ssd_grad_plan(Bz, x.shape[1], H, P, B.shape[-1], q,
                         *_card(x.device))
    y, h = _SsdScan.apply(x, dt, A, B, C, plan)
    return y[:, :S], h


def pad_to_chunks(q: int, x: torch.Tensor, dt: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """x (Bz,S,H,P), dt (Bz,S,H), B and C (Bz,S,N) zero-padded along S to
    whole chunks of ``q``."""
    pad = -x.shape[1] % q
    if not pad:
        return x, dt, B, C
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))
