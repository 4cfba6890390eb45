"""The SSD scan: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU."""

from __future__ import annotations

from typing import Tuple

import torch

from .kernel import ssd_scan_cuda
from .ref import ssd_ref

__all__ = ["ssd", "ssd_oracle", "ssd_chunk"]


def ssd_chunk(S: int, chunk: int) -> int:
    """The chunk a call runs at: clipped to S, as the JAX kernel clips it.
    Raises ``ValueError`` unless it divides S."""
    q = min(chunk, S)
    if q < 1 or S % q:
        raise ValueError(f"chunk {chunk} does not divide S={S}")
    return q


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *,
        chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bz,S,H,P); dt: (Bz,S,H); A: (H,); B, C: (Bz,S,N) ->
    (y (Bz,S,H,P), h_final (Bz,H,P,N) float32)."""
    q = ssd_chunk(x.shape[1], chunk)
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, A, B, C, chunk=q)
    return ssd_ref(x, dt, A, B, C)


def ssd_oracle(x, dt, A, B, C):
    return ssd_ref(x, dt, A, B, C)
