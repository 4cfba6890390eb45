"""Plain version of the SSD scan: the naive sequential recurrence (the
JAX package's ``ssd_ref``, a Python loop for its ``lax.scan``).

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t

O(S) sequential steps, a few PyTorch operations each: slow, and
unambiguous.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_ref"]


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bz, S, H, P); dt: (Bz, S, H); A: (H,); B, C: (Bz, S, N).

    Returns (y (Bz,S,H,P) float32, h_final (Bz,H,P,N) float32).
    """
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    h = (torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    xf, Bf, Cf = x.float(), B.float(), C.float()
    ys = []
    for t in range(S):
        xt, dtt, bt, ct = xf[:, t], dt[:, t], Bf[:, t], Cf[:, t]
        decay = torch.exp(dtt * A)[..., None, None]            # (Bz,H,1,1)
        contrib = (dtt[..., None, None]
                   * xt[..., :, None] * bt[:, None, None, :])  # (Bz,H,P,N)
        h = h * decay + contrib
        ys.append(torch.einsum("bn,bhpn->bhp", ct, h))
    return torch.stack(ys, dim=1), h
