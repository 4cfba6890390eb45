"""Plain versions of the SSD scan.

:func:`ssd_ref` is the naive sequential recurrence (the JAX package's
``ssd_ref``, a Python loop for its ``lax.scan``) -- the plain version the
wrapper and ``chip_smoke.py`` hold the kernel against:

    h_t = exp(A * dt_t) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t

O(S) sequential steps, a few PyTorch operations each: slow, and
unambiguous.

:func:`ssd_chunked_ref` follows the CUDA kernel's three passes (chunk
terms in parallel, the sequential state pass, the output) in plain
PyTorch, so the tests can check the decomposition on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_ref", "ssd_chunked_ref"]


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


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked decomposition of ``csrc/ssd_scan.cu``, pass by pass;
    same arguments and results as :func:`ssd_ref`, S % chunk == 0."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xc = x.float().reshape(Bz, nc, chunk, H, P)
    dtc = dt.float().reshape(Bz, nc, chunk, H)
    Bc = B.float().reshape(Bz, nc, chunk, N)
    Cc = C.float().reshape(Bz, nc, chunk, N)
    # 1. chunk pass, every chunk at once
    cum = torch.cumsum(dtc * A, dim=2)                          # (b,c,i,h)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,c,i,j,h)
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[:, :, None]
    L = torch.exp(torch.where(lower, diff, torch.full_like(diff, -1e30)))
    W = G[..., None] * L * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", W, xc)
    total = cum[:, :, -1]                                       # (b,c,h)
    rem = torch.exp(total[:, :, None, :] - cum) * dtc
    states = torch.einsum("bcjhp,bcjn->bchpn", xc * rem[..., None], Bc)
    # 2. state pass, in chunk order
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + states[:, c]
    # 3. output pass: the state entering each chunk
    inter = torch.einsum("bcin,bchpn->bcihp", Cc, torch.stack(h_in, dim=1))
    y = y + inter * torch.exp(cum)[..., None]
    return y.reshape(Bz, S, H, P), h
