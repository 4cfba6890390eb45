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
PyTorch, so the tests can check the decomposition on the CPU;
:func:`ssd_chunked_bwd_ref` does the same for the backward kernel's
passes (``csrc/ssd_scan_bwd.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_ref", "ssd_chunked_ref", "ssd_chunked_bwd_ref"]


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


def ssd_chunked_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        dh_final: Optional[torch.Tensor] = None, *,
                        chunk: int) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_chunked_ref` (no incoming state) in the
    passes of ``csrc/ssd_scan_bwd.cu``, in the inputs' dtype; S % chunk
    == 0.  Returns (dx, ddt, dA, dB, dC).

    Per chunk, with W_ij = G_ij exp(cum_i - cum_j) dt_j (i >= j),
    G = C.B^T and rem_j = exp(cum_Q - cum_j) dt_j:

      1. chunk pass: E_c = sum_i exp(cum_i) dy_i (x) C_i, the gradient
         the chunk's outputs give the state entering it;
      2. reverse state pass: g_c, the gradient of the state leaving
         chunk c, from dh_final back: g_{c-1} = exp(T_c) g_c + E_c; and
         exp(T_c) <h_in[c], g_c>, the gradient of that chunk's decay;
      3. per-chunk pass: K = (dy.x^T) * exp(cum_i - cum_j) (i >= j);
         dx = W^T.dy + rem * (B.g^T); dB = (K dt)^T.C + rem x.g;
         dC = (K dt).B + exp(cum) dy.h_in; the gradient of cum from the
         decays, of rem and of the inter-chunk term, whose reverse
         cumulative sum gives ddt (with the direct term sum_i K_ij G_ij)
         and dA.
    """
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    Q = chunk
    xc = x.reshape(Bz, nc, Q, H, P)
    dyc = dy.reshape(Bz, nc, Q, H, P)
    dtc = dt.reshape(Bz, nc, Q, H)
    Bc = B.reshape(Bz, nc, Q, N)
    Cc = C.reshape(Bz, nc, Q, N)
    cum = torch.cumsum(dtc * A, dim=2)                          # (b,c,i,h)
    T = cum[:, :, -1]                                           # (b,c,h)
    ecum = torch.exp(cum)
    rem = torch.exp(T[:, :, None, :] - cum) * dtc
    # the forward's chunk states and the state entering each chunk
    states = torch.einsum("bcjhp,bcjn->bchpn", xc * rem[..., None], Bc)
    h = torch.zeros((Bz, H, P, N), dtype=x.dtype, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(T[:, c])[..., None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                             # (b,c,h,p,n)
    # 1. chunk pass
    E = torch.einsum("bcihp,bcin->bchpn", dyc * ecum[..., None], Cc)
    # 2. reverse state pass
    g = (torch.zeros_like(h) if dh_final is None
         else dh_final.to(x.dtype))
    gs, dT_state = [None] * nc, [None] * nc
    for c in range(nc - 1, -1, -1):
        gs[c] = g
        dT_state[c] = torch.exp(T[:, c]) * (h_in[:, c] * g).sum((-2, -1))
        g = torch.exp(T[:, c])[..., None, None] * g + E[:, c]
    g = torch.stack(gs, dim=1)                                  # (b,c,h,p,n)
    dT = torch.stack(dT_state, dim=1)                           # (b,c,h)
    # 3. per-chunk pass
    lower = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,c,i,j,h)
    L = torch.where(lower[:, :, None], torch.exp(
        torch.where(lower[:, :, None], diff, torch.zeros_like(diff))),
        torch.zeros_like(diff))
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    K = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc) * L
    KG = K * G[..., None]                                       # (b,c,i,j,h)
    row = (KG * dtc[:, :, None, :, :]).sum(3)                   # (b,c,i,h)
    col = KG.sum(2)                                             # (b,c,j,h)
    U = torch.einsum("bcjn,bchpn->bcjhp", Bc, g)
    r = (xc * U).sum(-1)                                        # (b,c,j,h)
    W = G[..., None] * L * dtc[:, :, None, :, :]
    dx = torch.einsum("bcijh,bcihp->bcjhp", W, dyc) + rem[..., None] * U
    dG = K * dtc[:, :, None, :, :]
    dB = (torch.einsum("bcijh,bcin->bcjn", dG, Cc)
          + torch.einsum("bcjh,bcjhp,bchpn->bcjn", rem, xc, g))
    Y = torch.einsum("bcin,bchpn->bcihp", Cc, h_in)
    dC = (torch.einsum("bcijh,bcjn->bcin", dG, Bc)
          + torch.einsum("bcih,bcihp,bchpn->bcin", ecum, dyc, h_in))
    dq = ecum * (dyc * Y).sum(-1)                               # (b,c,i,h)
    dcum = row - dtc * col - r * rem + dq
    dcum[:, :, -1] += dT + (r * rem).sum(2)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), 2), (2,))
    ddt = col + r * torch.exp(T[:, :, None, :] - cum) + A * da
    dA = (da * dtc).sum((0, 1, 2))
    return (dx.reshape(Bz, S, H, P), ddt.reshape(Bz, S, H), dA,
            dB.reshape(Bz, S, N), dC.reshape(Bz, S, N))
