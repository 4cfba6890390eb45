"""Plain versions of the Mamba2 mixer's epilogue, as the kernels compute
it: every step in float32 (float64 for float64 inputs), rounded once to
the model dtype at each output.

:func:`gate_norm_ref` is the forward,

    v = y + D_h x,  g = v silu(z),  r = rsqrt(mean(g^2) + eps),
    out = g r (1 + scale),

and :func:`gate_norm_bwd_ref` mirrors the backward kernel's formulas,
from the forward's r: n = g r, dn = dout (1 + scale), c = mean(dn n),
dg = r (dn - n c), dv = dg silu(z), dz = dg v silu'(z), dx = D_h dv,
dscale = sum of dout n, dD_h = sum of dv x over the head's features.
The model's own lines (``models/ssm.py::_gate_norm_plain``) round to the
model dtype twice on the way; the tests hold these against autograd of
them.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gate_norm_ref", "gate_norm_bwd_ref"]


def _forward(y, xh, z, D, scale, eps):
    f = torch.float64 if y.dtype == torch.float64 else torch.float32
    Bz, S, H, P = y.shape
    v = (y.to(f) + D.to(f)[:, None] * xh.to(f)).reshape(Bz, S, H * P)
    zf = z.to(f)
    sg = torch.sigmoid(zf)
    g = v * (zf * sg)
    r = torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return f, v, zf, sg, g, r


def gate_norm_ref(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                  D: torch.Tensor, scale: torch.Tensor,
                  eps: float) -> torch.Tensor:
    """y (Bz,S,H,P) float32 or float64; xh (Bz,S,H,P), z (Bz,S,H P);
    D (H,); scale (H P,) -> out (Bz,S,H P) in z's dtype."""
    f, _, _, _, g, r = _forward(y, xh, z, D, scale, eps)
    return (g * r * (1 + scale.to(f))).to(z.dtype)


def gate_norm_bwd_ref(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                      dout: torch.Tensor, D: torch.Tensor,
                      scale: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's formulas: (dy, dxh, dz, dD, dscale), dy in
    the working precision, dxh and dz in xh's and z's dtypes, dD in
    D's, dscale in scale's."""
    f, v, zf, sg, g, r = _forward(y, xh, z, D, scale, eps)
    Bz, S, H, P = y.shape
    n = g * r
    do = dout.to(f)
    dn = do * (1 + scale.to(f))
    c = (dn * n).mean(-1, keepdim=True)
    dg = r * (dn - n * c)
    dv = dg * (zf * sg)
    dz = dg * v * (sg * (1 + zf * (1 - sg)))
    dv4 = dv.reshape(Bz, S, H, P)
    dD = (dv4 * xh.to(f)).sum((0, 1, 3))
    dscale = (do * n).sum((0, 1))
    return (dv4, (D.to(f)[:, None] * dv4).to(xh.dtype), dz.to(z.dtype),
            dD.to(D.dtype), dscale.to(scale.dtype))
