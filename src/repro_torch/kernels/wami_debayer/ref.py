"""Plain version: bilinear RGGB demosaic (same math as
apps.wami.components)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["debayer_ref"]


def debayer_ref(bayer: torch.Tensor) -> torch.Tensor:
    """Bilinear demosaic of an RGGB Bayer mosaic -> (H, W, 3) float32.

    R G      (0,0)=R (0,1)=G
    G B      (1,0)=G (1,1)=B
    """
    img = bayer.to(torch.float32)
    H, W = img.shape
    p = F.pad(img[None], (1, 1, 1, 1), mode="reflect")[0]
    c = p[1:-1, 1:-1]
    n, s = p[:-2, 1:-1], p[2:, 1:-1]
    w, e = p[1:-1, :-2], p[1:-1, 2:]
    nw, ne = p[:-2, :-2], p[:-2, 2:]
    sw, se = p[2:, :-2], p[2:, 2:]
    cross = (n + s + w + e) * 0.25
    diag = (nw + ne + sw + se) * 0.25
    horiz = (w + e) * 0.5
    vert = (n + s) * 0.5

    yy, xx = torch.meshgrid(torch.arange(H, device=img.device),
                            torch.arange(W, device=img.device), indexing="ij")
    r_loc = (yy % 2 == 0) & (xx % 2 == 0)
    g1_loc = (yy % 2 == 0) & (xx % 2 == 1)
    g2_loc = (yy % 2 == 1) & (xx % 2 == 0)
    b_loc = (yy % 2 == 1) & (xx % 2 == 1)

    r = torch.where(r_loc, c, torch.where(g1_loc, horiz,
                                          torch.where(g2_loc, vert, diag)))
    g = torch.where(r_loc | b_loc, cross, c)
    b = torch.where(b_loc, c, torch.where(g2_loc, horiz,
                                          torch.where(g1_loc, vert, diag)))
    return torch.stack([r, g, b], dim=-1)
