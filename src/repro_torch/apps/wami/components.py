"""WAMI accelerator components (PERFECT benchmark suite, paper Section 7).

Each component binds two things:

  * ``apply`` — the full-frame PyTorch implementation used by the
    runnable pipeline (``pipeline.py``);
  * its synthesis model — trip counts, PLM words and outer repeats from
    the frame geometry, plus the per-iteration CDFG facts
    (:data:`~repro_torch.apps.wami.cdfg.WAMI_KERNEL_FACTS`) that feed
    Eq. (1) and the hlsim scheduler.

Frame geometry follows PERFECT WAMI: 512x512 16-bit Bayer input frames,
processed by the accelerator in 128x128 PLM-resident tiles (16 tiles per
frame = ``outer_repeats``).  The Lucas-Kanade components run once per LK
refinement iteration (N_LK per frame).  The functions compute on the
device of their inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.hlsim import ComponentSpec, LoopNest
from ...core.knobs import KnobSpace
from ...kernels.wami_gradient.ref import gradient_ref
from ...kernels.wami_grayscale.ref import grayscale_ref
from ...kernels.wami_steep.ref import hessian_ref, steepest_descent_ref
from .cdfg import WAMI_KERNEL_FACTS
from .knobs import wami_knob_space

__all__ = [
    "FRAME", "TILE", "N_LK",
    "WamiComponent", "build_components",
    "debayer", "grayscale", "gradient", "steepest_descent", "hessian",
    "sd_update", "matrix_add", "matrix_sub", "matrix_mul", "matrix_reshape",
    "matrix_invert", "warp_affine", "change_detection",
]

FRAME = 512          # full frame edge (pixels)
TILE = 128           # PLM-resident tile edge
N_LK = 6             # Lucas-Kanade refinement iterations per frame
_GMM_K = 3           # change-detection mixture size


# ======================================================================
# Full-frame implementations
# ======================================================================

def debayer(bayer: torch.Tensor) -> torch.Tensor:
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


# the template-side stages are the plain versions of their CUDA kernels
grayscale = grayscale_ref                  # ITU-R BT.601 luma
gradient = gradient_ref                    # central differences, edge pad
steepest_descent = steepest_descent_ref    # (H, W, 6) affine sd images
hessian = hessian_ref                      # H = sum_x sd(x)^T sd(x)


def sd_update(sd: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """b = sum_x sd(x)^T err(x): (6,)."""
    return torch.einsum("hwk,hw->k", sd, err)


def matrix_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def matrix_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def matrix_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def matrix_reshape(a: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    return a.reshape(shape)


def matrix_invert(a: torch.Tensor) -> torch.Tensor:
    """6x6 inverse via unpivoted Gauss-Jordan (runs in SOFTWARE in the
    paper's system to preserve floating-point precision — modeled with a
    fixed effective latency in the TMG, Section 7.1)."""
    n = a.shape[0]
    dtype = torch.float64 if a.dtype == torch.float64 else torch.float32
    aug = torch.cat([a.to(dtype),
                     torch.eye(n, dtype=a.dtype, device=a.device).to(dtype)],
                    dim=1)
    for i in range(n):
        row = aug[i] / aug[i, i]
        aug[i] = row
        factors = aug[:, i].clone()
        factors[i] = 0.0
        aug = aug - factors[:, None] * row[None, :]
    return aug[:, n:]


def warp_affine(img: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of ``img`` by affine params p=(p1..p6):
    x' = (1+p1) x + p2 y + p3 ;  y' = p4 x + (1+p5) y + p6."""
    H, W = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=img.dtype, device=img.device),
        torch.arange(W, dtype=img.dtype, device=img.device), indexing="ij")
    sx = (1.0 + p[0]) * xx + p[1] * yy + p[2]
    sy = p[3] * xx + (1.0 + p[4]) * yy + p[5]
    x0 = torch.clamp(torch.floor(sx), 0, W - 2)
    y0 = torch.clamp(torch.floor(sy), 0, H - 2)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    top = i00 * (1 - fx) + i01 * fx
    bot = i10 * (1 - fx) + i11 * fx
    return top * (1 - fy) + bot * fy


def change_detection(gray: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                     w: torch.Tensor, *, lr: float = 0.05,
                     mahal_thresh: float = 6.25, fg_thresh: float = 0.7
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Per-pixel Gaussian-mixture background subtraction (K=3).

    Returns (mask, mu', var', w').  State arrays have shape (H, W, K).
    """
    x = gray[..., None]
    d2 = (x - mu) ** 2 / torch.clamp(var, min=1e-4)
    match = d2 < mahal_thresh                       # (H, W, K)
    any_match = torch.any(match, dim=-1)
    # best (lowest-d2) matching mixture component; argmin takes the
    # first index among ties
    d2_masked = torch.where(match, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2_masked, dim=-1)
    onehot = (F.one_hot(best, _GMM_K).to(gray.dtype)
              * any_match[..., None].to(gray.dtype))

    mu_n = mu + onehot * lr * (x - mu)
    var_n = var + onehot * lr * ((x - mu) ** 2 - var)
    w_n = (1 - lr) * w + lr * onehot
    # no match: replace weakest component with a fresh one centred at x
    weakest = torch.argmin(w, dim=-1)
    wh = (F.one_hot(weakest, _GMM_K).to(gray.dtype)
          * (~any_match)[..., None].to(gray.dtype))
    mu_n = mu_n * (1 - wh) + wh * x
    var_n = var_n * (1 - wh) + wh * 25.0
    w_n = w_n * (1 - wh) + wh * lr
    w_n = w_n / torch.sum(w_n, dim=-1, keepdim=True)
    # foreground: matched component is low-weight, or no match at all
    matched_w = torch.sum(onehot * w, dim=-1)
    mask = (~any_match) | (matched_w < (1.0 - fg_thresh))
    return mask, mu_n, var_n, w_n


# ======================================================================
# Component table
# ======================================================================

@dataclass
class WamiComponent:
    """Binds the functional implementation to its synthesis model."""

    name: str
    apply: Callable
    trip: int                      # dominant-loop iterations per execution
    words_in: int
    words_out: int
    outer_repeats: int
    knobs: KnobSpace
    plm_words: int = 0
    gamma_r_override: Optional[int] = None   # e.g. register-cached state
    gamma_w_override: Optional[int] = None   # e.g. register accumulators
    has_plm_access: bool = True
    base_tile: int = 0             # PLM tile the sizes above are for;
                                   # 0 = sizes do not depend on the tile

    def loop_nest(self) -> LoopNest:
        f = WAMI_KERNEL_FACTS[self.name]
        g_r = self.gamma_r_override
        if g_r is None:
            g_r = max(f.reads_per_input) if f.reads_per_input else 0
        g_w = self.gamma_w_override
        if g_w is None:
            g_w = max(1, f.writes)
        return LoopNest(trip=self.trip, gamma_r=g_r, gamma_w=g_w,
                        arith_ops=f.arith_ops, dep_depth=f.dep_depth,
                        live_values=f.live_values,
                        has_plm_access=self.has_plm_access)

    def spec(self) -> ComponentSpec:
        return ComponentSpec(name=self.name, loop=self.loop_nest(),
                             words_in=self.words_in, words_out=self.words_out,
                             word_bits=32, plm_words=self.plm_words,
                             outer_repeats=self.outer_repeats,
                             base_tile=self.base_tile)


def build_components(tile: int = TILE, frame: int = FRAME,
                     n_lk: int = N_LK) -> Dict[str, WamiComponent]:
    """The 12 synthesizable WAMI components (Table 1) + their knob spaces.

    Knob bounds follow Section 7.2: 'a number of ports in the interval
    [1, 16] and a maximum number of unrolls in the interval [8, 32],
    depending on the components'.
    """
    t2 = tile * tile
    tiles = (frame // tile) ** 2

    ks = wami_knob_space            # canonical Table-1 bounds

    comps = {
        "debayer": WamiComponent(
            name="debayer", apply=debayer,
            trip=t2 // 4, words_in=t2, words_out=3 * t2,
            outer_repeats=tiles, knobs=ks("debayer"), base_tile=tile),
        "grayscale": WamiComponent(
            name="grayscale", apply=grayscale,
            trip=t2, words_in=3 * t2, words_out=t2,
            outer_repeats=tiles, knobs=ks("grayscale"), base_tile=tile),
        "gradient": WamiComponent(
            name="gradient", apply=gradient,
            trip=t2, words_in=t2, words_out=2 * t2,
            outer_repeats=tiles, knobs=ks("gradient"), base_tile=tile),
        "steep_descent": WamiComponent(
            name="steep_descent", apply=steepest_descent,
            trip=t2, words_in=2 * t2, words_out=6 * t2,
            outer_repeats=tiles, knobs=ks("steep_descent"), base_tile=tile),
        "hessian": WamiComponent(
            name="hessian", apply=hessian,
            trip=t2, words_in=6 * t2, words_out=21,
            outer_repeats=tiles, knobs=ks("hessian"), base_tile=tile,
            gamma_w_override=1),          # accumulator lives in registers
        "sd_update": WamiComponent(
            name="sd_update", apply=sd_update,
            trip=t2, words_in=7 * t2, words_out=6,
            outer_repeats=tiles * n_lk, knobs=ks("sd_update"), base_tile=tile,
            gamma_w_override=1),
        "matrix_sub": WamiComponent(
            name="matrix_sub", apply=matrix_sub,
            trip=t2, words_in=2 * t2, words_out=t2,
            outer_repeats=tiles * n_lk, knobs=ks("matrix_sub"), base_tile=tile),
        "matrix_add": WamiComponent(
            name="matrix_add", apply=matrix_add,
            trip=36, words_in=72, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_add")),
        "matrix_mul": WamiComponent(
            name="matrix_mul", apply=matrix_mul,
            trip=36, words_in=72, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_mul")),
        "matrix_resh": WamiComponent(
            name="matrix_resh", apply=lambda a: matrix_reshape(a, (-1,)),
            trip=36, words_in=36, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_resh")),
        "warp": WamiComponent(
            name="warp", apply=warp_affine,
            trip=t2, words_in=t2, words_out=t2,
            outer_repeats=tiles * n_lk, knobs=ks("warp"), base_tile=tile),
        "change_det": WamiComponent(
            name="change_det", apply=change_detection,
            trip=t2, words_in=10 * t2, words_out=10 * t2,
            outer_repeats=tiles, knobs=ks("change_det"), base_tile=tile,
            gamma_r_override=1),          # GMM state cached in registers
    }
    return comps
