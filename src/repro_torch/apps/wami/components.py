"""WAMI accelerator components (PERFECT benchmark suite, paper Section 7).

Each component binds three things:

  * ``apply`` — the full-frame PyTorch implementation used by the
    runnable pipeline (``pipeline.py``);
  * ``kernel`` — the per-iteration scalar body (the CDFG) whose
    ``make_fx`` graph :mod:`.cdfg` walks to extract the facts that feed
    Eq. (1) and the hlsim scheduler (``hessian``'s stay pinned, see
    :data:`~repro_torch.apps.wami.cdfg.PINNED_FACTS`);
  * its synthesis model — trip counts, PLM words and outer repeats from
    the frame geometry.

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

from ...core.hlsim import ComponentSpec, LoopNest
from ...core.knobs import KnobSpace
from ...kernels.wami_change_det.ref import change_detection_ref
from ...kernels.wami_debayer.ref import debayer_ref
from ...kernels.wami_gradient.ref import gradient_ref
from ...kernels.wami_grayscale.ref import grayscale_ref
from ...kernels.wami_steep.ref import hessian_ref, steepest_descent_ref
from ...kernels.wami_warp.ref import warp_affine_ref
from .cdfg import component_facts
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


# ======================================================================
# Full-frame implementations
# ======================================================================

# the stages with a CUDA kernel are that kernel's plain version
debayer = debayer_ref                      # bilinear RGGB demosaic
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


warp_affine = warp_affine_ref              # affine warp, bilinear
change_detection = change_detection_ref    # per-pixel GMM, K=3


# ======================================================================
# Per-iteration scalar kernels (the CDFGs)
# ======================================================================

def _k_debayer(quad_win: torch.Tensor) -> torch.Tensor:
    """One 2x2 Bayer quad (with 1-px border: 4x4 window) -> 2x2x3 RGB."""
    w = quad_win
    out = []
    for (dy, dx), kind in (((1, 1), "R"), ((1, 2), "G1"),
                           ((2, 1), "G2"), ((2, 2), "B")):
        c = w[dy, dx]
        cross = (w[dy - 1, dx] + w[dy + 1, dx] + w[dy, dx - 1] + w[dy, dx + 1]) * 0.25
        diag = (w[dy - 1, dx - 1] + w[dy - 1, dx + 1]
                + w[dy + 1, dx - 1] + w[dy + 1, dx + 1]) * 0.25
        horiz = (w[dy, dx - 1] + w[dy, dx + 1]) * 0.5
        vert = (w[dy - 1, dx] + w[dy + 1, dx]) * 0.5
        if kind == "R":
            out += [c, cross, diag]
        elif kind == "G1":
            out += [horiz, c, vert]
        elif kind == "G2":
            out += [vert, c, horiz]
        else:
            out += [diag, cross, c]
    return torch.stack(out)


def _k_grayscale(rgb: torch.Tensor) -> torch.Tensor:
    return 0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2]


def _k_gradient(cross: torch.Tensor) -> torch.Tensor:
    # cross = [center, west, east, north, south]
    return torch.stack([(cross[2] - cross[1]) * 0.5,
                        (cross[4] - cross[3]) * 0.5])


def _k_steep(grad2: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    gx, gy = grad2[0], grad2[1]
    x, y = xy[0], xy[1]
    return torch.stack([gx * x, gx * y, gx, gy * x, gy * y, gy])


def _k_hessian(sd6: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    outer = sd6[:, None] * sd6[None, :]
    iu = torch.triu_indices(6, 6, device=sd6.device)
    return acc + outer[iu[0], iu[1]]


def _k_sd_update(sd6: torch.Tensor, err: torch.Tensor,
                 acc: torch.Tensor) -> torch.Tensor:
    return acc + sd6 * err


def _k_mat_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def _k_mat_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


def _k_mat_mul(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    return torch.dot(row, col)


def _k_mat_resh(a: torch.Tensor) -> torch.Tensor:
    return a * 1.0   # copy through the datapath


def _k_warp(neigh: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    fx, fy = frac[0], frac[1]
    top = neigh[0] * (1 - fx) + neigh[1] * fx
    bot = neigh[2] * (1 - fx) + neigh[3] * fx
    return top * (1 - fy) + bot * fy


def _k_change_det(px: torch.Tensor, state9: torch.Tensor) -> torch.Tensor:
    mu, var, w = state9[0:3], state9[3:6], state9[6:9]
    d2 = (px - mu) ** 2 / torch.clamp_min(var, 1e-4)
    match = d2 < 6.25
    any_match = torch.any(match)
    best = torch.argmin(torch.where(match, d2, float("inf")))
    onehot = (torch.arange(3, device=px.device) == best).to(px.dtype) * any_match
    lr = 0.05
    mu_n = mu + onehot * lr * (px - mu)
    var_n = var + onehot * lr * ((px - mu) ** 2 - var)
    w_n = (1 - lr) * w + lr * onehot
    matched_w = torch.sum(onehot * w)
    mask = (~any_match) | (matched_w < 0.3)
    return torch.cat([mu_n, var_n, w_n, mask[None].to(mu.dtype)])


# ======================================================================
# Component table
# ======================================================================

@dataclass
class WamiComponent:
    """Binds the functional implementation to its synthesis model."""

    name: str
    apply: Callable
    kernel: Callable
    kernel_args: Tuple
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
        f = component_facts(self.name, self.kernel, self.kernel_args)
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
    v = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    s = torch.zeros((), dtype=torch.float32)

    ks = wami_knob_space            # canonical Table-1 bounds

    comps = {
        "debayer": WamiComponent(
            name="debayer", apply=debayer,
            kernel=_k_debayer, kernel_args=(v(4, 4),),
            trip=t2 // 4, words_in=t2, words_out=3 * t2,
            outer_repeats=tiles, knobs=ks("debayer"), base_tile=tile),
        "grayscale": WamiComponent(
            name="grayscale", apply=grayscale,
            kernel=_k_grayscale, kernel_args=(v(3),),
            trip=t2, words_in=3 * t2, words_out=t2,
            outer_repeats=tiles, knobs=ks("grayscale"), base_tile=tile),
        "gradient": WamiComponent(
            name="gradient", apply=gradient,
            kernel=_k_gradient, kernel_args=(v(5),),
            trip=t2, words_in=t2, words_out=2 * t2,
            outer_repeats=tiles, knobs=ks("gradient"), base_tile=tile),
        "steep_descent": WamiComponent(
            name="steep_descent", apply=steepest_descent,
            kernel=_k_steep, kernel_args=(v(2), v(2)),
            trip=t2, words_in=2 * t2, words_out=6 * t2,
            outer_repeats=tiles, knobs=ks("steep_descent"), base_tile=tile),
        "hessian": WamiComponent(
            name="hessian", apply=hessian,
            kernel=_k_hessian, kernel_args=(v(6), v(21)),
            trip=t2, words_in=6 * t2, words_out=21,
            outer_repeats=tiles, knobs=ks("hessian"), base_tile=tile,
            gamma_w_override=1),          # accumulator lives in registers
        "sd_update": WamiComponent(
            name="sd_update", apply=sd_update,
            kernel=_k_sd_update, kernel_args=(v(6), s, v(6)),
            trip=t2, words_in=7 * t2, words_out=6,
            outer_repeats=tiles * n_lk, knobs=ks("sd_update"), base_tile=tile,
            gamma_w_override=1),
        "matrix_sub": WamiComponent(
            name="matrix_sub", apply=matrix_sub,
            kernel=_k_mat_sub, kernel_args=(s, s),
            trip=t2, words_in=2 * t2, words_out=t2,
            outer_repeats=tiles * n_lk, knobs=ks("matrix_sub"), base_tile=tile),
        "matrix_add": WamiComponent(
            name="matrix_add", apply=matrix_add,
            kernel=_k_mat_add, kernel_args=(s, s),
            trip=36, words_in=72, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_add")),
        "matrix_mul": WamiComponent(
            name="matrix_mul", apply=matrix_mul,
            kernel=_k_mat_mul, kernel_args=(v(6), v(6)),
            trip=36, words_in=72, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_mul")),
        "matrix_resh": WamiComponent(
            name="matrix_resh", apply=lambda a: matrix_reshape(a, (-1,)),
            kernel=_k_mat_resh, kernel_args=(s,),
            trip=36, words_in=36, words_out=36,
            outer_repeats=n_lk, knobs=ks("matrix_resh")),
        "warp": WamiComponent(
            name="warp", apply=warp_affine,
            kernel=_k_warp, kernel_args=(v(4), v(2)),
            trip=t2, words_in=t2, words_out=t2,
            outer_repeats=tiles * n_lk, knobs=ks("warp"), base_tile=tile),
        "change_det": WamiComponent(
            name="change_det", apply=change_detection,
            kernel=_k_change_det, kernel_args=(s, v(9)),
            trip=t2, words_in=10 * t2, words_out=10 * t2,
            outer_repeats=tiles, knobs=ks("change_det"), base_tile=tile,
            gamma_r_override=1),          # GMM state cached in registers
    }
    return comps
