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

from ...core.hlsim import ComponentSpec, LoopNest
from ...core.knobs import KnobSpace
from ...kernels.wami_change_det.ref import change_detection_ref
from ...kernels.wami_debayer.ref import debayer_ref
from ...kernels.wami_gradient.ref import gradient_ref
from ...kernels.wami_grayscale.ref import grayscale_ref
from ...kernels.wami_steep.ref import hessian_ref, steepest_descent_ref
from ...kernels.wami_warp.ref import warp_affine_ref
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
