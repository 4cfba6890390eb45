"""The WAMI application: Lucas-Kanade alignment + change detection.

The paper's case study (Section 7) as a runnable PyTorch program, plus
its TMG system model (Fig. 8) and the COSMOS entry points:

  * :func:`lucas_kanade` — inverse-compositional LK affine registration
    built from the WAMI components;
  * :func:`wami_app` — frame-stream driver: debayer -> grayscale -> LK
    align -> warp -> GMM change detection;
  * :func:`wami_tmg` — the Fig. 8 timed marked graph (Matrix-Inv is a
    software transition with fixed latency);
  * :func:`wami_cosmos` / :func:`wami_exhaustive` — DSE drivers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ...core import (CosmosResult, ExhaustiveResult, HLSTool, KnobSpace,
                     OracleLedger, Place, TMG, Transition, cosmos_dse,
                     exhaustive_dse)
from ...utils import resolve_device
from . import components as C
from .knobs import WAMI_KNOB_TABLE, WAMI_TILE_SIZES, wami_knob_space

__all__ = ["lucas_kanade", "wami_app", "wami_tmg", "wami_hls_tool",
           "wami_knob_spaces", "wami_cosmos", "wami_exhaustive",
           "WAMI_KNOB_TABLE", "WAMI_TILE_SIZES", "MATRIX_INV_LATENCY_S"]

# Matrix-Inv runs in software (Section 7.1): fixed effective latency.
# 6x6 Gauss-Jordan on an embedded core, amortized per frame.
MATRIX_INV_LATENCY_S = 40e-6


# ----------------------------------------------------------------------
# Functional pipeline
# ----------------------------------------------------------------------

def lucas_kanade(template: torch.Tensor, image: torch.Tensor,
                 n_iters: int = C.N_LK) -> torch.Tensor:
    """Inverse-compositional LK: find affine p aligning ``image`` to
    ``template`` (both on one device).  Returns p=(p1..p6)."""
    gx, gy = C.gradient(template)
    sd = C.steepest_descent(gx, gy)                      # (H, W, 6)
    H = C.hessian(sd)                                    # (6, 6)
    Hinv = C.matrix_invert(
        H + 1e-3 * torch.eye(6, dtype=H.dtype, device=H.device))
    p = torch.zeros(6, dtype=template.dtype, device=template.device)
    for _ in range(n_iters):
        warped = C.warp_affine(image, p)
        err = C.matrix_sub(warped, template)             # error image
        b = C.sd_update(sd, err)                         # (6,)
        dp = C.matrix_reshape(C.matrix_mul(Hinv, b), (6,))
        # inverse-compositional update: p <- p ∘ dp^-1 (first-order)
        p_new = C.matrix_sub(p, dp)
        p = C.matrix_add(p_new, torch.zeros_like(p_new))
    return p


def wami_app(bayer_frames, n_iters: int = C.N_LK, *, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end WAMI over a stream of Bayer frames (T, H, W), a tensor
    or a numpy array, computed on ``device`` (default: the CUDA card).

    Returns (masks (T-1, H, W) bool, warp params (T-1, 6)).
    """
    dev = resolve_device(device)
    frames = torch.as_tensor(bayer_frames).to(dev)
    grays = torch.stack([C.grayscale(C.debayer(f)) for f in frames])
    template = grays[0]
    Himg, Wimg = template.shape
    mu = template[..., None].repeat(1, 1, 3)
    var = torch.full((Himg, Wimg, 3), 36.0, dtype=template.dtype, device=dev)
    w = torch.full((Himg, Wimg, 3), 1.0 / 3.0, dtype=template.dtype,
                   device=dev)
    masks, ps = [], []
    for gray in grays[1:]:
        p = lucas_kanade(template, gray, n_iters=n_iters)
        aligned = C.warp_affine(gray, p)
        mask, mu, var, w = C.change_detection(aligned, mu, var, w)
        masks.append(mask)
        ps.append(p)
    return torch.stack(masks), torch.stack(ps)


# ----------------------------------------------------------------------
# System model (Fig. 8)
# ----------------------------------------------------------------------

def wami_tmg(buffers: int = 2, frames_in_flight: int = 4) -> TMG:
    """The WAMI TMG.  Forward edges carry no initial tokens; each has a
    backward capacity edge with ``buffers`` tokens (ping-pong channels,
    Fig. 3).  The LK refinement loop is an algorithmic feedback cycle
    with a single token (iterations serialize), and the frame stream is
    closed by a feedback place carrying the frames in flight."""
    names = ["debayer", "grayscale", "gradient", "steep_descent", "hessian",
             "matrix_inv", "warp", "matrix_sub", "sd_update", "matrix_mul",
             "matrix_add", "matrix_resh", "change_det"]
    ts = [Transition(n) for n in names]
    places: List[Place] = []

    def chain(a: str, b: str, tokens_fwd: int = 0):
        places.append(Place(f"fwd:{a}->{b}", a, b, tokens=tokens_fwd))
        places.append(Place(f"cap:{b}->{a}", b, a, tokens=buffers))

    # main stream
    chain("debayer", "grayscale")
    chain("grayscale", "gradient")
    # template side of LK
    chain("gradient", "steep_descent")
    chain("steep_descent", "hessian")
    chain("hessian", "matrix_inv")
    chain("matrix_inv", "matrix_mul")
    # image side of LK (iterated)
    chain("grayscale", "warp")
    chain("warp", "matrix_sub")
    chain("matrix_sub", "sd_update")
    chain("sd_update", "matrix_mul")
    chain("matrix_mul", "matrix_add")
    chain("matrix_add", "matrix_resh")
    # LK refinement loop: new params feed the next warp; one token, so
    # the refinement chain serializes per iteration.
    places.append(Place("alg:matrix_resh->warp", "matrix_resh", "warp", tokens=1))
    chain("matrix_resh", "change_det")
    # self-capacity (a module cannot re-fire while busy)
    for n in names:
        places.append(Place(f"self:{n}", n, n, tokens=1))
    # close the frame stream
    places.append(Place("loop:change_det->debayer", "change_det", "debayer",
                        tokens=frames_in_flight + len(names)))
    return TMG(ts, places)


# ----------------------------------------------------------------------
# DSE drivers
# ----------------------------------------------------------------------

def wami_hls_tool(noise: float = 1.0, tile: int = C.TILE,
                  frame: int = C.FRAME) -> HLSTool:
    """The analytical WAMI oracle.  The retile factory rebuilds the
    component table exactly at a requested tile (trip counts, PLM sizes
    and outer repeats all recomputed from the frame geometry), which is
    what makes the tile knob honest for this backend."""
    comps = C.build_components(tile=tile, frame=frame)
    return HLSTool({n: c.spec() for n, c in comps.items()}, noise=noise,
                   retile=lambda t: {
                       n: c.spec()
                       for n, c in C.build_components(tile=t,
                                                      frame=frame).items()})


def wami_knob_spaces(tile: int = C.TILE, frame: int = C.FRAME,
                     tile_sizes: Tuple[int, ...] = ()
                     ) -> Dict[str, KnobSpace]:
    """Per-component knob bounds; pass ``tile_sizes`` (e.g.
    ``WAMI_TILE_SIZES``) to open the tile axis on the tile-scaled
    components."""
    comps = C.build_components(tile=tile, frame=frame)
    if not tile_sizes:
        return {n: c.knobs for n, c in comps.items()}
    return {n: wami_knob_space(n, tile_sizes=tile_sizes) for n in comps}


def wami_cosmos(delta: float = 0.25, noise: float = 1.0,
                counting: Optional[OracleLedger] = None, *,
                workers: int = 1) -> CosmosResult:
    """Run the full COSMOS methodology on WAMI (the paper's experiment)."""
    tool = wami_hls_tool(noise=noise)
    return cosmos_dse(wami_tmg(), tool, wami_knob_spaces(), delta=delta,
                      fixed={"matrix_inv": MATRIX_INV_LATENCY_S},
                      counting=counting, workers=workers)


def wami_exhaustive(noise: float = 1.0,
                    counting: Optional[OracleLedger] = None, *,
                    workers: int = 1) -> ExhaustiveResult:
    """The exhaustive baseline: synthesize every knob combination."""
    tool = wami_hls_tool(noise=noise)
    spaces = wami_knob_spaces()
    comps = [n for n in spaces]     # matrix_inv excluded (software)
    return exhaustive_dse(comps, tool, spaces, counting=counting,
                          workers=workers)
