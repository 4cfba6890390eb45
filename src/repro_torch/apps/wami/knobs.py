"""The canonical WAMI knob-space table (Section 7.2).

One source of truth for the per-component exploration bounds —
``(max_ports, max_unrolls)`` per Table 1 component, following the paper:
'a number of ports in the interval [1, 16] and a maximum number of
unrolls in the interval [8, 32], depending on the components'.
``components.build_components`` and the drivers import from here
instead of repeating the table inline.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ...core.knobs import KnobSpace

__all__ = ["WAMI_KNOB_TABLE", "WAMI_TILE_SCALED", "WAMI_TILE_SIZES",
           "wami_knob_space"]

# component -> (max_ports, max_unrolls)
WAMI_KNOB_TABLE: Dict[str, Tuple[int, int]] = {
    "debayer":       (16, 32),
    "grayscale":     (16, 32),
    "gradient":      (16, 32),
    "steep_descent": (8, 16),
    "hessian":       (16, 32),
    "sd_update":     (16, 32),
    "matrix_sub":    (8, 16),
    "matrix_add":    (4, 8),
    "matrix_mul":    (4, 12),
    "matrix_resh":   (2, 8),
    "warp":          (8, 16),
    "change_det":    (8, 16),
}


# components whose PLM footprint scales with the tile edge — only these
# get the tile knob axis; the 6x6 matrix stages are tile-invariant
WAMI_TILE_SCALED = frozenset({
    "debayer", "grayscale", "gradient", "steep_descent", "hessian",
    "sd_update", "matrix_sub", "warp", "change_det",
})

# canonical tile axis for the 512x512 PERFECT frame: the native 128 plus
# one step down/up in PLM capacity (frame % tile == 0 for all three)
WAMI_TILE_SIZES: Tuple[int, ...] = (64, 128, 256)


def wami_knob_space(component: str, *, clock_ns: float = 1.0,
                    tile_sizes: Sequence[int] = ()) -> KnobSpace:
    """The Table-1 bounds, optionally with a tile axis.  ``tile_sizes``
    only applies to tile-scaled components (WAMI_TILE_SCALED) — the
    matrix stages would just re-synthesize identical points."""
    max_ports, max_unrolls = WAMI_KNOB_TABLE[component]
    tiles = tuple(tile_sizes) if component in WAMI_TILE_SCALED else ()
    return KnobSpace(clock_ns=clock_ns, max_ports=max_ports,
                     max_unrolls=max_unrolls, tile_sizes=tiles)
