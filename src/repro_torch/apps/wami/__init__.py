"""WAMI (wide-area motion imagery) accelerator — the paper's case study."""

from .cdfg import WAMI_KERNEL_FACTS, KernelFacts
from .components import (FRAME, N_LK, TILE, WamiComponent, build_components,
                         change_detection, debayer, gradient, grayscale,
                         hessian, matrix_add, matrix_invert, matrix_mul,
                         matrix_reshape, matrix_sub, sd_update,
                         steepest_descent, warp_affine)
from .cuda import (WAMI_CUDA_STAGES, WAMI_RECORDED_TILES,
                   wami_cuda_components, wami_cuda_oracle,
                   wami_cuda_plm_session, wami_cuda_session,
                   wami_cuda_unit_system)
from .knobs import WAMI_KNOB_TABLE, WAMI_TILE_SIZES, wami_knob_space
from .pipeline import (MATRIX_INV_LATENCY_S, lucas_kanade, wami_app,
                       wami_cosmos, wami_cosmos_no_memory, wami_exhaustive,
                       wami_hls_tool, wami_knob_spaces, wami_plm_planner,
                       wami_session, wami_tmg)

__all__ = [
    "FRAME", "TILE", "N_LK", "WamiComponent", "build_components",
    "KernelFacts", "WAMI_KERNEL_FACTS",
    "debayer", "grayscale", "gradient", "steepest_descent", "hessian",
    "sd_update", "matrix_add", "matrix_sub", "matrix_mul", "matrix_reshape",
    "matrix_invert", "warp_affine", "change_detection",
    "lucas_kanade", "wami_app", "wami_tmg", "wami_hls_tool",
    "wami_knob_spaces", "wami_cosmos", "wami_exhaustive",
    "wami_cosmos_no_memory", "wami_plm_planner", "wami_session",
    "WAMI_KNOB_TABLE", "WAMI_TILE_SIZES", "wami_knob_space",
    "MATRIX_INV_LATENCY_S",
    "WAMI_CUDA_STAGES", "WAMI_RECORDED_TILES", "wami_cuda_components",
    "wami_cuda_oracle", "wami_cuda_session", "wami_cuda_unit_system",
    "wami_cuda_plm_session",
]
