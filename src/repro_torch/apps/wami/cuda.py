"""The WAMI stages as a measured :class:`CudaOracle` backend.

Binds the knob-parameterized CUDA kernels under ``repro_torch.kernels``
to the COSMOS component names:

  * four stages of the Lucas-Kanade template side are priced by
    *running* their kernel on a PLM-sized tile (``ports`` -> column-bank
    grid columns, ``unrolls`` -> rows per CTA): grayscale, gradient,
    steepest descent, Hessian;
  * every other stage — debayer, warp, change detection and the 6x6
    matrix stages — is priced by the analytical fallback inside the same
    oracle, so the full Fig. 8 TMG explores end-to-end.

Inputs are baked deterministically per tile size from
``numpy.random.default_rng(42)``, so that record and replay price the
same physical workload.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ...core.cuda_oracle import (CudaKernelSpec, CudaOracle, MeasurementSet,
                                 device_kind_of, open_recording)
from ...core.hlsim import HLSTool
from ...core.session import ExplorationSession
from ...kernels import wami_gradient, wami_grayscale, wami_steep
from ...utils import from_numpy, resolve_device
from . import components as C
from .pipeline import (MATRIX_INV_LATENCY_S, wami_hls_tool, wami_knob_spaces,
                       wami_tmg)

__all__ = ["WAMI_CUDA_STAGES", "wami_cuda_components", "wami_cuda_oracle",
           "wami_cuda_session"]

# the stages with a CUDA kernel, in TMG order
WAMI_CUDA_STAGES = ("grayscale", "gradient", "steep_descent", "hessian")


def wami_cuda_components(tile: int = C.TILE, device=None
                         ) -> Dict[str, CudaKernelSpec]:
    """CudaKernelSpec per measured WAMI stage, on a (tile, tile)
    PLM-resident frame tile with deterministic baked inputs on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(42)
    f32 = np.float32
    rgb, gray, gx, gy, sd = from_numpy((
        (rng.uniform(size=(tile, tile, 3)) * 255.0).astype(f32),
        (rng.uniform(size=(tile, tile)) * 255.0).astype(f32),
        rng.standard_normal((tile, tile)).astype(f32),
        rng.standard_normal((tile, tile)).astype(f32),
        rng.standard_normal((tile, tile, 6)).astype(f32)), dev)

    def bake(fn: Callable, *args: torch.Tensor) -> Callable:
        def build(ports: int, unrolls: int):
            def run():
                return fn(*args, ports=ports, unrolls=unrolls)
            return run
        return build

    shape = (tile, tile)
    return {
        "grayscale": CudaKernelSpec(
            name="grayscale", shape=shape,
            build=bake(wami_grayscale.grayscale, rgb),
            vmem_bytes=wami_grayscale.vmem_bytes,
            grid_steps=wami_grayscale.grid_steps, n_in=3, n_out=1),
        "gradient": CudaKernelSpec(
            name="gradient", shape=shape,
            build=bake(wami_gradient.gradient, gray),
            vmem_bytes=wami_gradient.vmem_bytes,
            grid_steps=wami_gradient.grid_steps, n_in=4, n_out=2),
        "steep_descent": CudaKernelSpec(
            name="steep_descent", shape=shape,
            build=bake(wami_steep.steepest_descent, gx, gy),
            vmem_bytes=wami_steep.vmem_bytes,
            grid_steps=wami_steep.grid_steps, n_in=2, n_out=6),
        "hessian": CudaKernelSpec(
            name="hessian", shape=shape,
            build=bake(wami_steep.hessian, sd),
            vmem_bytes=wami_steep.hessian_vmem_bytes,
            grid_steps=wami_steep.grid_steps, n_in=6, n_out=1),
    }


def wami_cuda_oracle(mode: str = "measure", *, tile: int = C.TILE,
                     device=None,
                     measurements: Optional[MeasurementSet] = None,
                     store_path: Optional[str] = None,
                     fallback: Optional[HLSTool] = None,
                     device_kind: Optional[str] = None,
                     flush_every: int = 16,
                     **kwargs) -> CudaOracle:
    """The measured WAMI oracle: the four kernels timed on ``device``
    (default: the CUDA card), everything else priced by
    ``wami_hls_tool()``.  ``"record"`` and ``"replay"`` go through
    ``measurements`` or the recording at ``store_path`` (record mode
    starts it when absent and flushes every ``flush_every`` timings).
    Remaining keywords flow to :class:`CudaOracle` (``timer``,
    ``smem_budget``)."""
    components = wami_cuda_components(tile, device)
    if device_kind is None:
        device_kind = device_kind_of(device)
    if measurements is None and mode in ("record", "replay"):
        if store_path is None:
            raise ValueError(f"mode={mode!r} needs measurements= or "
                             f"store_path=")
        measurements = open_recording(store_path, mode=mode, tile=tile,
                                      device_kind=device_kind,
                                      flush_every=flush_every)
    return CudaOracle(components, mode=mode, measurements=measurements,
                      fallback=fallback or wami_hls_tool(),
                      device=device, device_kind=device_kind,
                      native_tile=tile, **kwargs)


def wami_cuda_session(delta: float = 0.25, *, mode: str = "measure",
                      tile: int = C.TILE, workers: int = 1, device=None,
                      oracle: Optional[CudaOracle] = None,
                      **kwargs) -> ExplorationSession:
    """An :class:`ExplorationSession` over the WAMI TMG driven by the
    measured backend: the WAMI TMG and Table-1 knob spaces, Matrix-Inv
    fixed at its software latency, and ``delta`` steps of the LP sweep.
    Remaining keywords flow to :func:`wami_cuda_oracle` unless a
    pre-built ``oracle`` is given."""
    tool = oracle or wami_cuda_oracle(mode, tile=tile, device=device,
                                      **kwargs)
    return ExplorationSession(wami_tmg(), tool, wami_knob_spaces(),
                              delta=delta,
                              fixed={"matrix_inv": MATRIX_INV_LATENCY_S},
                              workers=workers)
