"""The WAMI stages as a measured :class:`CudaOracle` backend.

Binds the knob-parameterized CUDA kernels under ``repro_torch.kernels``
to the COSMOS component names, registers WAMI with the package's
App/Backend registry (:mod:`repro_torch.core.registry`), and keeps the
session constructors as thin wrappers over ``build_session("wami",
"cuda")``:

  * seven stages are priced by *running* their kernel on a PLM-sized
    tile (``ports`` -> column-bank grid columns, ``unrolls`` -> rows per
    CTA): debayer, grayscale, gradient, steepest descent, Hessian, warp,
    change detection;
  * the 6x6 matrix stages (``sd_update``, ``matrix_*``) have no kernel
    worth measuring and are priced by the analytical fallback inside the
    same oracle, so the full Fig. 8 TMG explores end-to-end;
  * the share-PLM drive (:func:`wami_cuda_plm_session`) adds the tile
    knob and the PLM planner, with the analytical fallback calibrated
    onto the measured axes from the native tile's recording
    (:func:`wami_cuda_unit_system`).

Inputs are baked deterministically per tile size from
``numpy.random.default_rng(42)``, so that record and replay price the
same physical workload.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ...core.cuda_oracle import (CudaKernelSpec, CudaOracle, MeasurementSet,
                                 MeasurementStore, device_kind_of,
                                 open_recording)
from ...core.hlsim import HLSTool
from ...core.plm.units import UnitSystem, fit_unit_system
from ...core.registry import App, build_session, get_app, register_app
from ...core.session import ExplorationSession
from ...kernels import (wami_change_det, wami_debayer, wami_gradient,
                        wami_grayscale, wami_steep, wami_warp)
from ...utils import from_numpy, resolve_device
from . import components as C
from .knobs import WAMI_TILE_SIZES
from .pipeline import (MATRIX_INV_LATENCY_S, wami_hls_tool, wami_knob_spaces,
                       wami_plm_planner, wami_tmg)

__all__ = ["WAMI_CUDA_STAGES", "WAMI_RECORDED_TILES", "wami_cuda_components",
           "wami_cuda_parity_cases", "wami_cuda_oracle", "wami_cuda_session",
           "wami_cuda_unit_system", "wami_cuda_plm_session",
           "default_measurement_path"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", ".."))

# the tiles the WAMI kernels record at, one store file per tile; sessions
# load only the native 128 unless the caller names more
WAMI_RECORDED_TILES = (64, 128, 256)
_RECORD_HINT = ("record on the card: build_session('wami', 'cuda', "
                "mode='record', tiles=(N,))")

# the stages with a CUDA kernel, in TMG order
WAMI_CUDA_STAGES = ("debayer", "grayscale", "gradient", "steep_descent",
                    "hessian", "warp", "change_det")

# the DSE's baked affine parameters: a shift large enough that the warp
# clamps at the frame's border
DSE_P_AFFINE = (0.01, -0.005, 0.8, 0.004, -0.01, -0.6)
# shear terms small enough that every source fraction stays in
# ~[0.3, 0.7]: the floor() cell is then the same however the address
# arithmetic is rounded
PARITY_P_AFFINE = (1 / 1024, -1 / 2048, 0.5, 1 / 2048, -1 / 1024, 0.5)


def default_measurement_path(tile: int = C.TILE) -> str:
    """The WAMI kernels' recording on the card at ``tile``."""
    return os.path.join(_REPO_ROOT, "artifacts", "measurements",
                        f"wami_cuda_tile{tile}.json")


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
    # drawn after the four stages above, which keep their inputs
    bayer, noise = from_numpy((
        (rng.uniform(size=(tile, tile)) * 1023.0).astype(f32),
        rng.standard_normal((tile, tile, 3)).astype(f32)), dev)
    p = torch.tensor(DSE_P_AFFINE, dtype=torch.float32, device=dev)
    mu = gray[..., None] + noise * 8.0
    var = torch.full((tile, tile, 3), 36.0, dtype=torch.float32, device=dev)
    w = torch.full((tile, tile, 3), 1.0 / 3.0, dtype=torch.float32,
                   device=dev)

    def bake(fn: Callable, *args: torch.Tensor) -> Callable:
        def build(ports: int, unrolls: int):
            def run():
                return fn(*args, ports=ports, unrolls=unrolls)
            return run
        return build

    shape = (tile, tile)
    return {
        "debayer": CudaKernelSpec(
            name="debayer", shape=shape,
            build=bake(wami_debayer.debayer, bayer),
            vmem_bytes=wami_debayer.vmem_bytes,
            grid_steps=wami_debayer.grid_steps, n_in=9, n_out=3),
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
        "warp": CudaKernelSpec(
            name="warp", shape=shape,
            build=bake(wami_warp.warp_affine, gray, p),
            vmem_bytes=wami_warp.vmem_bytes,
            grid_steps=wami_warp.grid_steps, n_in=6, n_out=1),
        "change_det": CudaKernelSpec(
            name="change_det", shape=shape,
            build=bake(wami_change_det.change_detection, gray, mu, var, w),
            vmem_bytes=wami_change_det.vmem_bytes,
            grid_steps=wami_change_det.grid_steps, n_in=10, n_out=10),
    }


def wami_cuda_parity_cases(tile: int = C.TILE, device=None):
    """(name, op, plain_fn, args) per WAMI stage kernel, on a (tile, tile)
    frame on ``device`` (default: the CUDA card): each op at its default
    knobs is held against its plain version.  Inputs come from
    ``numpy.random.default_rng(3)``; the warp uses the small-shear
    :data:`PARITY_P_AFFINE`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    f32 = np.float32
    bayer, rgb, gray, gx, gy, sd, noise = from_numpy((
        (rng.uniform(size=(tile, tile)) * 1023.0).astype(f32),
        (rng.uniform(size=(tile, tile, 3)) * 255.0).astype(f32),
        (rng.uniform(size=(tile, tile)) * 255.0).astype(f32),
        rng.standard_normal((tile, tile)).astype(f32),
        rng.standard_normal((tile, tile)).astype(f32),
        rng.standard_normal((tile, tile, 6)).astype(f32),
        rng.standard_normal((tile, tile, 3)).astype(f32)), dev)
    p = torch.tensor(PARITY_P_AFFINE, dtype=torch.float32, device=dev)
    mu = gray[..., None] + noise * 8.0
    var = torch.full((tile, tile, 3), 36.0, dtype=torch.float32, device=dev)
    w = torch.full((tile, tile, 3), 1.0 / 3.0, dtype=torch.float32,
                   device=dev)
    return [
        ("wami_debayer", wami_debayer.debayer, wami_debayer.debayer_oracle,
         (bayer,)),
        ("wami_grayscale", wami_grayscale.grayscale,
         wami_grayscale.grayscale_oracle, (rgb,)),
        ("wami_gradient", wami_gradient.gradient,
         wami_gradient.gradient_oracle, (gray,)),
        ("wami_steep", wami_steep.steepest_descent,
         wami_steep.steepest_descent_oracle, (gx, gy)),
        ("wami_hessian", wami_steep.hessian, wami_steep.hessian_oracle,
         (sd,)),
        ("wami_warp", wami_warp.warp_affine, wami_warp.warp_affine_oracle,
         (gray, p)),
        ("wami_change_det", wami_change_det.change_detection,
         wami_change_det.change_detection_oracle, (gray, mu, var, w)),
    ]


def wami_cuda_oracle(mode: str = "measure", *, tile: int = C.TILE,
                     device=None,
                     measurements: Optional[MeasurementSet] = None,
                     store_path: Optional[str] = None,
                     fallback: Optional[HLSTool] = None,
                     device_kind: Optional[str] = None,
                     flush_every: int = 16,
                     **kwargs) -> CudaOracle:
    """The measured WAMI oracle: the seven kernels timed on ``device``
    (default: the CUDA card), the 6x6 matrix stages priced by
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
                      native_tile=tile, record_hint=_RECORD_HINT, **kwargs)


def wami_cuda_session(delta: float = 0.25, *, mode: str = "measure",
                      tile: int = C.TILE, workers: int = 1, device=None,
                      oracle: Optional[CudaOracle] = None,
                      **kwargs) -> ExplorationSession:
    """An :class:`ExplorationSession` over the WAMI TMG driven by the
    measured backend — ``build_session("wami", "cuda")`` with this
    signature: the WAMI TMG and Table-1 knob spaces, Matrix-Inv fixed at
    its software latency, and ``delta`` steps of the LP sweep.
    Remaining keywords flow to :func:`wami_cuda_oracle` unless a
    pre-built ``oracle`` is given."""
    tool = oracle or wami_cuda_oracle(mode, tile=tile, device=device,
                                      **kwargs)
    return build_session("wami", "cuda", tool=tool, delta=delta,
                         workers=workers)


def wami_cuda_unit_system(tile: int = C.TILE,
                          store: Optional[MeasurementStore] = None
                          ) -> UnitSystem:
    """Exchange rates fitted from a recording at ``tile`` (default: the
    one at :func:`default_measurement_path`): per-component latency
    scales plus one global bytes-per-mm² area rate.  Derived from the
    store's sorted entries and the deterministic footprint formulas —
    byte-reproducible on any machine holding the recording.  The fit
    reads the kernel specs' shapes and footprint models only and never
    runs them, so their inputs are built on the CPU (the ``meta`` device
    would pull in torch's compiler stack, seconds of import)."""
    if store is None:       # an empty store is a store: fit from it
        store = MeasurementStore.load(default_measurement_path(tile))
    return fit_unit_system(store, wami_cuda_components(tile, "cpu"),
                           wami_hls_tool())


def wami_cuda_plm_session(delta: float = 0.25, *,
                          tile_sizes: Optional[tuple] = (64, 128),
                          measured_tiles: Sequence[int] = (C.TILE,),
                          workers: int = 1, share_plm: bool = True,
                          mode: str = "measure",
                          measurement_path: Optional[
                              Callable[[int], str]] = None,
                          **kwargs) -> ExplorationSession:
    """The memory-co-design WAMI drive — ``build_session("wami", "cuda",
    share_plm=True)`` over the recordings at ``measurement_path(t)``
    (default: :func:`default_measurement_path`), in ``mode`` as there
    (``"record"`` on the card times what they miss, ``"replay"`` runs
    anywhere):

      * the tile knob is a third axis on the tile-scaled components —
        the native tile 128 and the tiles in ``measured_tiles`` price
        through their recordings, other tiles through the unit-calibrated
        analytical fallback (``missing="fallback"`` also covers mapped
        points the recorded walk never touched, so the drive stays
        deterministic);
      * the fallback reports measured-axis latencies and byte areas
        (:func:`wami_cuda_unit_system`, fitted from the tile-128
        recording), so the mixed system front is unit-clean;
      * the map phase prices the memory subsystem through the PLM
        planner: the TMG certifies the six LK-loop components mutually
        exclusive and their PLMs become one shared multi-bank memory.

    Remaining keywords flow to :func:`build_session`: the backend's
    ``device``, ``device_kind``, ``smem_budget``, and the session's
    ``verify_plans``, ``on_event``, ...
    """
    app = get_app("wami")
    if measurement_path is not None:
        app = replace(app, measurement_path=measurement_path)
    # an explicitly empty tile_sizes means "no tile axis" — pass () so
    # build_session does NOT substitute the app's measured default
    return build_session(app, "cuda", delta=delta, share_plm=share_plm,
                         tile_sizes=tuple(tile_sizes or ()),
                         tiles=tuple(dict.fromkeys((C.TILE,
                                                    *measured_tiles))),
                         workers=workers, mode=mode, **kwargs)


# ----------------------------------------------------------------------
# registration: `get_app("wami")` of repro_torch.core.registry resolves
# to this record
# ----------------------------------------------------------------------
register_app(App(
    name="wami",
    description="WAMI Lucas-Kanade + change detection (the paper's "
                "Fig. 8 case study): 12 HLS components + 1 software stage",
    tmg=wami_tmg,
    knob_spaces=wami_knob_spaces,
    analytical=wami_hls_tool,
    fixed={"matrix_inv": MATRIX_INV_LATENCY_S},
    delta=0.25,
    kernel_specs=wami_cuda_components,
    native_tile=C.TILE,
    measurement_path=default_measurement_path,
    recorded_tiles=WAMI_RECORDED_TILES,
    default_tiles=(C.TILE,),
    calibrated_fallback=lambda store=None: wami_cuda_unit_system(
        store=store).calibrated(wami_hls_tool()),
    record_hint=_RECORD_HINT,
    plm_planner=wami_plm_planner,
    plm_tile_sizes=WAMI_TILE_SIZES,
    plm_tile_sizes_measured=(64, 128),
    parity_cases=wami_cuda_parity_cases,
))
