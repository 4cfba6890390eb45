"""The fleet application: a hybrid attention + SSD serving pipeline.

A two-stage ML pipeline — a flash-attention stage feeding an SSD
(Mamba2) scan stage, the attention/SSM hybrid split — explored by
COSMOS on two backends:

  * **measured** — the two stages as :class:`CudaKernelSpec`s over the
    hand-written CUDA kernels ``kernels/flash_attention`` and
    ``kernels/ssd_scan``, timed on the card per knob point.  ``ports``
    maps onto the kernels' parallel axis (query-block columns:
    ``block_q = S / ports``; SSD head lanes) and ``unrolls`` onto the
    sequential block depth (``block_kv = 16 * unrolls`` KV rows;
    ``chunk = 8 * unrolls`` tokens) — the JAX package's knob maps;
  * **analytical** — :class:`~repro_torch.core.xlatool.XLATool` over
    (ModelConfig, ShapeSpec) stages priced on the chip table (an H100
    SXM): ``ports`` is the stage's fleet share (chips), ``unrolls`` the
    inverse microbatching, cost the total device memory claimed.

The pipeline TMG uses single-buffer channels: adjacent stages serialize
(Fig. 3 with buffers=1), which the PLM planner's TMG certificate turns
into a shared-memory opportunity — the two stages may time-multiplex one
shared-memory pool.  The footprint models (``flash_vmem_bytes``,
``ssd_vmem_bytes``) are the JAX package's, byte for byte, so the
measured fronts compare with its ``PallasOracle`` on the same walls.
The app registers as ``get_app("fleet")`` of
:mod:`repro_torch.core.registry`; :func:`fleet_calibrated_tool` is its
measured backend's unit-calibrated fallback.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ...configs import SHAPES, get_config
from ...core.cuda_oracle import (CudaKernelSpec, CudaOracle, MeasurementSet,
                                 MeasurementStore, device_kind_of,
                                 open_recording)
from ...core.knobs import KnobSpace
from ...core.plm.planner import PLMPlanner
from ...core.plm.units import UnitSystem, fit_unit_system
from ...core.registry import App, build_session, register_app
from ...core.session import ExplorationSession
from ...core.tmg import TMG, pipeline_tmg
from ...core.xlatool import XLATool
from ...kernels.flash_attention import mha, mha_ref
from ...kernels.ssd_scan import ssd, ssd_oracle
from ...utils import from_numpy, resolve_device

__all__ = ["FLASH_S", "FLASH_D", "FLASH_HEADS", "SSD_S", "SSD_P", "SSD_N",
           "SSD_MAX_HEADS", "fleet_tmg", "fleet_knob_spaces",
           "fleet_xla_tool", "flash_vmem_bytes", "flash_grid_steps",
           "ssd_vmem_bytes", "ssd_grid_steps", "fleet_cuda_components",
           "fleet_cuda_parity_cases", "fleet_cuda_oracle",
           "fleet_cuda_session", "fleet_session", "fleet_unit_system",
           "fleet_calibrated_tool", "default_measurement_path"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..", ".."))

# measured-kernel geometry (the JAX package's): small enough that every
# knob point is a short launch, large enough that every knob point
# changes the grid
FLASH_S = 128          # Sq == Skv tokens per attention launch
FLASH_D = 64           # head dim
FLASH_HEADS = 2        # query heads (GQA 2:1 onto one KV head)
SSD_S = 256            # scan length per launch
SSD_P = 64             # SSD head dim
SSD_N = 64             # SSD state dim
SSD_MAX_HEADS = 8      # the ports axis: parallel head lanes

# analytical stage models: the attention stage prices as a gemma2-9b
# fleet share, the SSD stage as a mamba2-780m share, both on the
# train_4k shape cell
_FLEET_STAGES = {
    "flash_attention": ("gemma2-9b", 0),
    "ssd_scan": ("mamba2-780m", 0),
}


_RECORD_HINT = ("record on the card: build_session('fleet', 'cuda', "
                "mode='record')")


def default_measurement_path(tile: int = 0) -> str:
    """The fleet kernels' recording on the card (no tile axis: the
    kernel geometry is fixed, so everything keys under tile 0 and
    ``tile`` is accepted for the registry's path protocol only)."""
    return os.path.join(_REPO_ROOT, "artifacts", "measurements",
                        "fleet_cuda.json")


# ----------------------------------------------------------------------
# system model + knob spaces
# ----------------------------------------------------------------------
def fleet_tmg(frames_in_flight: int = 2) -> TMG:
    """Single-buffer two-stage pipeline: adjacent stages serialize."""
    return pipeline_tmg(["flash_attention", "ssd_scan"], buffers=1,
                        frames_in_flight=frames_in_flight)


def fleet_knob_spaces() -> Dict[str, KnobSpace]:
    """One knob space for both stages, honest for both backends: ports
    up to 4 (fleet shares / parallel grid lanes), unrolls up to 8
    (microbatch ladder / sequential block depth)."""
    return {n: KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8)
            for n in _FLEET_STAGES}


def fleet_xla_tool(**kwargs) -> XLATool:
    """The analytical fleet oracle (roofline prices, device-memory byte
    areas) on the chip table; keywords (``chip``, ``hbm_budget``, ``tp``)
    flow to :class:`XLATool`."""
    return XLATool({name: (get_config(cfg), SHAPES[shape])
                    for name, (cfg, shape) in _FLEET_STAGES.items()},
                   **kwargs)


# ----------------------------------------------------------------------
# cost models (the JAX package's, byte for byte)
# ----------------------------------------------------------------------
def _flash_block_kv(unrolls: int) -> int:
    return 16 * unrolls


def flash_vmem_bytes(H: int, W: int, *, ports: int, unrolls: int,
                     dtype_bytes: int = 4) -> int:
    """Per-grid-step VMEM: q/o/acc tiles of (Sq/ports, d), k/v tiles of
    (16*unrolls, d), plus the (m, l) softmax state rows."""
    bq = W // ports
    bkv = _flash_block_kv(unrolls)
    return dtype_bytes * (3 * bq * FLASH_D + 2 * bkv * FLASH_D + 2 * bq)


def flash_grid_steps(H: int, W: int, *, ports: int, unrolls: int) -> int:
    return FLASH_HEADS * ports * max(1, H // _flash_block_kv(unrolls))


def _ssd_chunk(unrolls: int) -> int:
    return 8 * unrolls


def ssd_vmem_bytes(H: int, W: int, *, ports: int, unrolls: int,
                   dtype_bytes: int = 4) -> int:
    """Per-head-lane VMEM per chunk step: x/y tiles (chunk, P), B/C
    tiles (chunk, N), the dt row, and the carried (P, N) state."""
    chunk = _ssd_chunk(unrolls)
    return dtype_bytes * (2 * chunk * SSD_P + 2 * chunk * SSD_N + chunk
                          + 2 * SSD_P * SSD_N)


def ssd_grid_steps(H: int, W: int, *, ports: int, unrolls: int) -> int:
    return ports * max(1, H // _ssd_chunk(unrolls))


# ----------------------------------------------------------------------
# measured kernel specs
# ----------------------------------------------------------------------
def _draw_inputs(rng: np.random.Generator, s_flash: int, s_ssd: int):
    """q, k, v at ``s_flash`` tokens and x, dt, A, B, C at ``s_ssd``, in
    the JAX package's distributions (dt softplus of a normal,
    A = -exp(0.3 normal), B and C scaled by 0.3), float32."""
    f32 = np.float32
    q = rng.standard_normal((1, s_flash, FLASH_HEADS, FLASH_D))
    k = rng.standard_normal((1, s_flash, 1, FLASH_D))
    v = rng.standard_normal((1, s_flash, 1, FLASH_D))
    S = s_ssd
    x = rng.standard_normal((1, S, SSD_MAX_HEADS, SSD_P))
    dt = np.logaddexp(0.0, rng.standard_normal((1, S, SSD_MAX_HEADS)))
    A = -np.exp(rng.standard_normal((SSD_MAX_HEADS,)) * 0.3)
    Bm = rng.standard_normal((1, S, SSD_N)) * 0.3
    Cm = rng.standard_normal((1, S, SSD_N)) * 0.3
    return tuple(a.astype(f32) for a in (q, k, v, x, dt, A, Bm, Cm))


def fleet_cuda_components(tile: int = 0, device=None
                          ) -> Dict[str, CudaKernelSpec]:
    """The two fleet stages as measured kernel specs, with inputs baked
    from ``numpy.random.default_rng(7)`` on ``device`` (default: the
    CUDA card), at the fixed fleet geometry (``tile`` is accepted for
    the components-factory protocol only).  The SSD runner of a knob
    point holds a contiguous copy of its ``ports`` head lanes, made when
    the point is built, so the timed call is the kernel alone."""
    dev = resolve_device(device)
    q, k, v, x, dt, A, Bm, Cm = from_numpy(
        _draw_inputs(np.random.default_rng(7), FLASH_S, SSD_S), dev)

    def build_flash(ports: int, unrolls: int):
        def run():
            return mha(q, k, v, causal=True, block_q=FLASH_S // ports,
                       block_kv=_flash_block_kv(unrolls))
        return run

    def build_ssd(ports: int, unrolls: int):
        xs = x[:, :, :ports, :].contiguous()
        dts = dt[:, :, :ports].contiguous()
        As = A[:ports].contiguous()

        def run():
            return ssd(xs, dts, As, Bm, Cm, chunk=_ssd_chunk(unrolls))
        return run

    return {
        "flash_attention": CudaKernelSpec(
            name="flash_attention", shape=(FLASH_S, FLASH_S),
            build=build_flash, vmem_bytes=flash_vmem_bytes,
            grid_steps=flash_grid_steps, n_in=3, n_out=1),
        "ssd_scan": CudaKernelSpec(
            name="ssd_scan", shape=(SSD_S, SSD_MAX_HEADS),
            build=build_ssd, vmem_bytes=ssd_vmem_bytes,
            grid_steps=ssd_grid_steps, n_in=4, n_out=2),
    }


def fleet_cuda_parity_cases(tile: int = FLASH_S, device=None):
    """(name, op, plain_fn, args) per fleet kernel, on ``device``
    (default: the CUDA card): each op at a knob point is held against its
    plain version.  ``tile`` is the token count (at least 32); inputs
    come from ``numpy.random.default_rng(11)``.  The flash op is causal
    with ``q_offset`` 0, so every row sees its diagonal (no row is
    masked everywhere, where the plain version gives NaN)."""
    S = max(32, tile)
    dev = resolve_device(device)
    q, k, v, x, dt, A, Bm, Cm = from_numpy(
        _draw_inputs(np.random.default_rng(11), S, S), dev)

    def mha_knobbed(q, k, v, *, ports, unrolls):
        return mha(q, k, v, causal=True, block_q=max(1, S // ports),
                   block_kv=_flash_block_kv(unrolls))

    def mha_oracle(q, k, v):
        return mha_ref(q, k, v, causal=True)

    def ssd_knobbed(x, dt, A, Bm, Cm, *, ports, unrolls):
        # the output must not depend on the knobs: ports only replicates
        # head lanes in the measured spec, so the check runs all heads
        # and lets unrolls (the chunk length) exercise the kernel
        return ssd(x, dt, A, Bm, Cm, chunk=_ssd_chunk(unrolls))

    return [
        ("flash_attention", mha_knobbed, mha_oracle, (q, k, v)),
        ("ssd_scan", ssd_knobbed, ssd_oracle, (x, dt, A, Bm, Cm)),
    ]


# ----------------------------------------------------------------------
# oracles + sessions
# ----------------------------------------------------------------------
def fleet_cuda_oracle(mode: str = "measure", *, device=None,
                      measurements: Optional[MeasurementSet] = None,
                      store_path: Optional[str] = None,
                      device_kind: Optional[str] = None,
                      flush_every: int = 16, **kwargs) -> CudaOracle:
    """The measured fleet oracle: both kernels timed on ``device``
    (default: the CUDA card).  ``"record"`` and ``"replay"`` go through
    ``measurements`` or the recording at ``store_path`` (default:
    :func:`default_measurement_path`).  Both stages have a kernel, so
    no fallback tool is attached.  Remaining keywords flow to :class:`CudaOracle` (``timer``,
    ``smem_budget``)."""
    components = fleet_cuda_components(device=device)
    if device_kind is None:
        device_kind = device_kind_of(device)
    if measurements is None and mode in ("record", "replay"):
        measurements = open_recording(
            store_path or default_measurement_path(), mode=mode, tile=0,
            device_kind=device_kind, flush_every=flush_every)
    return CudaOracle(components, mode=mode, measurements=measurements,
                      device=device, device_kind=device_kind,
                      record_hint=_RECORD_HINT, **kwargs)


def fleet_cuda_session(delta: float = 0.3, *, mode: str = "measure",
                       workers: int = 1, device=None,
                       oracle: Optional[CudaOracle] = None,
                       **kwargs) -> ExplorationSession:
    """An :class:`ExplorationSession` over the fleet TMG driven by the
    measured backend — ``build_session("fleet", "cuda")`` with the fleet
    app's defaults (knob spaces, ``delta`` 0.3, nothing fixed).
    Remaining keywords flow to :func:`fleet_cuda_oracle` unless a
    pre-built ``oracle`` is given."""
    tool = oracle or fleet_cuda_oracle(mode, device=device, **kwargs)
    return build_session("fleet", "cuda", tool=tool, delta=delta,
                         workers=workers)


def fleet_unit_system(store: Optional[MeasurementStore] = None,
                      **kwargs) -> UnitSystem:
    """Exchange rates fitted from the fleet recording (default: the one
    at :func:`default_measurement_path`): per-stage latency scales
    (measured wall / roofline model) and one global device-memory-bytes
    -> shared-memory-bytes area rate — the :mod:`repro_torch.core.calibrate`
    fit applied to the XLA tool (keywords flow to
    :func:`fleet_xla_tool`).  The fit reads the kernel specs' shapes and
    footprint models only and never runs them, so their inputs are built
    on the CPU."""
    if store is None:       # an empty store is a store: fit from it
        store = MeasurementStore.load(default_measurement_path())
    return fit_unit_system(store, fleet_cuda_components(device="cpu"),
                           fleet_xla_tool(**kwargs))


def fleet_calibrated_tool(store: Optional[MeasurementStore] = None,
                          **kwargs):
    """The calibrated-measured analytical fallback: the XLA roofline
    re-scaled onto the measured latency axis and shared-memory-byte cost
    unit (keywords flow to :func:`fleet_xla_tool`)."""
    return fleet_unit_system(store, **kwargs).calibrated(
        fleet_xla_tool(**kwargs))


def fleet_session(delta: float = 0.3, *, backend: str = "analytical",
                  workers: int = 1, share_plm: bool = False,
                  **kwargs) -> ExplorationSession:
    """``build_session("fleet", backend)`` with the fleet defaults, on
    ``backend`` ``"analytical"`` (the :class:`XLATool` on the chip table;
    keywords flow to :func:`fleet_xla_tool`) or ``"cuda"`` (the kernels
    on the card; keywords flow to :func:`build_session`: ``mode``,
    ``device``, ``verify_plans``, ...)."""
    if backend == "cuda":
        return build_session("fleet", "cuda", delta=delta, workers=workers,
                             share_plm=share_plm, **kwargs)
    if backend != "analytical":
        raise ValueError(f"unknown fleet backend {backend!r}; available: "
                         f"'analytical', 'cuda'")
    return build_session("fleet", "analytical",
                         tool=fleet_xla_tool(**kwargs), delta=delta,
                         workers=workers, share_plm=share_plm)


# ----------------------------------------------------------------------
# registration: `get_app("fleet")` of repro_torch.core.registry resolves
# to this record
# ----------------------------------------------------------------------
register_app(App(
    name="fleet",
    description="hybrid attention + SSD serving pipeline: flash_attention "
                "-> ssd_scan, priced as fleet shares (roofline on the "
                "chip table) or measured CUDA kernels",
    tmg=fleet_tmg,
    knob_spaces=lambda **_kw: fleet_knob_spaces(),
    analytical=fleet_xla_tool,
    fixed={},
    delta=0.3,
    kernel_specs=fleet_cuda_components,
    native_tile=0,
    measurement_path=default_measurement_path,
    recorded_tiles=(0,),
    default_tiles=(0,),
    calibrated_fallback=fleet_calibrated_tool,
    record_hint=_RECORD_HINT,
    plm_planner=lambda: PLMPlanner(fleet_tmg()),
    parity_cases=fleet_cuda_parity_cases,
))
