"""The App/Backend registry: one entry point for every workload x oracle.

COSMOS is compositional — the same characterize -> plan -> map
methodology applies to *any* accelerator — so instead of a hand-wired
session constructor per app and backend, two small declarative records:

  * an :class:`App` bundles everything an
    :class:`~repro_torch.core.session.ExplorationSession` needs about a
    workload: the TMG factory, the per-component knob spaces, fixed
    (software) latencies, the analytical tool, and — when the app has
    measured kernels — the ``CudaKernelSpec`` factory, its recordings on
    disk, the unit-calibrated fallback, and the PLM planner;
  * a :class:`Backend` bundles an oracle factory plus capability
    metadata: measured vs analytical, which recorded tiles it can
    replay for an app, and the calibration hook that puts an analytical
    model onto the measured axes.

``get_app("wami")`` / ``get_backend("cuda")`` resolve by name (apps
self-register on first use via their package import), and
:func:`build_session` is the single session constructor:

    session = build_session("wami", "cuda", share_plm=True)
    result = session.run()

Two backends are registered: ``analytical`` (the app's closed-form
model) and ``cuda`` (its kernels timed on the card through
:class:`~repro_torch.core.cuda_oracle.CudaOracle`: ``mode="measure"``
by default, ``"record"`` or ``"replay"`` through the app's recordings).
This registry is the package's own: apps register here, never anywhere
else.
"""

from __future__ import annotations

import functools
import importlib
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .cuda_oracle import (CudaKernelSpec, CudaOracle, MeasurementSet,
                          MeasurementStore, MissingMeasurementError,
                          device_kind_of, open_store, record_meta,
                          recorded_provenance)
from .knobs import KnobSpace
from .session import DSEQuery, ExplorationSession
from .tmg import TMG

__all__ = [
    "App",
    "Backend",
    "register_app",
    "register_backend",
    "get_app",
    "get_backend",
    "list_apps",
    "list_backends",
    "build_tool",
    "build_session",
    "build_query_session",
]

# build_session keywords that configure the measured backend's oracle
# (everything else flows to ExplorationSession)
_TOOL_OPTIONS = ("mode", "missing", "device", "device_kind", "smem_budget",
                 "timer")


@dataclass(frozen=True)
class App:
    """One registered workload: everything a session needs, bundled.

    ``tmg``/``knob_spaces``/``analytical`` are zero-config factories
    (``knob_spaces`` must accept a ``tile_sizes=`` keyword when
    ``plm_tile_sizes`` is non-empty).  ``fixed`` maps software
    transitions to their fixed effective latency.  The measured-backend
    fields are optional: an app without ``kernel_specs`` does not support
    the measured backend (``Backend.supports`` reports it).
    ``kernel_specs(tile, device)`` builds the kernel specs at a tile
    with their inputs on ``device``.

    ``recorded_tiles`` lists every tile the app records at;
    ``default_tiles`` is the subset sessions load unless the caller opts
    into more (``build_session(tiles=...)``).

    ``parity_cases(tile, device=)`` lists ``(name, op, plain_fn, args)``
    per kernel with its inputs on ``device`` (default: the CUDA card):
    ``op(*args, ports=, unrolls=)`` is held against ``plain_fn(*args)``.
    The card's parity check runs them; the lint checks their structure
    with ``device="cpu"``.
    """

    name: str
    description: str
    tmg: Callable[[], TMG]
    knob_spaces: Callable[..., Dict[str, KnobSpace]]
    analytical: Callable[[], Any]
    fixed: Dict[str, float] = field(default_factory=dict)
    delta: float = 0.25
    # measured-backend surface (optional)
    kernel_specs: Optional[Callable[..., Dict[str, CudaKernelSpec]]] = None
    native_tile: int = 0
    measurement_path: Optional[Callable[[int], str]] = None
    recorded_tiles: Tuple[int, ...] = ()
    default_tiles: Tuple[int, ...] = ()
    # called as calibrated_fallback(store=<native recording>) when the
    # caller already holds the loaded store, or with no arguments
    calibrated_fallback: Optional[Callable[..., Any]] = None
    record_hint: Optional[str] = None          # app's re-record command
    # memory-co-design surface (optional)
    plm_planner: Optional[Callable[[], Any]] = None
    plm_tile_sizes: Tuple[int, ...] = ()            # analytical tile axis
    plm_tile_sizes_measured: Tuple[int, ...] = ()   # measured-drive axis
    # kernel parity cases: (tile, device=) -> [(name, op, plain_fn, args)]
    parity_cases: Optional[Callable[..., List]] = None

    def available_tiles(self) -> Tuple[int, ...]:
        """The recorded tiles whose store files exist on disk."""
        if self.measurement_path is None:
            return ()
        return tuple(t for t in self.recorded_tiles
                     if os.path.exists(self.measurement_path(t)))

    def recording_keys(self) -> List[Tuple[int, str, str, int]]:
        """Every recording on disk, as ``(tile, device_kind, file,
        points)`` — the ``(tile, device_kind)`` pairs are the
        :class:`MeasurementSet` routing keys the measured backend can
        replay; ``file`` is the store's basename under
        ``artifacts/measurements/``."""
        out: List[Tuple[int, str, str, int]] = []
        if self.measurement_path is None:
            return out
        for t in self.recorded_tiles:
            path = self.measurement_path(t)
            if not os.path.exists(path):
                continue
            store = MeasurementStore.load(path)
            out.append((store.tile or t, store.device_kind,
                        os.path.basename(path), len(store.entries)))
        return out

    def describe(self) -> Dict[str, Any]:
        """The app as a plain dict — what doc generation
        (``python -m repro_torch.bench.run --emit-docs``) reads.
        Deterministic: sorted keys, recording basenames only."""
        return {
            "name": self.name,
            "description": self.description,
            "components": sorted(t.name for t in self.tmg().transitions),
            "fixed": sorted(self.fixed),
            "delta": self.delta,
            "measured": self.kernel_specs is not None,
            "native_tile": self.native_tile,
            "recorded_tiles": list(self.recorded_tiles),
            "available_tiles": list(self.available_tiles()),
            "recordings": [
                {"tile": t, "device_kind": kind, "file": name, "points": n}
                for t, kind, name, n in self.recording_keys()],
            "plm_planner": self.plm_planner is not None,
            "plm_tile_sizes": list(self.plm_tile_sizes),
            "plm_tile_sizes_measured": list(self.plm_tile_sizes_measured),
            "parity_cases": self.parity_cases is not None,
            "record_hint": self.record_hint,
        }

    def measurement_set(self, tiles: Optional[Sequence[int]] = None, *,
                        mode: str = "replay",
                        device_kind: Optional[str] = "",
                        meta: Optional[Dict[str, Any]] = None
                        ) -> MeasurementSet:
        """The app's recordings for ``tiles`` (default: the app's
        ``default_tiles``) as one routing set (:func:`open_store`):
        replay loads every file (a missing one raises); record and
        measure mode start a fresh store, tagged with its tile,
        ``device_kind`` and ``meta``, where a file is missing."""
        if self.measurement_path is None:
            raise ValueError(f"app {self.name!r} has no recordings")
        out = MeasurementSet()
        for t in (tiles if tiles is not None else self.default_tiles):
            out.add(open_store(self.measurement_path(t), mode=mode, tile=t,
                               device_kind=device_kind, meta=meta))
        return out


@dataclass(frozen=True)
class Backend:
    """One registered oracle family: factory + capability metadata.

    ``make_tool(app, share_plm=..., tiles=..., **options)`` returns the
    synthesis tool a session drives for ``app``.  ``measured`` says
    whether prices come from executing kernels (measure/record/replay)
    or from a closed-form model; ``supports``/``supported_tiles`` are
    the capability questions a caller asks before wiring a drive, and
    ``calibrate`` is the hook that returns the app's analytical model
    re-scaled onto this backend's measured axes (None when the backend
    is itself analytical, or the app has no recording to fit against).
    """

    name: str
    description: str
    measured: bool
    make_tool: Callable[..., Any]
    supports: Callable[[App], bool] = lambda app: True
    supported_tiles: Callable[[App], Tuple[int, ...]] = lambda app: ()
    calibrate: Optional[Callable[[App], Any]] = None
    # why an unsupported app is unsupported, in the app's terms
    explain: Optional[Callable[[App], Optional[str]]] = None

    def skip_reason(self, app: App) -> Optional[str]:
        """``None`` when this backend can drive ``app``; otherwise a
        non-empty human-readable reason."""
        if self.supports(app):
            return None
        if self.explain is not None:
            reason = self.explain(app)
            if reason:
                return reason
        return (f"backend {self.name!r} does not support app "
                f"{app.name!r}")


# ----------------------------------------------------------------------
# the registries
# ----------------------------------------------------------------------
_APPS: Dict[str, App] = {}
_BACKENDS: Dict[str, Backend] = {}

# built-in apps self-register when their package is imported; the lazy
# import (on first lookup) avoids a core -> apps import cycle
_BUILTIN_APP_MODULES: Dict[str, str] = {
    "wami": "repro_torch.apps.wami",
    "fleet": "repro_torch.apps.fleet",
}


def register_app(app: App) -> App:
    """Idempotent by name: re-registering the same name replaces the
    entry (module reloads would otherwise error)."""
    _APPS[app.name] = app
    return app


def register_backend(backend: Backend) -> Backend:
    _BACKENDS[backend.name] = backend
    return backend


def _ensure_builtin_apps(name: Optional[str] = None) -> None:
    wanted = ([name] if name in _BUILTIN_APP_MODULES
              else list(_BUILTIN_APP_MODULES))
    for key in wanted:
        if key not in _APPS:
            importlib.import_module(_BUILTIN_APP_MODULES[key])


def get_app(name: str) -> App:
    """Resolve a registered workload by name (importing built-ins on
    first use).  Unknown names list what IS registered."""
    if name not in _APPS:
        _ensure_builtin_apps(name)
    try:
        return _APPS[name]
    except KeyError:
        raise KeyError(f"unknown app {name!r}; registered apps: "
                       f"{sorted(_APPS) or '<none>'}") from None


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered backends: "
                       f"{sorted(_BACKENDS)}") from None


def list_apps() -> List[App]:
    _ensure_builtin_apps()
    return [_APPS[n] for n in sorted(_APPS)]


def list_backends() -> List[Backend]:
    return [_BACKENDS[n] for n in sorted(_BACKENDS)]


# ----------------------------------------------------------------------
# the built-in backends
# ----------------------------------------------------------------------
def _analytical_tool(app: App, **_opts: Any) -> Any:
    return app.analytical()


def _cuda_supports(app: App) -> bool:
    return app.kernel_specs is not None


def _cuda_explain(app: App) -> Optional[str]:
    if app.kernel_specs is None:
        return (f"app {app.name!r} registers no CUDA kernel specs "
                f"(no measured surface)")
    return None


class _UnfittedFallback:
    """Stands in for the calibrated fallback while the native tile has no
    recording to fit it from (a fresh record or measure campaign).  A
    drive that never prices through the fallback — every component has a
    kernel and every tile a recording — runs; the first point that would
    be priced by it raises, naming how to record the native tile, rather
    than pricing in the model's own units beside measured bytes."""

    def __init__(self, app: App, device_kind: str):
        self.why = (f"app {app.name!r}: the calibrated fallback is fitted "
                    f"from the recording at the native tile "
                    f"{app.native_tile} on {device_kind!r}, and there is "
                    f"none yet; "
                    f"{app.record_hint or 'record that tile first'}")

    def synthesize(self, component: str, **_kw: Any) -> Any:
        raise MissingMeasurementError(f"{self.why} (pricing {component!r})")

    def cdfg_facts(self, component: str, _synth: Any) -> Any:
        raise MissingMeasurementError(f"{self.why} (facts of {component!r})")

    def plm_requirement(self, component: str, _synth: Any) -> Any:
        raise MissingMeasurementError(
            f"{self.why} (memory of {component!r})")


def _cuda_tool(app: App, *, share_plm: bool = False,
               tiles: Optional[Sequence[int]] = None,
               mode: str = "measure", missing: Optional[str] = None,
               device=None, device_kind: Optional[str] = None,
               **opts: Any) -> CudaOracle:
    """The measured oracle for ``app``: its kernels timed on ``device``
    (default: the CUDA card) through a :class:`MeasurementSet` of its
    recordings at ``tiles``, the analytical tool elsewhere.

    ``device_kind`` (default: the card's name; in a replay, the one the
    recordings are tagged with) keys the recordings: pass
    ``"interpret"`` to replay ones made in Pallas interpret mode.  A
    record-mode drive on the card tags a fresh recording with the card's
    provenance (:func:`~repro_torch.core.cuda_oracle.card_provenance`);
    a replay prices under the budget the recordings carry.
    Plain drives keep the strict ``missing="error"`` semantics over the
    raw analytical tool; ``share_plm`` drives use the unit-calibrated
    fallback, fitted from the native tile's recording of this device
    kind, with ``missing="fallback"``, so the tile axis (and any mapped
    point outside the recorded walk) prices deterministically.  The fit
    reads the native recording as it stands when the tool is built (a
    replay refits from it as it then stands), so record the native
    tile's walk first; without a non-empty native recording there is
    nothing to fit, and any pricing through the fallback raises
    (:class:`_UnfittedFallback`).
    Remaining keywords (``smem_budget``, ``timer``) flow to
    :class:`CudaOracle`.
    """
    if app.kernel_specs is None:
        supported = [a.name for a in list_apps() if _cuda_supports(a)]
        raise ValueError(f"app {app.name!r} has no CUDA kernel specs; "
                         f"the measured backend is unsupported "
                         f"(supported apps: {supported})")
    if device_kind is None and mode != "replay":
        device_kind = device_kind_of(device)
    measurements = app.measurement_set(tiles, mode=mode,
                                       device_kind=device_kind,
                                       meta=record_meta(mode, device))
    if device_kind is None:
        device_kind = recorded_provenance(measurements)[0]
    if share_plm or missing == "fallback":
        missing = "fallback"
        if app.calibrated_fallback is not None:
            # hand the hook the already-loaded native recording so the
            # unit fit does not re-read the JSON from disk
            native = measurements.get(app.native_tile, device_kind)
            if native is None and app.native_tile in app.available_tiles():
                native = MeasurementStore.load(
                    app.measurement_path(app.native_tile))
            fallback = (app.calibrated_fallback(store=native)
                        if native is not None and len(native)
                        else _UnfittedFallback(app, device_kind))
        else:
            fallback = app.analytical()
    else:
        fallback = app.analytical()
        missing = missing or "error"
    specs = functools.partial(app.kernel_specs, device=device)
    return CudaOracle(
        specs(app.native_tile), mode=mode, measurements=measurements,
        components_factory=specs, fallback=fallback, device=device,
        device_kind=device_kind, native_tile=app.native_tile,
        missing=missing, record_hint=app.record_hint, **opts)


def _cuda_calibrate(app: App) -> Any:
    """The app's calibrated fallback, fitted from its native tile's
    recording on disk (None without a hook or without that recording)."""
    if (app.calibrated_fallback is None
            or app.native_tile not in app.available_tiles()):
        return None
    return app.calibrated_fallback(store=MeasurementStore.load(
        app.measurement_path(app.native_tile)))


register_backend(Backend(
    name="analytical",
    description="closed-form models (HLS scheduler / roofline on the "
                "chip table); no recordings needed",
    measured=False,
    make_tool=_analytical_tool,
))

register_backend(Backend(
    name="cuda",
    description="hand-written CUDA kernels timed on the card (measure), "
                "or through MeasurementSet record/replay; components "
                "without a kernel are priced analytically",
    measured=True,
    make_tool=_cuda_tool,
    supports=_cuda_supports,
    supported_tiles=lambda app: app.available_tiles(),
    calibrate=_cuda_calibrate,
    explain=_cuda_explain,
))


# ----------------------------------------------------------------------
# the one session constructor
# ----------------------------------------------------------------------
def build_tool(app: App | str, backend: Backend | str = "analytical",
               **opts: Any) -> Any:
    """The oracle for (app, backend) without a session around it."""
    app = get_app(app) if isinstance(app, str) else app
    backend = get_backend(backend) if isinstance(backend, str) else backend
    return backend.make_tool(app, **opts)


def build_session(app: App | str, backend: Backend | str = "analytical",
                  *, delta: Optional[float] = None, workers: int = 1,
                  share_plm: bool = False,
                  tile_sizes: Optional[Sequence[int]] = None,
                  tiles: Optional[Sequence[int]] = None,
                  tool: Any = None,
                  verify_plans: bool = False,
                  batch_pricing: bool = False,
                  guided: bool = False,
                  **kwargs: Any) -> ExplorationSession:
    """Build the :class:`ExplorationSession` for any registered
    workload x oracle pair.

    ``share_plm`` attaches the app's PLM planner and opens its tile
    axis (``tile_sizes`` overrides the app's per-backend default);
    ``tiles`` selects which recordings the measured backend loads
    (default: the app's ``default_tiles``); ``tool`` injects a
    pre-built oracle (skipping the backend factory).  The measured
    backend's options — ``mode``, ``missing``, ``device``,
    ``device_kind``, ``smem_budget``, ``timer`` — flow to its factory.
    ``verify_plans=True`` turns on the strict map-phase post-pass:
    every memory plan the planner emits is independently
    re-proved race-free, capacity-feasible, and dominance-guarded by
    :mod:`repro_torch.core.analysis.verify` before the session accepts
    it (only meaningful together with ``share_plm``).

    ``batch_pricing=True`` wraps an analytical tool in a
    :class:`~repro_torch.core.pricing.BatchPricer` so every oracle
    request is a whole-grid lookup (bit-exact; non-analytical tools pass
    through unchanged).  ``guided=True`` additionally runs
    surrogate-guided characterization (:mod:`repro_torch.core.surrogate`):
    the Algorithm-1 walk prices from the grid and only the surrogate's
    top corner per component is confirmed through the real oracle —
    analytical backends only; raises ``ValueError`` for backends without
    a grid program (the measured ``cuda`` backend among them).
    Remaining keywords flow to :class:`ExplorationSession`.
    """
    from .pricing import BatchPricer     # lazy: pricing imports backends
    app = get_app(app) if isinstance(app, str) else app
    backend = get_backend(backend) if isinstance(backend, str) else backend
    tool_opts = {k: kwargs.pop(k) for k in _TOOL_OPTIONS if k in kwargs}
    if tool is None and kwargs.get("ledger") is None:
        # a pre-built ledger already wraps its own tool; building one
        # here would be dead weight (and, for the measured backend, I/O)
        tool = backend.make_tool(app, share_plm=share_plm, tiles=tiles,
                                 **tool_opts)
    elif tool_opts:
        raise ValueError(f"{sorted(tool_opts)} configure the backend's "
                         f"tool; they cannot apply to a pre-built tool "
                         f"or ledger")
    if guided:
        target = tool if tool is not None else kwargs["ledger"].tool
        pricer = BatchPricer.wrap(target)
        if not isinstance(pricer, BatchPricer):
            raise ValueError(
                f"guided characterization needs an analytical pricing "
                f"grid; backend {backend.name!r} tool "
                f"{type(target).__name__} has none (batch_pricing/guided "
                f"support HLSTool and XLATool)")
        kwargs.setdefault("pricer", pricer)
        if tool is not None:
            tool = pricer               # share one grid set end to end
    elif batch_pricing and tool is not None:
        tool = BatchPricer.wrap(tool)
    if share_plm:
        if app.plm_planner is not None:
            kwargs.setdefault("memory_planner", app.plm_planner())
        if tile_sizes is None:
            tile_sizes = (app.plm_tile_sizes_measured if backend.measured
                          else app.plm_tile_sizes)
    spaces = (app.knob_spaces(tile_sizes=tuple(tile_sizes))
              if tile_sizes else app.knob_spaces())
    return ExplorationSession(app.tmg(), tool, spaces,
                              delta=app.delta if delta is None else delta,
                              fixed=dict(app.fixed), workers=workers,
                              verify_plans=verify_plans,
                              **kwargs)


def build_query_session(query: DSEQuery, *, workers: Optional[int] = None,
                        **kwargs: Any) -> ExplorationSession:
    """Resolve a :class:`~repro_torch.core.session.DSEQuery` into a
    session — the service's per-tenant resolution point.

    Unknown app/backend names raise the registry's listing errors
    *synchronously* (the service validates at submit time, before a
    query ever occupies a queue slot).  ``workers`` overrides the query's own fan-out;
    remaining keywords (``tool``, ``ledger``, ``verify_plans``, the
    measured backend's options, ...) flow to :func:`build_session`.
    """
    return build_session(
        query.app, query.backend, delta=query.delta,
        workers=query.workers if workers is None else workers,
        share_plm=query.share_plm, tile_sizes=query.tile_sizes,
        tiles=query.tiles, **kwargs)
