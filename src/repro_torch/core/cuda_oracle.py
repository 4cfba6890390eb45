"""CudaOracle: a *measured* execution backend for the COSMOS loop.

Each (component, knob) point is priced by running the component's
knob-parameterized CUDA kernel on the card and timing it:

  * latency lambda — measured device time per kernel launch, divided by
    ``ports``: the grid columns are parallel column banks, so the
    per-bank effective latency is what the TMG composes;
  * area alpha — the on-chip footprint model: the double-buffered block
    bytes (``2 * step``) summed over the ``ports`` banks, plus a fixed
    per-bank overhead (the shadow of Mnemosyne's bank-controller area);
  * the lambda-constraint — a knob point is infeasible when the grid
    does not divide (W % ports, H % unrolls) or the double-buffered
    block no longer fits the per-block shared-memory budget, and, like
    every backend, when ``max_states`` caps the Eq. (1) state estimate.
    The budget and the area share one footprint model: the block bytes
    of the stage as the JAX package's kernels stream them, so fronts on
    the same walls match it exactly.

Measurements are memoized per (component, ports, unrolls, tile) — one
physical point is timed exactly once per process, so a batched drive
prices identically to a sequential one — and flow through a
:class:`MeasurementSet` for record/replay: a keyed map
``(tile, device_kind) -> MeasurementStore`` the oracle routes every
request through.  Tiles with a recording replay their measured walls;
unrecorded tiles fall through to the analytical ``fallback`` (or raise,
under ``missing="error"``), so a tile knob axis stays deterministic even
when only some tiles are measured.  ``mode="record"`` times and
persists, ``mode="replay"`` is fully deterministic and needs no card.
Components without a kernel fall back to a wrapped analytical tool, so
a mixed system (the full WAMI TMG) still explores end-to-end.

A reading is the device time of ``CudaOracle.LAUNCHES_PER_READING``
(20) back-to-back launches between two CUDA events, divided by that
count, after one warm-up launch, with the host's issue time kept out
(:func:`device_time_s`); the oracle keeps the best of
``CudaOracle.REPS`` (3) readings.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils import resolve_device
from .knobs import CDFGFacts, Synthesis, SynthesisTool
from .oracle import OracleBatchMixin, call_synthesize
from .plm.spec import PLMRequirement
from .plm.units import smem_area_bytes

__all__ = [
    "CudaKernelSpec",
    "MeasurementStore",
    "MeasurementSet",
    "MissingMeasurementError",
    "CudaOracle",
    "open_store",
    "open_recording",
    "card_provenance",
    "recorded_provenance",
    "record_meta",
    "device_smem_budget",
    "device_time_s",
    "H100_SMEM_OPTIN_BYTES",
]

# one physical measurement inside one store: (component, ports, unrolls).
# ``max_states`` is NOT part of the key — feasibility under a cap is
# decided from the deterministic state model, never re-measured.  The
# tile lives one level up: it selects WHICH store via the
# :class:`MeasurementSet` key (tile, device_kind).
MeasureKey = Tuple[str, int, int]

# a MeasurementSet routing key: (tile, device_kind); tile 0 = the
# component's native tile
SetKey = Tuple[int, str]


# an NVIDIA H100's opt-in shared memory per block, in bytes: 227 KiB
# (NVIDIA's Hopper tuning guide; cudaDevAttrMaxSharedMemoryPerBlockOptin
# reads 232,448 on an H100 80GB HBM3).  What ``device_smem_budget``
# reads on that card, for code that must not touch one: the static lint
# checks the kernel specs' footprints against it.
H100_SMEM_OPTIN_BYTES = 232448


def device_smem_budget(device=None) -> int:
    """The card's opt-in shared memory per block, in bytes (232,448 on an
    NVIDIA H100 80GB HBM3 at its 700 W limit): the feasibility budget of
    a double-buffered block."""
    props = torch.cuda.get_device_properties(resolve_device(device))
    return int(props.shared_memory_per_block_optin)


def device_kind_of(device=None) -> str:
    """The recording tag of real-card measurements: the device name."""
    return torch.cuda.get_device_name(resolve_device(device))


@functools.lru_cache(maxsize=None)
def _nvidia_smi_line(index: int) -> str:
    """``name, power.limit`` of the card at CUDA index ``index``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints it (the index mapped through ``CUDA_VISIBLE_DEVICES``)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
    if index < len(visible) and visible[index].strip().isdigit():
        index = int(visible[index])
    return lines[index].strip()


def card_provenance(device=None) -> Dict[str, Any]:
    """What a recording made on ``device`` (default: the CUDA card)
    carries in its ``meta``: the card's name (the recording's device
    kind), its power limit as ``nvidia-smi`` prints it, the opt-in shared
    memory per block (the feasibility budget the walls were recorded
    under), and the torch and CUDA versions.  Raises for a device that
    is not a CUDA card: a recording's walls come from one."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"a recording's walls are timed on a CUDA card; "
                         f"{str(dev)!r} is not one")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return {"device_kind": device_kind_of(dev),
            "power_limit": _nvidia_smi_line(index).rsplit(",", 1)[-1]
            .strip(),
            "smem_budget_bytes": device_smem_budget(dev),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda}


# one measurement lock per device, shared by every CudaOracle of the
# process: the oracles' timings all queue on the device's legacy default
# stream, so two oracles timing at once (a service's pools, each with its
# own dispatcher thread) would each read the other's kernels inside their
# events
_DEVICE_LOCKS: Dict[str, threading.Lock] = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(device) -> threading.Lock:
    """The measurement lock of ``device`` (``None`` is the CUDA card)."""
    key = str(torch.device("cuda" if device is None else device))
    if key == "cuda":
        key = f"cuda:{torch.cuda.current_device()}"
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(key, threading.Lock())


# the longest spin device_time_s queues ahead of a reading (about a
# second at the 1.98 GHz maximum SM clock of an H100 SXM, 700 W limit)
_MAX_SPIN_CYCLES = 1 << 31


def device_time_s(runner: Callable[[], Any], *, launches: int, reps: int,
                  device=None) -> float:
    """Device seconds per call of ``runner``: the best of ``reps``
    readings, each the time between two CUDA events around ``launches``
    back-to-back calls, after one warm-up call.

    Host time is kept out of the reading: a spin kernel
    (``torch.cuda._sleep``) is queued ahead of the start event, so every
    launch of the reading is enqueued before the first one runs.  The
    start event must still be pending when the last launch has been
    issued; otherwise the spin is doubled and the reading redone.  A
    reading can never be covered, and raises, when the runner waits for
    the device (a copy from host memory, a ``.item()``) or when
    ``launches`` calls queue more kernels than the device's queue of
    pending launches holds (about a thousand): keep readings short.
    """
    dev = resolve_device(device)
    with torch.cuda.device(dev):
        runner()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin, best, done = 1 << 20, float("inf"), 0
        while done < reps:
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(launches):
                runner()
            end.record()
            covered = not start.query()   # host finished before the spin
            end.synchronize()
            if covered:
                best = min(best, start.elapsed_time(end) * 1e-3 / launches)
                done += 1
            elif spin >= _MAX_SPIN_CYCLES:
                raise RuntimeError(
                    f"{launches} calls were not all queued behind a "
                    f"{spin}-cycle spin: the runner waits for the device, "
                    f"or queues more kernels than the launch queue holds")
            else:
                spin *= 2
    return best


@dataclass(frozen=True)
class CudaKernelSpec:
    """One knob-parameterized kernel, as the oracle sees it.

    ``build(ports, unrolls)`` returns a zero-argument runner (inputs
    baked in, deterministic) whose launch the oracle times.
    ``vmem_bytes``/``grid_steps`` are the kernel package's cost models
    (``(H, W, ports=, unrolls=) -> int``): the block bytes one grid cell
    works on, and the cells one core would walk.  ``n_in``/``n_out`` are
    the blocks the kernel streams per grid cell — the Eq. (1)
    gamma_r/gamma_w analogues used for the state estimate.
    """

    name: str
    shape: Tuple[int, int]                      # (H, W) the stage processes
    build: Callable[[int, int], Callable[[], Any]]
    vmem_bytes: Callable[..., int]
    grid_steps: Callable[..., int]
    n_in: int
    n_out: int

    def divisible(self, ports: int, unrolls: int) -> bool:
        H, W = self.shape
        return W % ports == 0 and H % unrolls == 0

    def facts(self) -> CDFGFacts:
        return CDFGFacts(gamma_r=self.n_in, gamma_w=self.n_out, eta=1,
                         trip=self.shape[0], has_plm_access=True)

    def states(self, ports: int, unrolls: int) -> int:
        return self.facts().h(unrolls, ports)


class MissingMeasurementError(KeyError):
    """Replay asked for a point the recording does not contain."""


class MeasurementStore:
    """A flat, deterministic JSON store of raw kernel timings.

    Maps (component, ports, unrolls) -> measured wall seconds per
    launch.  The derived quantities (per-bank lambda, on-chip area,
    feasibility) are recomputed by the oracle on replay, so a recording
    survives cost-model refinements.  ``save`` writes sorted keys —
    re-recording an identical machine state diffs clean.

    ``flush_every`` > 0 makes the store durable *incrementally*: every
    N-th ``put`` rewrites the file through an atomic write-then-rename
    step, so a killed recording campaign loses at most the last N-1
    timings and a restart (the record-mode oracle consults the store
    before timing) never re-pays for a flushed point.  0 (the default)
    writes the file only on an explicit ``save``/oracle ``flush``.
    """

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 flush_every: int = 0):
        self.path = path
        self.meta: Dict[str, Any] = dict(meta or {})
        self.entries: Dict[MeasureKey, float] = {}
        self.flush_every = max(0, int(flush_every))
        self._dirty = 0
        self._save_lock = threading.Lock()

    @classmethod
    def load(cls, path: str, *, flush_every: int = 0) -> "MeasurementStore":
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != 1:
            raise ValueError(f"unknown measurement-store version "
                             f"{doc.get('version')!r} in {path}")
        store = cls(path=path, meta=doc.get("meta", {}),
                    flush_every=flush_every)
        for k, wall_s in doc["entries"].items():
            comp, p, u = k.rsplit(":", 2)
            store.entries[(comp, int(p[1:]), int(u[1:]))] = float(wall_s)
        return store

    @property
    def tile(self) -> int:
        """The tile this recording was made at (0 when untagged)."""
        return int(self.meta.get("tile", 0))

    @property
    def device_kind(self) -> str:
        """Where the walls came from: the device name the recording tags
        (``"interpret"`` for untagged recordings made in Pallas
        interpret mode on a CPU)."""
        kind = self.meta.get("device_kind")
        if kind:
            return str(kind)
        return "interpret" if self.meta.get("interpret", True) else "device"

    @property
    def smem_budget(self) -> Optional[int]:
        """The shared-memory budget in bytes the walls were recorded
        under (``meta["smem_budget_bytes"]``; None when untagged, as the
        JAX package's interpret-mode recordings are)."""
        budget = self.meta.get("smem_budget_bytes")
        return None if budget is None else int(budget)

    @staticmethod
    def _key_str(key: MeasureKey) -> str:
        comp, ports, unrolls = key
        return f"{comp}:p{ports}:u{unrolls}"

    def get(self, key: MeasureKey) -> Optional[float]:
        return self.entries.get(key)

    def put(self, key: MeasureKey, wall_s: float) -> None:
        if self.flush_every:
            # the write happens under the save lock so a concurrent
            # autoflush never iterates a mutating dict
            with self._save_lock:
                self.entries[key] = float(wall_s)
                self._dirty += 1
                if self._dirty >= self.flush_every and self.path:
                    self._save_locked(self.path)
        else:
            self.entries[key] = float(wall_s)

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("MeasurementStore has no path")
        with self._save_lock:
            return self._save_locked(path)

    def _save_locked(self, path: str) -> str:
        doc = {"version": 1, "meta": self.meta,
               "entries": {self._key_str(k): self.entries[k]
                           for k in sorted(self.entries)}}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)     # atomic: a kill leaves old or new, never torn
        self.path = path
        self._dirty = 0
        return path

    def __len__(self) -> int:
        return len(self.entries)


class MeasurementSet:
    """Multi-recording routing table: (tile, device_kind) -> store.

    One oracle can hold one :class:`MeasurementStore` per measured tile
    (and per device kind — the same tile recorded on two kinds of device
    are different recordings).  The oracle resolves every request's tile
    to a set key; a hit replays/records through that store, a miss falls
    through to the analytical fallback.

    Stores keyed by tile 0 are "native tile" recordings; :meth:`from_store`
    additionally aliases a store under its ``meta`` tile so a drive that
    names the tile explicitly still hits the measured walls.
    """

    def __init__(self, stores: Optional[Dict[SetKey, MeasurementStore]] = None):
        self._stores: Dict[SetKey, MeasurementStore] = dict(stores or {})

    # -- construction --------------------------------------------------
    @classmethod
    def from_store(cls, store: MeasurementStore, *, tile: Optional[int] = None,
                   device_kind: Optional[str] = None) -> "MeasurementSet":
        """Wrap a single store.

        ``tile``/``device_kind`` default to the store's ``meta`` tags.
        When the caller declares no tile (0) but the recording tags one,
        the store is reachable under BOTH keys — tile-0 ("native")
        requests and requests naming the recorded tile resolve to the
        same measured walls.
        """
        kind = device_kind or store.device_kind
        keyed = tile if tile is not None else store.tile
        out = cls({(int(keyed), kind): store})
        meta_tile = store.tile
        if meta_tile and (int(keyed), kind) != (meta_tile, kind):
            out._stores.setdefault((meta_tile, kind), store)
        if keyed:
            # an explicitly-tiled store also answers "native" requests
            # when it is the only recording for its device kind
            out._stores.setdefault((0, kind), store)
        return out

    @classmethod
    def load(cls, paths: Iterable[str], *, flush_every: int = 0,
             device_kind: Optional[str] = None) -> "MeasurementSet":
        """Load several store files, keyed by their ``meta`` tags."""
        out = cls()
        for path in paths:
            store = MeasurementStore.load(path, flush_every=flush_every)
            out.add(store, device_kind=device_kind)
        return out

    def add(self, store: MeasurementStore, *, tile: Optional[int] = None,
            device_kind: Optional[str] = None) -> "MeasurementSet":
        key = (int(tile if tile is not None else store.tile),
               device_kind or store.device_kind)
        if key in self._stores:
            raise ValueError(f"MeasurementSet already holds a store for "
                             f"key (tile={key[0]}, device={key[1]!r})")
        self._stores[key] = store
        return self

    # -- lookup --------------------------------------------------------
    def get(self, tile: int, device_kind: str) -> Optional[MeasurementStore]:
        return self._stores.get((int(tile), device_kind))

    def keys(self) -> List[SetKey]:
        return sorted(self._stores)

    def tiles(self, device_kind: Optional[str] = None) -> Tuple[int, ...]:
        return tuple(sorted({t for t, k in self._stores
                             if device_kind is None or k == device_kind}))

    def stores(self) -> List[MeasurementStore]:
        """The distinct stores (aliases collapse), in key order."""
        seen: List[MeasurementStore] = []
        for key in self.keys():
            store = self._stores[key]
            if not any(store is s for s in seen):
                seen.append(store)
        return seen

    def save_all(self) -> List[str]:
        """Persist every store that has a path (record-mode flush)."""
        return [s.save() for s in self.stores() if s.path is not None]

    def describe(self) -> str:
        return ", ".join(f"(tile={t}, device={k!r})" for t, k in self.keys()) \
            or "<empty>"

    def __contains__(self, key: SetKey) -> bool:
        return (int(key[0]), key[1]) in self._stores

    def __len__(self) -> int:
        return len(self._stores)


def recorded_provenance(measurements: MeasurementSet,
                        device_kind: Optional[str] = None
                        ) -> Tuple[str, Optional[int]]:
    """(device kind, shared-memory budget or None) that a replay of
    ``measurements`` prices under: the one device kind its recordings
    are tagged with (or ``device_kind``), and the one budget the
    recordings of that kind were made under.  Reads the recordings'
    ``meta`` only, never the host's card; raises when the recordings
    disagree."""
    stores = measurements.stores()
    if device_kind is None:
        kinds = sorted({s.device_kind for s in stores})
        if len(kinds) != 1:
            raise ValueError(f"the recordings are tagged with device kinds "
                             f"{kinds}; pass device_kind=")
        device_kind = kinds[0]
    budgets = {s.smem_budget for s in stores if s.device_kind == device_kind}
    if len(budgets) > 1:
        raise ValueError(f"the {device_kind!r} recordings were made under "
                         f"shared-memory budgets {budgets}; pass "
                         f"smem_budget=")
    return device_kind, next(iter(budgets), None)


class CudaOracle(OracleBatchMixin):
    """The measured synthesis oracle (SynthesisTool/Oracle protocols).

    ``mode``:
      * ``"measure"`` — time every new point on the card (memoized);
      * ``"record"``  — measure, and persist every timing into the
        resolved tile's store;
      * ``"replay"``  — never execute; a point absent from the resolved
        store raises :class:`MissingMeasurementError`.

    ``measurements`` is a :class:`MeasurementSet` — the map
    ``(tile, device_kind) -> MeasurementStore`` every request routes
    through.  ``device_kind`` defaults to the card's name
    (``torch.cuda.get_device_name``); pass ``"interpret"`` to replay a
    recording made in Pallas interpret mode.  ``smem_budget`` is the
    feasibility budget in bytes; it defaults to the card's opt-in shared
    memory per block.  A replay takes both defaults from the recordings'
    ``meta`` instead (:func:`recorded_provenance`), never from the
    host's card, so it runs where there is none; a recording that
    carries no budget needs ``smem_budget=``.  ``device`` is the card
    the timings run on (default ``"cuda"``).

    ``fallback`` prices components that have no kernel (e.g. the 6x6
    matrix stages of WAMI) through an analytical tool, so a mixed TMG
    explores end-to-end.  ``timer(component, ports, unrolls, runner)
    -> seconds`` replaces the device-time measurement — tests inject a
    deterministic one to make a fresh drive byte-comparable.

    ``native_tile`` declares the tile the ``components`` kernel specs
    were built at; a request's tile resolves to it when unset (tile 0).
    A resolved tile with a recording in ``measurements`` replays (or
    records) measured walls; any other tile is routed to the fallback
    tool, which re-prices the component at that tile analytically (pair
    with a unit-calibrated fallback, :mod:`repro_torch.core.plm.units`,
    to keep the axes comparable).  ``components_factory(tile)`` — when
    given — rebuilds the kernel specs at a measured non-native tile, so
    multi-tile recordings price (and record) with the right geometry.

    ``missing`` picks the replay behaviour for a point absent from the
    resolved recording: ``"error"`` (default) raises
    :class:`MissingMeasurementError` naming the missing
    ``(tile, device_kind)`` key; ``"fallback"`` prices it through the
    fallback tool instead, which is what a drive whose walk *extends*
    the recorded one (the tile knob reshapes the LP and hence the mapped
    unroll choices) needs to stay deterministic.  ``record_hint`` is the
    app's re-record command, shown in a miss's error.
    """

    #: readings per point (the best is kept) and launches per reading
    REPS = 3
    LAUNCHES_PER_READING = 20

    def __init__(self, components: Dict[str, CudaKernelSpec], *,
                 mode: str = "measure",
                 measurements: Optional[MeasurementSet] = None,
                 components_factory: Optional[
                     Callable[[int], Dict[str, CudaKernelSpec]]] = None,
                 fallback: Optional[SynthesisTool] = None,
                 device=None,
                 device_kind: Optional[str] = None,
                 smem_budget: Optional[int] = None,
                 native_tile: int = 0,
                 missing: str = "error",
                 record_hint: Optional[str] = None,
                 timer: Optional[Callable[..., float]] = None):
        if mode not in ("measure", "record", "replay"):
            raise ValueError(f"unknown mode {mode!r}")
        if missing not in ("error", "fallback"):
            raise ValueError(f"unknown missing policy {missing!r}")
        if missing == "fallback" and fallback is None:
            raise ValueError("missing='fallback' requires a fallback tool")
        if mode in ("record", "replay") and (measurements is None
                                             or len(measurements) == 0):
            raise ValueError(f"mode={mode!r} requires a non-empty "
                             f"MeasurementSet")
        if mode == "replay" and (device_kind is None or smem_budget is None):
            # a replay prices under what its recordings say, not the host
            device_kind, recorded = recorded_provenance(measurements,
                                                        device_kind)
            if smem_budget is None:
                if recorded is None:
                    raise ValueError(
                        f"the {device_kind!r} recordings carry no "
                        f"shared-memory budget (meta 'smem_budget_bytes'); "
                        f"pass smem_budget=")
                smem_budget = recorded
        self.device = device
        self.device_kind = (device_kind if device_kind is not None
                            else device_kind_of(device))
        self.smem_budget = int(smem_budget if smem_budget is not None
                               else device_smem_budget(device))
        self.components = dict(components)
        self.mode = mode
        self.measurements = measurements or MeasurementSet()
        self.fallback = fallback
        self.native_tile = int(native_tile)
        self.missing = missing
        self.record_hint = record_hint
        self.timer = timer
        self._factory = components_factory
        # tiles whose requests resolve onto the native ``components``
        # specs: the declared native tile, the untagged 0, and whatever
        # tile the native store's meta carries
        self._native_tiles = {0, self.native_tile}
        native_store = self.store
        if native_store is not None and native_store.tile:
            self._native_tiles.add(native_store.tile)
        self._specs_cache: Dict[int, Dict[str, CudaKernelSpec]] = {}
        self._measured: Dict[Tuple[str, int, int, int], float] = {}
        self._lock = threading.Lock()
        # timing under a thread-pool fan-out measures contention, not the
        # kernel: _measure_lock, the device's one lock, serializes every
        # real measurement on the device, across every oracle of the
        # process, even when a ledger/session fans synthesize() out over
        # its own pool; replay never executes, takes no lock, and can
        # fan out freely
        self._measure_lock = (None if mode == "replay"
                              else _device_lock(device))
        self.batch_workers = 8 if mode == "replay" else 1

    # ------------------------------------------------------------------
    # routing: request tile -> (specs, store)
    # ------------------------------------------------------------------
    @property
    def store(self) -> Optional[MeasurementStore]:
        """The native-tile recording (may be None)."""
        return self.measurements.get(self.native_tile, self.device_kind)

    def _resolve_tile(self, tile: int) -> int:
        return tile or self.native_tile

    def _store_for(self, resolved: int) -> Optional[MeasurementStore]:
        return self.measurements.get(resolved, self.device_kind)

    def _specs_for(self, resolved: int
                   ) -> Optional[Dict[str, CudaKernelSpec]]:
        if resolved in self._native_tiles:
            return self.components
        if self._factory is None:
            return None
        with self._lock:
            specs = self._specs_cache.get(resolved)
        if specs is None:
            specs = dict(self._factory(resolved))
            with self._lock:
                specs = self._specs_cache.setdefault(resolved, specs)
        return specs

    def _measured_here(self, component: str, resolved: int) -> bool:
        """True when (component, resolved tile) is priced by running /
        replaying a kernel rather than by the fallback tool."""
        if component not in self.components:
            return False        # kernel coverage is per component name
        if resolved not in self._native_tiles and self._factory is None:
            return False
        if self.mode in ("record", "replay"):
            return self._store_for(resolved) is not None
        return True             # measure mode: time it live

    # ------------------------------------------------------------------
    # measurement
    # ------------------------------------------------------------------
    def _time_runner(self, runner: Callable[[], Any]) -> float:
        return device_time_s(runner, launches=self.LAUNCHES_PER_READING,
                             reps=self.REPS, device=self.device)

    def _missing_error(self, key: MeasureKey, resolved: int
                       ) -> MissingMeasurementError:
        comp, ports, unrolls = key
        hint = self.record_hint or "re-record the recording for this key"
        return MissingMeasurementError(
            f"no recorded measurement for {comp!r} (ports={ports}, "
            f"unrolls={unrolls}) under key (tile={resolved}, "
            f"device={self.device_kind!r}); recorded keys: "
            f"{self.measurements.describe()}; {hint}")

    def _wall_s(self, spec: CudaKernelSpec, ports: int, unrolls: int,
                resolved: int) -> float:
        memo_key = (spec.name, ports, unrolls, resolved)
        key: MeasureKey = (spec.name, ports, unrolls)
        store = self._store_for(resolved)
        with self._lock:
            hit = self._measured.get(memo_key)
        if hit is not None:
            return hit
        if self.mode == "replay":
            wall = store.get(key)
            if wall is None:
                raise self._missing_error(key, resolved)
        elif self.mode == "record" and store.get(key) is not None:
            # resumed campaign: the point was already paid for (and
            # flushed) by the killed run — never re-time it
            wall = store.get(key)
        else:
            with self._measure_lock:
                with self._lock:              # raced while waiting?
                    hit = self._measured.get(memo_key)
                if hit is not None:
                    return hit
                runner = spec.build(ports, unrolls)
                if self.timer is not None:
                    wall = float(self.timer(spec.name, ports, unrolls,
                                            runner))
                else:
                    wall = self._time_runner(runner)
        with self._lock:
            # a racing measurement of the same key keeps the first value,
            # so every consumer sees one number per physical point
            wall = self._measured.setdefault(memo_key, wall)
            if self.mode == "record" and store.get(key) != wall:
                store.put(key, wall)         # may autoflush (flush_every)
        return wall

    # ------------------------------------------------------------------
    # cost composition
    # ------------------------------------------------------------------
    def _infeasible(self, ports: int, unrolls: int, states: int,
                    tile: int = 0) -> Synthesis:
        return Synthesis(lam=float("inf"), area=float("inf"), ports=ports,
                         unrolls=unrolls, states_per_iter=states,
                         feasible=False, tile=tile)

    # ------------------------------------------------------------------
    # SynthesisTool protocol
    # ------------------------------------------------------------------
    def _route_fallback(self, component: str, tile: int) -> bool:
        """True when (component, tile) is priced by the fallback tool:
        the component has no kernel, or the resolved tile has no
        recording (and cannot be measured live)."""
        return not self._measured_here(component, self._resolve_tile(tile))

    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   tile: int = 0) -> Synthesis:
        resolved = self._resolve_tile(tile)
        measured = self._measured_here(component, resolved)
        if (tile and not measured and not self.native_tile
                and self._factory is None
                and component in self.components):
            # without a declared native tile (or a spec factory, or a
            # recording covering this tile) the oracle cannot tell
            # whether the request matches the kernels — pricing it
            # anyway would fabricate a tile axis out of one tile's
            # measurements (and collide store keys in record mode)
            raise ValueError(
                f"tile={tile} requested for {component!r} but this "
                f"CudaOracle declares no native_tile and no recording "
                f"covers key (tile={tile}, device={self.device_kind!r}) "
                f"(recorded keys: {self.measurements.describe()}); pass "
                f"native_tile= or add a MeasurementStore for that key")
        if not measured:
            if self.fallback is None:
                raise KeyError(f"no CUDA kernel or fallback tool for "
                               f"component {component!r} (tile={tile})")
            return call_synthesize(self.fallback, component,
                                   unrolls=unrolls, ports=ports,
                                   max_states=max_states, tile=tile)
        spec = self._specs_for(resolved)[component]
        if not spec.divisible(ports, unrolls):
            return self._infeasible(ports, unrolls, 0, tile)
        states = spec.states(ports, unrolls)
        if max_states is not None and states > max_states:
            return self._infeasible(ports, unrolls, states, tile)
        H, W = spec.shape
        step = spec.vmem_bytes(H, W, ports=ports, unrolls=unrolls)
        if 2 * step > self.smem_budget:
            # the double-buffered block no longer fits a block's shared
            # memory — discarded, and counted, like any other failed
            # synthesis
            return self._infeasible(ports, unrolls, states, tile)
        try:
            wall = self._wall_s(spec, ports, unrolls, resolved)
        except MissingMeasurementError:
            if self.missing != "fallback":
                raise
            return call_synthesize(self.fallback, component,
                                   unrolls=unrolls, ports=ports,
                                   max_states=max_states, tile=tile)
        lam = wall / ports                       # parallel column banks
        # the one area rule the unit fit shares
        area = smem_area_bytes(spec, ports, unrolls)
        return Synthesis(
            lam=lam, area=area, ports=ports, unrolls=unrolls,
            states_per_iter=states, feasible=True,
            detail={"wall_s": wall, "vmem_step_bytes": float(step),
                    "grid_steps": float(spec.grid_steps(
                        H, W, ports=ports, unrolls=unrolls))},
            tile=tile)

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        # a feasible measured-tile synthesis without a measured wall came
        # from the missing="fallback" path: its Eq. (1) facts must match
        # the model that actually scheduled it, or the derived caps get
        # applied across two different state models
        fallback_priced = (self.missing == "fallback" and synth.feasible
                           and "wall_s" not in (synth.detail or {}))
        if self._route_fallback(component, synth.tile) or fallback_priced:
            if self.fallback is None:
                raise KeyError(component)
            return self.fallback.cdfg_facts(component, synth)
        return self._specs_for(
            self._resolve_tile(synth.tile))[component].facts()

    def plm_requirement(self, component: str, synth: Synthesis):
        """The measured component's memory demand: its entire area IS
        on-chip footprint, so capacity = area bytes and the datapath
        share is zero.  Fallback-priced points delegate to the fallback
        tool — including measured-tile points the ``missing="fallback"``
        policy priced analytically, recognizable by the absence of the
        measured ``wall_s`` detail."""
        if (self._route_fallback(component, synth.tile)
                or "wall_s" not in (synth.detail or {})):
            fn = getattr(self.fallback, "plm_requirement", None)
            return None if fn is None else fn(component, synth)
        area = float(synth.area)
        return PLMRequirement(component=component, capacity=int(area),
                              word_bits=32, ports=synth.ports,
                              area_plm=area, area_logic=0.0,
                              unit="bytes", tile=synth.tile)

    # ------------------------------------------------------------------
    def flush(self) -> Optional[str]:
        """Persist the recordings (record mode); no-op otherwise.
        Returns the native store's path when one was written."""
        if self.mode != "record":
            return None
        saved = self.measurements.save_all()
        native = self.store
        if native is not None and native.path in saved:
            return native.path
        return saved[0] if saved else None


def open_store(path: str, *, mode: str, tile: int = 0,
               device_kind: Optional[str],
               flush_every: int = 16,
               meta: Optional[Dict[str, Any]] = None) -> MeasurementStore:
    """One recording for a drive in ``mode``: load ``path`` when it
    exists (replay always loads — a missing file should fail loudly;
    record mode resumes it, keeping its ``meta``), otherwise start a
    fresh store tagged with ``tile`` and ``device_kind`` (and ``meta``'s
    further keys: :func:`card_provenance` on the card) for a record (or
    measure) campaign.  Record mode autoflushes every ``flush_every``
    timings; replay never writes."""
    autoflush = flush_every if mode == "record" else 0
    if mode == "replay" or os.path.exists(path):
        return MeasurementStore.load(path, flush_every=autoflush)
    return MeasurementStore(path,
                            meta={**(meta or {}), "tile": tile,
                                  "interpret": False,
                                  "device_kind": device_kind},
                            flush_every=autoflush)


def open_recording(path: str, *, mode: str, tile: int = 0,
                   device_kind: Optional[str],
                   flush_every: int = 16,
                   meta: Optional[Dict[str, Any]] = None) -> MeasurementSet:
    """The record/replay bootstrap: :func:`open_store`, wrapped as a
    single-recording :class:`MeasurementSet`."""
    return MeasurementSet.from_store(
        open_store(path, mode=mode, tile=tile, device_kind=device_kind,
                   flush_every=flush_every, meta=meta), tile=tile)


def record_meta(mode: str, device=None) -> Optional[Dict[str, Any]]:
    """The ``meta`` a fresh recording of a drive in ``mode`` on
    ``device`` starts with: the card's provenance when it records on a
    CUDA card, nothing otherwise (a timer standing in for the card on
    the CPU)."""
    if mode != "record" or resolve_device(device).type != "cuda":
        return None
    return card_provenance(device)
