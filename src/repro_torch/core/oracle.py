"""The unified synthesis-oracle layer: one query interface for every backend.

COSMOS's headline result is *invocation frugality* — the system-level
Pareto front is recovered with up to 14.6x fewer tool calls than the
exhaustive baseline (Fig. 11) — so the seam between the DSE engine and
the expensive tool is the load-bearing interface of the package.  This
module defines it once, for every oracle:

  * :class:`InvocationRequest` — one knob point to price/synthesize;
  * :class:`Oracle` — the protocol: ``evaluate`` one request or
    ``evaluate_batch`` many (independent knob points fan out over a
    thread pool, since every hlsim invocation is pure);
  * :class:`OracleLedger` — the accounting + caching layer: repeats are
    cached and NOT counted (Section 7.3), infeasible points ARE counted
    (Fig. 11 includes the lambda-constraint discards), identical
    invocations issued concurrently are de-duplicated in flight, and
    every real tool call leaves a structured :class:`InvocationRecord`;
  * :class:`OracleCache` — the protocol of a pluggable result cache that
    pre-seeds a ledger.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

from .knobs import CDFGFacts, Synthesis
from .obs import MetricsRegistry, OUTCOMES

__all__ = [
    "InvocationRequest",
    "InvocationRecord",
    "Oracle",
    "OracleBatchMixin",
    "OracleCache",
    "OracleLedger",
    "call_synthesize",
]


def call_synthesize(tool, component: str, *, unrolls: int, ports: int,
                    max_states: Optional[int] = None,
                    tile: int = 0) -> Synthesis:
    """Invoke ``tool.synthesize`` forwarding ``tile`` only when set.

    The single place that encodes the compatibility rule for the tile
    knob: two-knob backends (and pre-tile user tools) never see the
    keyword, so they keep working unchanged.
    """
    if tile:
        return tool.synthesize(component, unrolls=unrolls, ports=ports,
                               max_states=max_states, tile=tile)
    return tool.synthesize(component, unrolls=unrolls, ports=ports,
                           max_states=max_states)

# key type used everywhere below:
# (component, unrolls, ports, max_states, tile); tile 0 = native tile
Key = Tuple[str, int, int, Optional[int], int]


@dataclass(frozen=True)
class InvocationRequest:
    """One knob point submitted to an oracle.

    ``max_states`` carries the lambda-constraint of Algorithm 1 (the
    synthesis fails when the scheduler cannot fit an iteration within
    that many states); ``None`` means unconstrained.  ``tile`` is the
    third knob axis (PLM tile edge); 0 means the component's native
    tile, and is the only value two-knob backends ever see.
    """

    component: str
    unrolls: int
    ports: int
    max_states: Optional[int] = None
    tile: int = 0

    @property
    def key(self) -> Key:
        return (self.component, self.unrolls, self.ports, self.max_states,
                self.tile)


@dataclass(frozen=True)
class InvocationRecord:
    """One *real* tool call, as accounted in Fig. 11.

    Cache hits never produce a record — a record is money spent.
    ``phase`` tags which DSE phase paid for it (characterize/map/...),
    which is what the invocation-breakdown benchmarks aggregate.
    """

    component: str
    unrolls: int
    ports: int
    max_states: Optional[int]
    feasible: bool
    lam: float
    area: float
    phase: str = ""
    wall_s: float = 0.0
    tile: int = 0


@runtime_checkable
class Oracle(Protocol):
    """The expensive oracle COSMOS coordinates, batched form.

    ``evaluate`` prices/synthesizes a single knob point.
    ``evaluate_batch`` prices many *independent* points; implementations
    are free to fan out (thread pool, async compile service, RPC) as long
    as results come back in request order.  ``cdfg_facts`` exposes the
    Eq. (1) inputs extracted from a completed synthesis.
    """

    def evaluate(self, request: InvocationRequest) -> Synthesis: ...

    def evaluate_batch(self, requests: Sequence[InvocationRequest]
                       ) -> List[Synthesis]: ...

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts: ...


class OracleBatchMixin:
    """Adapts a ``synthesize``-style SynthesisTool to the Oracle protocol.

    Backends inherit this and only implement ``synthesize`` (+
    ``cdfg_facts``); the default batch is a thread-pool fan-out, valid
    because every backend invocation in this repo is pure.
    """

    batch_workers: int = 8

    def evaluate(self, request: InvocationRequest) -> Synthesis:
        return call_synthesize(self, request.component,
                               unrolls=request.unrolls,
                               ports=request.ports,
                               max_states=request.max_states,
                               tile=request.tile)

    def evaluate_batch(self, requests: Sequence[InvocationRequest],
                       *, workers: Optional[int] = None) -> List[Synthesis]:
        reqs = list(requests)
        n = workers or self.batch_workers
        if len(reqs) <= 1 or n <= 1:
            return [self.evaluate(r) for r in reqs]
        with ThreadPoolExecutor(max_workers=min(n, len(reqs))) as pool:
            return list(pool.map(self.evaluate, reqs))


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------
class OracleCache(Protocol):
    """Pluggable persistence for oracle results (keyed by knob point)."""

    def entries(self) -> Dict[Key, Synthesis]: ...

    def put(self, key: Key, synth: Synthesis) -> None: ...

    def flush(self) -> None: ...


# ----------------------------------------------------------------------
# The ledger
# ----------------------------------------------------------------------
class OracleLedger:
    """Invocation accounting + caching around any oracle or tool.

    Section 7.3 / Fig. 11 semantics: repeated invocations with identical
    knobs are served from cache and NOT counted; failed syntheses
    (lambda-constraint discards) ARE counted.  On top of that:

      * thread-safe, with in-flight de-duplication — two workers racing
        on the same knob point trigger ONE tool call, so batched and
        sequential drives count identically;
      * ``evaluate_batch`` fans independent points out over a pool;
      * every real call appends an :class:`InvocationRecord`;
      * an optional :class:`OracleCache` pre-seeds the in-memory cache
        (counts are reconstructed from it, one per persisted point, so a
        resumed run reports the same totals as an uninterrupted one) and
        receives every new result.
    """

    def __init__(self, tool, *, cache: Optional[OracleCache] = None,
                 workers: int = 8,
                 metrics: Optional[MetricsRegistry] = None, name: str = ""):
        self.tool = tool
        self.name = name
        self.workers = max(1, workers)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        prefix = f"oracle.{name}." if name else "oracle."
        self._outcome_counters = {
            o: self.metrics.counter(prefix + "points." + o)
            for o in OUTCOMES}
        self._invoke_hist = self.metrics.histogram(prefix + "invoke_wall_s")
        self.invocations: Dict[str, int] = {}
        self.failed: Dict[str, int] = {}
        self.records: List[InvocationRecord] = []
        self.phase: str = ""
        self._cache: Dict[Key, Synthesis] = {}
        self._restored: set = set()
        self._persist = cache
        self._lock = threading.Lock()
        self._inflight: Dict[Key, threading.Event] = {}
        self._errors: Dict[Key, BaseException] = {}
        if cache is not None:
            # reconstruct the accounting one-for-one from the persisted
            # points, so a resumed run reports the same totals (and the
            # same per-phase record sums) as an uninterrupted one
            for key, synth in cache.entries().items():
                self._cache[key] = synth
                self._restored.add(key)
                comp = key[0]
                self.invocations[comp] = self.invocations.get(comp, 0) + 1
                if not synth.feasible:
                    self.failed[comp] = self.failed.get(comp, 0) + 1
                self.records.append(InvocationRecord(
                    component=comp, unrolls=key[1], ports=key[2],
                    max_states=key[3], feasible=synth.feasible,
                    lam=synth.lam, area=synth.area, phase="restored",
                    tile=key[4] if len(key) > 4 else 0))

    # ------------------------------------------------------------------
    def _call_tool(self, req: InvocationRequest) -> Synthesis:
        # prefer the Oracle protocol; bare SynthesisTools (synthesize
        # only) are priced directly
        tool = self.tool
        if hasattr(tool, "evaluate"):
            return tool.evaluate(req)
        return call_synthesize(tool, req.component,
                               unrolls=req.unrolls, ports=req.ports,
                               max_states=req.max_states,
                               tile=req.tile)

    def evaluate(self, request: InvocationRequest) -> Synthesis:
        key = request.key
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None:
                if key in self._restored:
                    # first serve from a restored entry: the replay that
                    # reconciles against the restored total; later serves
                    # are ordinary cache hits
                    self._restored.discard(key)
                    self._outcome_counters["replay"].inc()
                else:
                    self._outcome_counters["cache_hit"].inc()
                return hit
            ev = self._inflight.get(key)
            if ev is None:
                ev = threading.Event()
                self._inflight[key] = ev
                self._errors.pop(key, None)  # a retry clears old failure
                owner = True
                # counted up-front: an invocation that raises still counts
                comp = request.component
                self.invocations[comp] = self.invocations.get(comp, 0) + 1
                self._outcome_counters["fresh"].inc()
            else:
                owner = False
                self._outcome_counters["inflight_join"].inc()
        if not owner:
            ev.wait()
            with self._lock:
                out = self._cache.get(key)
                err = self._errors.get(key)
            if out is None:
                if err is not None:
                    raise RuntimeError(
                        f"oracle invocation failed for {key}") from err
                raise RuntimeError(f"oracle invocation failed for {key}")
            return out
        t0 = time.monotonic()
        try:
            out = self._call_tool(request)
        except BaseException as exc:
            with self._lock:
                self._errors[key] = exc
                self._inflight.pop(key, None)
            ev.set()
            raise
        wall = time.monotonic() - t0
        self._invoke_hist.observe(wall)
        with self._lock:
            if not out.feasible:
                comp = request.component
                self.failed[comp] = self.failed.get(comp, 0) + 1
            self._cache[key] = out
            self._restored.discard(key)   # paid for in this process
            self.records.append(InvocationRecord(
                component=request.component, unrolls=request.unrolls,
                ports=request.ports, max_states=request.max_states,
                feasible=out.feasible, lam=out.lam, area=out.area,
                phase=self.phase, wall_s=wall, tile=request.tile))
            self._inflight.pop(key, None)
        ev.set()
        if self._persist is not None:
            self._persist.put(key, out)
        return out

    def evaluate_batch(self, requests: Sequence[InvocationRequest],
                       *, workers: Optional[int] = None) -> List[Synthesis]:
        """Evaluate independent knob points, fanned out over a pool.

        Results come back in request order; duplicate keys inside the
        batch (and races with other concurrent callers) collapse to one
        tool call via the in-flight de-duplication in ``evaluate``.
        """
        reqs = list(requests)
        n = self.workers if workers is None else max(1, workers)
        if len(reqs) <= 1 or n <= 1:
            return [self.evaluate(r) for r in reqs]
        with ThreadPoolExecutor(max_workers=min(n, len(reqs))) as pool:
            return list(pool.map(self.evaluate, reqs))

    # ------------------------------------------------------------------
    # SynthesisTool surface (the engine drives this)
    # ------------------------------------------------------------------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   tile: int = 0) -> Synthesis:
        return self.evaluate(InvocationRequest(
            component=component, unrolls=unrolls, ports=ports,
            max_states=max_states, tile=tile))

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        return self.tool.cdfg_facts(component, synth)

    def plm_requirement(self, component: str, synth: Synthesis):
        """Delegate PLM-requirement extraction to the backend; returns
        None for backends that do not expose one."""
        fn = getattr(self.tool, "plm_requirement", None)
        return None if fn is None else fn(component, synth)

    def total(self, component: Optional[str] = None) -> int:
        if component is not None:
            return self.invocations.get(component, 0)
        return sum(self.invocations.values())

    def flush(self) -> None:
        if self._persist is not None:
            self._persist.flush()

    def outcome_counts(self) -> Dict[str, int]:
        """Per-point outcome partition as seen by this ledger:
        ``fresh + cache_hit + inflight_join + replay`` partitions every
        ``evaluate`` call, and ``fresh + replay == total()`` when every
        restored entry is re-served."""
        return {o: c.value for o, c in self._outcome_counters.items()}

    def records_by_phase(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.phase or "?"] = out.get(r.phase or "?", 0) + 1
        return out
