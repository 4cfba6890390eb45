"""The unified synthesis-oracle layer: one query interface for every backend.

COSMOS's headline result is *invocation frugality* — the system-level
Pareto front is recovered with up to 14.6x fewer tool calls than the
exhaustive baseline (Fig. 11) — so the seam between the DSE engine and
the expensive tool is the load-bearing interface of the package.  This
module defines it once, for every oracle:

  * :class:`InvocationRequest` — one knob point to price/synthesize;
  * :class:`Oracle` — the protocol: ``evaluate`` one request or
    ``evaluate_batch`` many (independent knob points fan out over a
    thread pool, since every analytical invocation is pure);
  * :class:`OracleLedger` — the accounting + caching layer: repeats are
    cached and NOT counted (Section 7.3), infeasible points ARE counted
    (Fig. 11 includes the lambda-constraint discards), identical
    invocations issued concurrently are de-duplicated in flight, and
    every real tool call leaves a structured :class:`InvocationRecord`;
  * :class:`PersistentOracleCache` — a pluggable cache backed by
    :mod:`repro_torch.checkpoint.store`, so a killed DSE run resumes
    without re-invoking the tool for any point it already paid for;
  * :class:`SharedOracle` — one tool multiplexed across many tenants'
    ledgers (the DSE service's substrate).

``CountingTool`` is the JAX package's name for :class:`OracleLedger`,
kept so code written against that surface runs here unchanged.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

from .knobs import CDFGFacts, Synthesis
from .obs import NULL_TRACER, MetricsRegistry, OUTCOMES

__all__ = [
    "InvocationRequest",
    "InvocationRecord",
    "Oracle",
    "OracleBatchMixin",
    "OracleCache",
    "PersistentOracleCache",
    "OracleLedger",
    "SharedOracle",
    "CountingTool",
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
    #: class-level default: tracing is off unless a backend instance is
    #: handed a real tracer (``tool.tracer = tracer``)
    tracer = NULL_TRACER

    def evaluate(self, request: InvocationRequest) -> Synthesis:
        with self.tracer.span("tool.point", component=request.component,
                              unrolls=request.unrolls,
                              ports=request.ports, tile=request.tile):
            return call_synthesize(self, request.component,
                                   unrolls=request.unrolls,
                                   ports=request.ports,
                                   max_states=request.max_states,
                                   tile=request.tile)

    def evaluate_batch(self, requests: Sequence[InvocationRequest],
                       *, workers: Optional[int] = None) -> List[Synthesis]:
        reqs = list(requests)
        n = workers or self.batch_workers
        with self.tracer.span("tool.batch", n=len(reqs)):
            if len(reqs) <= 1 or n <= 1:
                return [self.evaluate(r) for r in reqs]
            with ThreadPoolExecutor(max_workers=min(n, len(reqs))) as pool:
                return list(pool.map(self.evaluate, reqs))


def _adopt_tracer(tool: Any, tracer: Any) -> None:
    """Hand a ledger/shared-oracle tracer down to its tool so
    ``tool.point``/``tool.batch`` spans land in the same trace.  Only
    fills the vacancy: a tool already wired to a real tracer keeps it,
    and tools without a ``tracer`` attribute are left alone."""
    if tracer is NULL_TRACER:
        return
    if getattr(tool, "tracer", _adopt_tracer) in (None, NULL_TRACER):
        try:
            tool.tracer = tracer
        except AttributeError:
            pass


# ----------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------
class OracleCache(Protocol):
    """Pluggable persistence for oracle results (keyed by knob point)."""

    def entries(self) -> Dict[Key, Synthesis]: ...

    def put(self, key: Key, synth: Synthesis) -> None: ...

    def flush(self) -> None: ...


def _synth_to_json(s: Synthesis) -> Dict[str, Any]:
    return {"lam": s.lam, "area": s.area, "ports": s.ports,
            "unrolls": s.unrolls, "states": s.states_per_iter,
            "feasible": s.feasible, "detail": dict(s.detail),
            "tile": s.tile}


def _synth_from_json(d: Dict[str, Any]) -> Synthesis:
    return Synthesis(lam=d["lam"], area=d["area"], ports=d["ports"],
                     unrolls=d["unrolls"], states_per_iter=d["states"],
                     feasible=d["feasible"], detail=dict(d["detail"]),
                     tile=d.get("tile", 0))


class PersistentOracleCache:
    """Synthesis results persisted via :mod:`repro_torch.checkpoint.store`.

    Each flush writes the *whole* cache as one atomic checkpoint step
    (store's rename protocol: a crash leaves the previous complete step,
    never a torn one), then prunes older steps.  A killed DSE run that
    restarts with the same ``root`` resumes with every flushed
    invocation served from here.  Flushes are batched (a full rewrite
    per put would be O(n^2) disk I/O): a hard kill can lose at most the
    last ``flush_every - 1`` points — they are simply re-invoked on
    resume — and the ledger flushes the remainder when a session
    completes.  Set ``flush_every=1`` for per-invocation durability.
    Each flush keeps the newest ``keep`` steps on disk (default
    ``KEEP_STEPS``).

    ``root=None`` keeps the cache purely in memory (no store behind it)
    — what a :class:`SharedOracle` pool uses when the service has no
    durable cache directory configured.

    ``max_entries`` bounds the cache with LRU eviction: :meth:`get` and
    :meth:`put` move the key to most-recently-used, and a put beyond
    the bound drops the least-recently-used entry entirely — from
    memory *and* from the next flush, so an evicted point is re-invoked
    (exactly once) if it is ever needed again.  ``hits`` / ``misses`` /
    ``evictions`` count :meth:`get`/:meth:`put` traffic; the bulk
    :meth:`entries` pre-seed path counts nothing and does not touch
    recency.
    """

    KEEP_STEPS = 2

    def __init__(self, root: Optional[str] = None, *, flush_every: int = 16,
                 keep: int = KEEP_STEPS, max_entries: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, name: str = ""):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.root = root
        self.name = name
        self.flush_every = max(1, flush_every)
        self.keep = max(1, keep)
        self.max_entries = max_entries
        # traffic counters live in a metrics registry (lock-consistent by
        # construction); the bare-int names are read-only properties below
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        prefix = f"cache.{name}." if name else "cache."
        self._hits = self.metrics.counter(prefix + "hits")
        self._misses = self.metrics.counter(prefix + "misses")
        self._evictions = self.metrics.counter(prefix + "evictions")
        self._entries: Dict[Key, Synthesis] = {}
        self._restored: set = set()
        self._dirty = 0
        self._lock = threading.Lock()
        if root is not None:
            self._load()

    # -- store glue ----------------------------------------------------
    @staticmethod
    def _store():
        # lazy: only a cache with a root touches the disk
        from ..checkpoint import store
        return store

    def _load(self) -> None:
        import numpy as np
        store = self._store()
        step = store.latest_step(self.root)
        if step is None:
            return
        _, extra = store.restore(self.root, step,
                                 {"n_entries": np.asarray(0)})
        for rec in extra.get("entries", []):
            # pre-tile caches persisted 4-element keys; they reload as
            # native-tile (tile=0) points
            comp, unrolls, ports, max_states, *rest = rec["key"]
            tile = int(rest[0]) if rest else 0
            key = (comp, int(unrolls), int(ports),
                   None if max_states is None else int(max_states), tile)
            self._entries[key] = _synth_from_json(rec["synth"])
            self._restored.add(key)
        if self.max_entries is not None:
            # a persisted cache larger than the bound trims oldest-first
            # (flush order is insertion order) — not counted as traffic
            while len(self._entries) > self.max_entries:
                oldest = next(iter(self._entries))
                self._entries.pop(oldest)
                self._restored.discard(oldest)

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        if self._dirty == 0 or self.root is None:
            return
        import numpy as np
        store = self._store()
        step = (store.latest_step(self.root) or 0) + 1
        payload = [{"key": list(k), "synth": _synth_to_json(s)}
                   for k, s in self._entries.items()]
        store.save(self.root, step,
                   {"n_entries": np.asarray(len(payload))},
                   extra={"entries": payload})
        self._dirty = 0
        for old in store.list_steps(self.root)[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{old:08d}"),
                          ignore_errors=True)

    # -- OracleCache protocol ------------------------------------------
    def entries(self) -> Dict[Key, Synthesis]:
        with self._lock:
            return dict(self._entries)

    def get(self, key: Key) -> Optional[Synthesis]:
        """LRU-aware lookup: a hit refreshes the key's recency."""
        with self._lock:
            hit = self._entries.pop(key, None)
            if hit is None:
                self._misses.inc()
                return None
            self._entries[key] = hit          # re-insert: most recent
            self._hits.inc()
            return hit

    def put(self, key: Key, synth: Synthesis) -> None:
        with self._lock:
            self._entries.pop(key, None)      # refresh recency on rewrite
            self._restored.discard(key)       # freshly paid for, not replay
            self._entries[key] = synth
            if self.max_entries is not None:
                while len(self._entries) > self.max_entries:
                    oldest = next(iter(self._entries))
                    self._entries.pop(oldest)
                    self._restored.discard(oldest)
                    self._evictions.inc()
            self._dirty += 1
            if self._dirty >= self.flush_every:
                self._flush_locked()

    def was_restored(self, key: Key) -> bool:
        """True when ``key``'s current entry came from the persisted
        store rather than being paid for during this process — the
        ``replay`` leg of the per-point outcome partition."""
        with self._lock:
            return key in self._restored

    def consume_restored(self, key: Key) -> bool:
        """:meth:`was_restored` with consume semantics: True exactly
        once per restored entry.  The first serve from a restored
        entry is the ``replay`` (it reconciles one-for-one against the
        restored invocation accounting); after that the entry behaves
        like any other cache entry and further serves are plain hits."""
        with self._lock:
            if key in self._restored:
                self._restored.discard(key)
                return True
            return False

    # bare-int counter names, registry-backed (read-only)
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def stats(self) -> Dict[str, int]:
        with self._lock:
            entries = len(self._entries)
        return {"entries": entries, "hits": self._hits.value,
                "misses": self._misses.value,
                "evictions": self._evictions.value}

    def __len__(self) -> int:
        return len(self._entries)


# ----------------------------------------------------------------------
# Cross-tenant coalescing (the DSE-service substrate)
# ----------------------------------------------------------------------
class _Flight:
    """Rendezvous for one in-flight knob point: waiters hold a reference,
    so the result survives even if the shared cache evicts it before
    every joiner has read it."""

    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result: Optional[Synthesis] = None
        self.error: Optional[BaseException] = None


class SharedOracle:
    """One base tool multiplexed across many concurrent submitters.

    The multi-tenant seam of the DSE service
    (:mod:`repro_torch.serve.dse_service`): every tenant wraps this in its own
    :class:`OracleLedger` (per-tenant Fig. 11 attribution, identical to
    an isolated run), while the SharedOracle dedups the *real* tool
    traffic across all of them:

      * a shared :class:`PersistentOracleCache` (optionally LRU-bounded)
        answers repeats from any tenant without a tool call;
      * identical points submitted concurrently join one in-flight call
        (``joins`` counts the coalesced waiters);
      * distinct points pending at the same moment are drained by a
        single dispatcher thread into ONE ``evaluate_batch`` call on the
        base tool — natural batching: while a batch is in flight, new
        arrivals accumulate for the next drain, so no timing window is
        needed and results stay deterministic per key.

    Errors are per-key and never cached: a batch that raises is re-priced
    point-by-point so the exception reaches exactly the tenants that
    asked for the failing key (``batch_retries`` counts these passes —
    the re-invocations they cost are the price of attribution, paid only
    on the failure path), and a later retry of that key dispatches (and
    counts) again, exactly like :class:`OracleLedger`'s retry rule.

    ``invocations``/``failed``/``total()`` mirror the ledger's counting
    surface — this IS the "shared ledger" the service reports: with any
    cross-tenant overlap its total is strictly below the sum of the
    per-tenant ledgers'.
    """

    def __init__(self, tool, *, cache: Optional[PersistentOracleCache] = None,
                 name: str = "", tracer=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.tool = tool
        self.cache = cache
        self.name = name
        self.tracer = tracer if tracer is not None else NULL_TRACER
        _adopt_tracer(tool, self.tracer)
        self.invocations: Dict[str, int] = {}
        self.failed: Dict[str, int] = {}
        # hits (answered from the shared cache), joins (coalesced onto an
        # in-flight call), batches (dispatcher drains), batch_retries
        # (failed batches re-priced per point): registry-backed counters,
        # so the dispatcher thread's increments are lock-consistent
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        prefix = f"shared.{name}." if name else "shared."
        self._hits = self.metrics.counter(prefix + "hits")
        self._joins = self.metrics.counter(prefix + "joins")
        self._batches = self.metrics.counter(prefix + "batches")
        self._batch_retries = self.metrics.counter(prefix + "batch_retries")
        self._outcome_counters = {
            o: self.metrics.counter(prefix + "points." + o)
            for o in OUTCOMES}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: Dict[Key, _Flight] = {}
        self._pending: List[Tuple[InvocationRequest, _Flight]] = []
        self._dispatcher: Optional[threading.Thread] = None
        self._closed = False

    # -- submitter side ------------------------------------------------
    def evaluate(self, request: InvocationRequest, *,
                 _parent=None) -> Synthesis:
        key = request.key
        with self.tracer.span("shared.point", parent=_parent,
                              component=request.component,
                              unrolls=request.unrolls, ports=request.ports,
                              tile=request.tile) as sp:
            with self._cv:
                if self._closed:
                    raise RuntimeError(
                        f"SharedOracle {self.name!r} is closed")
                if self.cache is not None:
                    hit = self.cache.get(key)
                    if hit is not None:
                        self._hits.inc()
                        outcome = ("replay"
                                   if self.cache.consume_restored(key)
                                   else "cache_hit")
                        sp.set("outcome", outcome)
                        self._outcome_counters[outcome].inc()
                        return hit
                fl = self._inflight.get(key)
                if fl is not None:
                    self._joins.inc()
                    sp.set("outcome", "inflight_join")
                    self._outcome_counters["inflight_join"].inc()
                else:
                    fl = _Flight()
                    self._inflight[key] = fl
                    self._pending.append((request, fl))
                    # counted at dispatch admission, like the ledger's
                    # count-up-front rule (exceptions still count)
                    comp = request.component
                    self.invocations[comp] = \
                        self.invocations.get(comp, 0) + 1
                    sp.set("outcome", "fresh")
                    self._outcome_counters["fresh"].inc()
                    if self._dispatcher is None:
                        try:
                            self._dispatcher = threading.Thread(
                                target=self._dispatch_loop,
                                name=("shared-oracle-"
                                      f"{self.name or f'{id(self):x}'}"),
                                daemon=True)
                            self._dispatcher.start()
                        except BaseException:
                            # never strand a flight others could join: a
                            # dispatcher that failed to start completes
                            # nothing, so unregister before re-raising
                            self._dispatcher = None
                            self._inflight.pop(key, None)
                            self._pending.remove((request, fl))
                            raise
                    self._cv.notify_all()
            fl.event.wait()
            if fl.error is not None:
                raise RuntimeError(f"shared oracle invocation failed for "
                                   f"{key}: {fl.error}") from fl.error
            assert fl.result is not None
            return fl.result

    def evaluate_batch(self, requests: Sequence[InvocationRequest],
                       *, workers: Optional[int] = None) -> List[Synthesis]:
        reqs = list(requests)
        with self.tracer.span("shared.batch", n=len(reqs)) as sp:
            if len(reqs) <= 1:
                return [self.evaluate(r) for r in reqs]
            with ThreadPoolExecutor(max_workers=min(workers or 8,
                                                    len(reqs))) as pool:
                return list(pool.map(
                    lambda r: self.evaluate(r, _parent=sp), reqs))

    # -- dispatcher side -----------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                batch = self._pending
                self._pending = []
            self._run_batch(batch)

    def _call_one(self, req: InvocationRequest) -> Synthesis:
        # prefer the Oracle protocol: it carries the tool.point span;
        # bare SynthesisTools (synthesize only) are priced directly
        tool = self.tool
        if hasattr(tool, "evaluate"):
            return tool.evaluate(req)
        return call_synthesize(tool, req.component,
                               unrolls=req.unrolls, ports=req.ports,
                               max_states=req.max_states, tile=req.tile)

    def _run_batch(self, batch: List[Tuple[InvocationRequest, _Flight]]
                   ) -> None:
        reqs = [r for r, _ in batch]
        self._batches.inc()
        outs: List[Optional[Synthesis]]
        errs: List[Optional[BaseException]]
        with self.tracer.span("shared.drain", n=len(reqs)) as sp:
            try:
                if len(reqs) > 1 and hasattr(self.tool, "evaluate_batch"):
                    outs = list(self.tool.evaluate_batch(reqs))
                else:
                    outs = [self._call_one(r) for r in reqs]
                errs = [None] * len(reqs)
            except BaseException as batch_exc:  # noqa: BLE001
                if len(reqs) == 1:
                    # already attributable — re-pricing would
                    # double-invoke the tool and mask the error on the
                    # retry
                    outs, errs = [None], [batch_exc]
                else:
                    # one failing point must not take the whole drain
                    # down: re-price per point so the error lands on the
                    # right key(s)
                    self._batch_retries.inc()
                    sp.set("retried", True)
                    outs, errs = [], []
                    for r in reqs:
                        try:
                            outs.append(self._call_one(r))
                            errs.append(None)
                        except BaseException as exc:  # noqa: BLE001
                            outs.append(None)
                            errs.append(exc)
            sp.set("errors", sum(1 for e in errs if e is not None))
        for (req, fl), out, err in zip(batch, outs, errs):
            with self._cv:
                if err is None:
                    assert out is not None
                    if not out.feasible:
                        comp = req.component
                        self.failed[comp] = self.failed.get(comp, 0) + 1
                    if self.cache is not None:
                        self.cache.put(req.key, out)
                    fl.result = out
                else:
                    fl.error = err          # transient: never cached
                self._inflight.pop(req.key, None)
            fl.event.set()

    # -- tool delegation (tenant ledgers call these through us) --------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   tile: int = 0) -> Synthesis:
        return self.evaluate(InvocationRequest(
            component=component, unrolls=unrolls, ports=ports,
            max_states=max_states, tile=tile))

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        return self.tool.cdfg_facts(component, synth)

    def plm_requirement(self, component: str, synth: Synthesis):
        fn = getattr(self.tool, "plm_requirement", None)
        return None if fn is None else fn(component, synth)

    # -- accounting ----------------------------------------------------
    # bare-int counter names, registry-backed (read-only)
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def joins(self) -> int:
        return self._joins.value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def batch_retries(self) -> int:
        return self._batch_retries.value

    def total(self, component: Optional[str] = None) -> int:
        with self._lock:
            if component is not None:
                return self.invocations.get(component, 0)
            return sum(self.invocations.values())

    def outcome_counts(self) -> Dict[str, int]:
        """Per-point outcome partition at the shared (cross-tenant)
        level: ``fresh`` admissions to the dispatcher, shared-cache
        ``cache_hit``/``replay``, and ``inflight_join`` waiters."""
        return {o: c.value for o, c in self._outcome_counters.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "invocations": sum(self.invocations.values()),
                "failed": sum(self.failed.values()),
                "hits": self._hits.value, "joins": self._joins.value,
                "batches": self._batches.value,
                "batch_retries": self._batch_retries.value,
            }
        out["outcomes"] = self.outcome_counts()
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        """Stop the dispatcher (pending work drains first) and flush the
        shared cache.  Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            dispatcher = self._dispatcher
        if dispatcher is not None:
            dispatcher.join()
        if self.cache is not None:
            self.cache.flush()


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
                 workers: int = 8, tracer=None,
                 metrics: Optional[MetricsRegistry] = None, name: str = ""):
        self.tool = tool
        self.name = name
        self.workers = max(1, workers)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        _adopt_tracer(tool, self.tracer)
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
        # prefer the Oracle protocol: it carries the tool.point span;
        # bare SynthesisTools (synthesize only) are priced directly
        tool = self.tool
        if hasattr(tool, "evaluate"):
            return tool.evaluate(req)
        return call_synthesize(tool, req.component,
                               unrolls=req.unrolls, ports=req.ports,
                               max_states=req.max_states,
                               tile=req.tile)

    def _note_outcome(self, sp, outcome: str) -> None:
        # caller holds self._lock; Counter has its own (leaf) lock
        sp.set("outcome", outcome)
        self._outcome_counters[outcome].inc()

    def evaluate(self, request: InvocationRequest, *,
                 _parent=None) -> Synthesis:
        key = request.key
        with self.tracer.span("oracle.point", parent=_parent,
                              component=request.component,
                              unrolls=request.unrolls, ports=request.ports,
                              tile=request.tile) as sp:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    if key in self._restored:
                        # first serve from a restored entry: the replay
                        # that reconciles against the restored total;
                        # later serves are ordinary cache hits
                        self._restored.discard(key)
                        self._note_outcome(sp, "replay")
                    else:
                        self._note_outcome(sp, "cache_hit")
                    return hit
                ev = self._inflight.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[key] = ev
                    self._errors.pop(key, None)  # a retry clears old failure
                    owner = True
                    # counted up-front: an invocation that raises still
                    # counts
                    comp = request.component
                    self.invocations[comp] = \
                        self.invocations.get(comp, 0) + 1
                    self._note_outcome(sp, "fresh")
                else:
                    owner = False
                    self._note_outcome(sp, "inflight_join")
            if not owner:
                ev.wait()
                with self._lock:
                    out = self._cache.get(key)
                    err = self._errors.get(key)
                if out is None:
                    if err is not None:
                        raise RuntimeError(
                            f"oracle invocation failed for {key}") from err
                    raise RuntimeError(
                        f"oracle invocation failed for {key}")
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
                    phase=self.phase, wall_s=wall,
                    tile=request.tile))
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
        The batch gets one ``oracle.batch`` span; each point's
        ``oracle.point`` child carries its outcome tag (fan-out workers
        parent to the batch span explicitly, since they run on pool
        threads).
        """
        reqs = list(requests)
        n = self.workers if workers is None else max(1, workers)
        with self.tracer.span("oracle.batch", n=len(reqs),
                              phase=self.phase) as sp:
            if len(reqs) <= 1 or n <= 1:
                return [self.evaluate(r) for r in reqs]
            with ThreadPoolExecutor(max_workers=min(n, len(reqs))) as pool:
                return list(pool.map(
                    lambda r: self.evaluate(r, _parent=sp), reqs))

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
        """Delegate PLM-requirement extraction (core.plm) to the backend;
        returns None for backends that do not expose one."""
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
        restored entry is re-served (the standard resume; in general
        ``replay`` counts only restored entries actually used, so
        ``fresh + replay <= total()``) — the Fig. 11 trace-vs-ledger
        reconciliation invariants."""
        return {o: c.value for o, c in self._outcome_counters.items()}

    def records_by_phase(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.records:
            out[r.phase or "?"] = out.get(r.phase or "?", 0) + 1
        return out


class CountingTool(OracleLedger):
    """The JAX package's name for :class:`OracleLedger`.

    Construction (``CountingTool(tool)``) and the ``synthesize`` /
    ``invocations`` / ``failed`` / ``total`` surface are the ledger's.
    """
