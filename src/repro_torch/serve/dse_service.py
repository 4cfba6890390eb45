"""DSE-as-a-service: many concurrent tenants, shared oracles.

COSMOS's headline result is oracle frugality *within one run*; this
module extends the discipline *across* runs.  A :class:`DSEService`
accepts many concurrent :class:`~repro_torch.core.session.DSEQuery`\\ s
— different apps, budgets, tiles, backends, all resolved through
:mod:`repro_torch.core.registry` — and multiplexes them onto shared
oracles, in the shape of CHARM's async task queues feeding duplicated
accelerators:

  * **submission queue with backpressure** — at most ``max_pending``
    queries may sit queued; further submitters block (optionally with a
    timeout) or get a :class:`Busy` result back, never an unbounded
    queue;
  * **request coalescing** — queries that resolve to the same oracle
    pool (same ``(app, backend, share_plm, tiles)``) share one
    :class:`~repro_torch.core.oracle.SharedOracle`: identical
    ``(component, knob, tile)`` points from different tenants join one in-flight tool
    call, and distinct points pending together drain into single
    ``evaluate_batch`` calls;
  * **cross-tenant cache** — each pool carries a
    :class:`~repro_torch.core.oracle.PersistentOracleCache` (optionally
    durable via ``cache_root``) so a later tenant never re-pays a point an earlier
    tenant already bought;
  * **per-tenant ledger attribution** — every query runs under its own
    :class:`~repro_torch.core.oracle.OracleLedger`, so each tenant's
    invocation counts (and therefore its front) are byte-identical to
    an isolated run, while the pool's shared ledger records the real
    (strictly smaller, under overlap) tool traffic;
  * **async completion** — :meth:`DSEService.submit` returns a
    :class:`QueryHandle` immediately; tenants ``poll()`` or block on
    ``result()``/``wait()``.

Failure isolation: a tenant whose oracle raises fails *its own*
handle — the exception is re-raised from ``result()`` — and nothing
poisons the shared state: errors are never cached, and every other
tenant's front is unaffected (tests/test_torch_service.py seeds exactly
this).

On the card, a ``cuda`` pool's tool is the measured
:class:`~repro_torch.core.cuda_oracle.CudaOracle`: its timings, like
every oracle's in the process, hold the device's one measurement lock,
so two pools never time kernels at the same moment.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

from ..core.obs import NULL_TRACER, MetricsRegistry
from ..core.oracle import OracleLedger, PersistentOracleCache, SharedOracle
from ..core.pricing import BatchPricer
from ..core.registry import build_query_session, build_tool, get_app, get_backend
from ..core.session import CosmosResult, DSEQuery

__all__ = ["Busy", "QueryHandle", "DSEService"]


@dataclass(frozen=True)
class Busy:
    """The backpressure answer: the queue was full (and stayed full for
    the whole ``timeout``, if one was given).  Resubmit later — nothing
    was enqueued."""

    reason: str


class QueryHandle:
    """One submitted query's future: poll it or await it.

    ``status`` moves ``queued -> running -> done | failed``.  After
    completion, ``ledger`` carries the tenant's own
    :class:`~repro_torch.core.oracle.OracleLedger` — the per-tenant Fig. 11
    attribution (identical to an isolated run of the same query).
    """

    def __init__(self, qid: int, query: DSEQuery):
        self.qid = qid
        self.query = query
        self.status = "queued"
        self.ledger: Optional[OracleLedger] = None
        self.wall_s: float = 0.0
        self._result: Optional[CosmosResult] = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        # lifecycle spans, installed by DSEService.submit: the root
        # ``service.query`` span (submit -> completion) and its
        # ``service.queued`` child (submit -> dispatch)
        self._span = None
        self._queued_span = None
        self._submit_t = 0.0

    # -- poll ----------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def poll(self) -> str:
        return self.status

    # -- await ---------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> CosmosResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query {self.qid} ({self.query.app}/"
                               f"{self.query.backend}) still "
                               f"{self.status} after {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"query {self.qid} still {self.status}")
        return self._error

    def invocations(self) -> Dict[str, int]:
        """The tenant's attributed per-component invocation counts."""
        return dict(self.ledger.invocations) if self.ledger else {}

    def outcome_counts(self) -> Dict[str, int]:
        """The tenant ledger's per-point outcome partition
        (``fresh | cache_hit | inflight_join | replay``)."""
        return self.ledger.outcome_counts() if self.ledger else {}

    # -- service side --------------------------------------------------
    def _finish(self, result: Optional[CosmosResult],
                error: Optional[BaseException]) -> None:
        self._result = result
        self._error = error
        self.status = "done" if error is None else "failed"
        self._event.set()


def _pool_slug(key: Tuple[str, str, bool, Tuple[int, ...]]) -> str:
    app, backend, share_plm, tiles = key
    slug = f"{app}-{backend}"
    if share_plm:
        slug += "-share_plm"
    if tiles:
        slug += "-tiles" + "_".join(str(t) for t in tiles)
    return slug


@dataclass
class _Pool:
    """One shared oracle + its cache, keyed by ``DSEQuery.pool_key``."""

    slug: str
    oracle: SharedOracle
    cache: PersistentOracleCache
    tenants: int = 0            # queries that ran through this pool
    # per-delta Pareto-front cardinality of the most recent completed
    # query (``{"delta=0.25": 7, ...}``) — operators read front sizes
    # from ``stats()`` without re-running
    front_sizes: Dict[str, int] = field(default_factory=dict)


class DSEService:
    """The concurrent multi-tenant DSE frontend.

    ``workers`` service threads drain the bounded submission queue and
    run one :class:`~repro_torch.core.session.ExplorationSession` per
    query; sessions whose queries resolve to the same oracle pool share a
    :class:`~repro_torch.core.oracle.SharedOracle` (coalescing + cross-tenant
    cache).  ``cache_entries`` LRU-bounds each pool's cache;
    ``cache_root`` makes the caches durable (one subdirectory per
    pool); ``verify_plans`` turns on the strict plan post-pass for
    every tenant session; ``metrics`` is the registry the service
    counts into and ``stats()`` embeds (a new one when None);
    ``tool_options`` are keywords for every pool's ``build_tool`` (the
    measured backend's ``mode``, ``device``, ...: a service that
    replays the card's recordings passes ``{"mode": "replay"}``).

    Use as a context manager, or call :meth:`close` — queued and
    running queries complete first (``close(drain=False)`` abandons the
    queue: still-queued handles fail with a ``RuntimeError``).
    """

    def __init__(self, *, max_pending: int = 8, workers: int = 2,
                 cache_entries: Optional[int] = None,
                 cache_root: Optional[str] = None,
                 flush_every: int = 16,
                 verify_plans: bool = False,
                 tracer=None,
                 metrics: Optional[MetricsRegistry] = None,
                 tool_options: Optional[Dict[str, Any]] = None):
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self.cache_entries = cache_entries
        self.cache_root = cache_root
        self.flush_every = flush_every
        self.verify_plans = verify_plans
        self.tool_options = dict(tool_options or {})
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # one registry for the whole service: the query counters below,
        # queue-wait/latency histograms, per-pool shared-oracle and cache
        # counters, and per-tenant ledger outcome counters all land here;
        # ``stats()`` embeds its snapshot
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._submitted = self.metrics.counter("service.submitted")
        self._done = self.metrics.counter("service.done")
        self._failed = self.metrics.counter("service.failed")
        self._rejected = self.metrics.counter("service.rejected_busy")
        self._tenant_invocations = self.metrics.counter(
            "service.tenant_invocations")
        self._queued_g = self.metrics.gauge("service.queued")
        self._running_g = self.metrics.gauge("service.running")
        self._queue_wait_h = self.metrics.histogram("service.queue_wait_s")
        self._latency_h = self.metrics.histogram("service.latency_s")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: Deque[QueryHandle] = deque()
        self._pools: Dict[Tuple[str, str, bool, Tuple[int, ...]], _Pool] = {}
        self._closed = False
        self._next_qid = 0
        self._running = 0
        self._workers = [threading.Thread(target=self._worker_loop,
                                          name=f"dse-service-{i}",
                                          daemon=True)
                         for i in range(max(1, workers))]
        for t in self._workers:
            t.start()

    # -- submission ----------------------------------------------------
    def submit(self, query: DSEQuery, *, block: bool = True,
               timeout: Optional[float] = None
               ) -> Union[QueryHandle, Busy]:
        """Enqueue one query; returns its :class:`QueryHandle`, or
        :class:`Busy` under backpressure.

        Unknown app/backend names raise the registry's listing errors
        here, synchronously — a bad query never occupies a queue slot.
        ``block=False`` returns :class:`Busy` immediately when the
        queue is full; ``block=True`` waits (at most ``timeout``
        seconds, forever when None) for a slot.
        """
        get_app(query.app)              # registry-style KeyError on typos
        get_backend(query.backend)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._closed:
                raise RuntimeError("DSEService is closed")
            while len(self._queue) >= self.max_pending:
                reason = (f"queue full ({self.max_pending} pending); "
                          f"resubmit later")
                if not block:
                    self._rejected.inc()
                    self.tracer.instant("service.rejected",
                                        tenant=query.tenant, app=query.app)
                    return Busy(reason)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    self._rejected.inc()
                    return Busy(reason + f" (timed out after {timeout}s)")
                if not self._cv.wait(remaining):
                    self._rejected.inc()
                    return Busy(reason + f" (timed out after {timeout}s)")
                if self._closed:
                    raise RuntimeError("DSEService is closed")
            handle = QueryHandle(self._next_qid, query)
            self._next_qid += 1
            self._submitted.inc()
            # the query's root span opens at submit and is finished by
            # the worker at completion; its first child covers the
            # queue-wait (finished at dispatch)
            handle._span = self.tracer.begin(
                "service.query", qid=handle.qid, tenant=query.tenant,
                app=query.app, backend=query.backend)
            handle._queued_span = self.tracer.begin(
                "service.queued", parent=handle._span, qid=handle.qid)
            handle._submit_t = time.monotonic()
            self._queue.append(handle)
            self._queued_g.set(len(self._queue))
            self._cv.notify_all()
        return handle

    def submit_all(self, queries: List[DSEQuery],
                   timeout: Optional[float] = None) -> List[QueryHandle]:
        """Blocking convenience: submit every query (waiting out
        backpressure) and return the handles in order."""
        out = []
        for q in queries:
            h = self.submit(q, block=True, timeout=timeout)
            if isinstance(h, Busy):
                raise TimeoutError(f"submit_all stalled: {h.reason}")
            out.append(h)
        return out

    # -- the oracle pools ----------------------------------------------
    def _pool(self, query: DSEQuery) -> _Pool:
        key = query.pool_key
        with self._lock:
            pool = self._pools.get(key)
            if pool is None:
                slug = _pool_slug(key)
                root = (None if self.cache_root is None else
                        f"{self.cache_root}/{slug}")
                cache = PersistentOracleCache(
                    root, flush_every=self.flush_every,
                    max_entries=self.cache_entries,
                    metrics=self.metrics, name=slug)
                tool = build_tool(query.app, query.backend,
                                  share_plm=query.share_plm,
                                  tiles=query.tiles, **self.tool_options)
                # pool-level whole-grid pricing: analytical tools answer
                # every tenant's scalar request from one shared, memoized
                # grid per (component, tile) — bit-exact, so coalescing
                # and per-tenant attribution are unchanged; measured
                # tools pass through wrap() untouched
                tool = BatchPricer.wrap(tool)
                pool = _Pool(slug=slug, cache=cache,
                             oracle=SharedOracle(tool, cache=cache,
                                                 name=slug,
                                                 tracer=self.tracer,
                                                 metrics=self.metrics))
                self._pools[key] = pool
            pool.tenants += 1
            return pool

    # -- workers -------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:
                    return                   # closed and drained
                handle = self._queue.popleft()
                self._running += 1
                self._queued_g.set(len(self._queue))
                self._running_g.set(self._running)
                self._cv.notify_all()        # a queue slot freed up
            try:
                self._run(handle)
            finally:
                with self._cv:
                    self._running -= 1
                    self._running_g.set(self._running)
                    self._cv.notify_all()

    def _run(self, handle: QueryHandle) -> None:
        handle.status = "running"
        handle._queued_span.finish()         # queue-wait ends at dispatch
        self._queue_wait_h.observe(time.monotonic() - handle._submit_t)
        t0 = time.monotonic()
        tenant = handle.query.tenant or f"q{handle.qid}"
        try:
            pool = self._pool(handle.query)
            ledger = OracleLedger(pool.oracle,
                                  workers=handle.query.workers,
                                  tracer=self.tracer,
                                  metrics=self.metrics, name=tenant)
            handle.ledger = ledger
            # a context-managed child of the query's root span: the
            # session (which adopts the ledger's tracer) nests its phase
            # spans under it via this worker thread's span stack
            with self.tracer.span("service.run", parent=handle._span,
                                  qid=handle.qid, tenant=tenant,
                                  pool=pool.slug):
                session = build_query_session(
                    handle.query, ledger=ledger,
                    verify_plans=self.verify_plans)
                result = session.run()
            with self._lock:
                pool.front_sizes[f"delta={session.delta:g}"] = \
                    len(result.pareto())
        except BaseException as exc:  # noqa: BLE001 — isolated per tenant
            handle.wall_s = time.monotonic() - t0
            self._latency_h.observe(handle.wall_s)
            self._failed.inc()
            handle._span.set("status", "failed")
            handle._span.finish(exc)
            handle._finish(None, exc)
            return
        handle.wall_s = time.monotonic() - t0
        self._latency_h.observe(handle.wall_s)
        self._done.inc()
        self._tenant_invocations.inc(ledger.total())
        handle._span.set("invocations", ledger.total())
        handle._span.finish()
        handle._finish(result, None)

    # -- introspection -------------------------------------------------
    def shared_invocations(self) -> int:
        """Real tool calls across every pool — the service-wide shared
        ledger total.  Under any cross-tenant overlap this is strictly
        below the sum of the per-tenant attributions."""
        with self._lock:
            pools = list(self._pools.values())
        return sum(p.oracle.total() for p in pools)

    def stats(self) -> Dict[str, Any]:
        """Service-wide picture: the historical query/pool summary plus
        ``metrics`` — the full registry snapshot (counters, gauges,
        queue-wait/latency histograms, per-pool cache and shared-oracle
        counters, per-tenant outcome partitions)."""
        with self._lock:
            pools = dict(self._pools)
            front_sizes = {p.slug: dict(sorted(p.front_sizes.items()))
                           for p in pools.values()}
            out: Dict[str, Any] = {
                "queries": {"submitted": self._submitted.value,
                            "done": self._done.value,
                            "failed": self._failed.value,
                            "rejected_busy": self._rejected.value,
                            "queued": len(self._queue),
                            "running": self._running},
                "tenant_invocations": self._tenant_invocations.value,
            }
        out["pools"] = {p.slug: dict(p.oracle.stats(), tenants=p.tenants,
                                     front_sizes=front_sizes[p.slug])
                        for p in pools.values()}
        out["shared_invocations"] = sum(
            p.oracle.total() for p in pools.values())
        out["metrics"] = self.metrics.snapshot()
        return out

    # -- lifecycle -----------------------------------------------------
    def close(self, *, drain: bool = True) -> None:
        """Stop the service.  ``drain=True`` (default) lets queued and
        running queries finish; ``drain=False`` fails still-queued
        handles immediately (running ones still finish)."""
        with self._cv:
            if self._closed:
                return
            abandoned: List[QueryHandle] = []
            if not drain:
                abandoned = list(self._queue)
                self._queue.clear()
            self._closed = True
            self._cv.notify_all()
        for h in abandoned:
            err = RuntimeError("DSEService closed before this query ran")
            h._queued_span.finish(err)
            h._span.finish(err)
            h._finish(None, err)
        for t in self._workers:
            t.join()
        for pool in self._pools.values():
            pool.oracle.close()

    def __enter__(self) -> "DSEService":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
