"""The PyTorch package's multi-tenant DSE service, against isolated runs
and against the JAX package's service.

N tenants running concurrently through one ``DSEService`` get fronts
byte-identical to N isolated runs, with per-tenant ledger attribution
identical to isolation, while the shared oracle underneath dedups the
real tool traffic (cache hits, in-flight joins, batching) and one
tenant's failure never leaks into another's front or the shared cache.
Toy apps register in the port's registry only.  The acceptance run
replays the JAX package's interpret-mode recordings through
``CudaOracle`` on the CPU (a backend registered by this module) and must
match that package's service run with its ``pallas`` backend: fronts,
per-tenant invocations, shared invocations and pool count.  Two
``CudaOracle``s never time at the same moment.
"""

import dataclasses
import os
import sys
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import DSEQuery as RefQuery
from repro.core.registry import build_query_session as ref_build_query
from repro.serve import DSEService as RefService
from repro_torch.apps.wami import wami_cuda_components
from repro_torch.core import (CudaOracle, DSEQuery, OracleLedger,
                              SharedOracle)
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest
from repro_torch.core.knobs import KnobSpace
from repro_torch.core.oracle import InvocationRequest, PersistentOracleCache
from repro_torch.core.registry import (_APPS, _BACKENDS, App, Backend,
                                       _cuda_supports, _cuda_tool,
                                       build_query_session, register_app,
                                       register_backend)
from repro_torch.core.tmg import pipeline_tmg
from repro_torch.serve import Busy, DSEService

MEASUREMENTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "measurements")
SMEM_16MIB = 16 * 2 ** 20           # the JAX package's VMEM budget
TIMEOUT = 120


# ----------------------------------------------------------------------
# runnable toy apps (registered per test, deregistered by the fixture)
# ----------------------------------------------------------------------
def _toy_specs(scale=1):
    return {
        "a": ComponentSpec("a", LoopNest(256 * scale, 2, 1, 8, 3, 6),
                           1024, 1024),
        "b": ComponentSpec("b", LoopNest(128 * scale, 1, 1, 4, 2, 4),
                           512, 512),
    }


class _BrokenTool(HLSTool):
    """Seeded failure: every price for component 'b' raises."""

    def synthesize(self, component, **kw):
        if component == "b":
            raise RuntimeError("seeded oracle failure for 'b'")
        return super().synthesize(component, **kw)


class _GatedTool(HLSTool):
    """Every price blocks until the test opens the gate."""

    gate = threading.Event()

    def synthesize(self, component, **kw):
        if not _GatedTool.gate.wait(timeout=30):
            raise TimeoutError("test gate never opened")
        return super().synthesize(component, **kw)


def _toy_app(name, tool_factory=None, scale=1):
    return App(
        name=name,
        description="runnable toy for the DSE-service battery",
        tmg=lambda: pipeline_tmg(["a", "b"], buffers=2),
        knob_spaces=lambda **_: {n: KnobSpace(clock_ns=1.0, max_ports=4,
                                              max_unrolls=8)
                                 for n in ("a", "b")},
        analytical=tool_factory or (lambda: HLSTool(_toy_specs(scale))),
    )


TOYS = {
    "svc-toy-a": _toy_app("svc-toy-a"),
    "svc-toy-b": _toy_app("svc-toy-b", scale=2),
    "svc-toy-broken": _toy_app("svc-toy-broken",
                               lambda: _BrokenTool(_toy_specs())),
    "svc-toy-gated": _toy_app("svc-toy-gated",
                              lambda: _GatedTool(_toy_specs())),
}


def _interpret_tool(app, **opts):
    """The measured backend over the JAX package's interpret-mode WAMI
    recordings, replayed on the CPU."""
    app = dataclasses.replace(app, measurement_path=lambda t: os.path.join(
        MEASUREMENTS, f"{app.name}_pallas_tile{t}.json"))
    return _cuda_tool(app, mode="replay", device="cpu",
                      device_kind="interpret", smem_budget=SMEM_16MIB,
                      **opts)


INTERPRET = Backend(name="cuda-interpret",
                    description="the cuda backend replaying interpret-mode "
                                "recordings on the CPU",
                    measured=True, make_tool=_interpret_tool,
                    supports=_cuda_supports)


@pytest.fixture(autouse=True)
def _toy_registry():
    for app in TOYS.values():
        register_app(app)
    register_backend(INTERPRET)
    _GatedTool.gate.clear()
    try:
        yield
    finally:
        _GatedTool.gate.set()        # never leave a worker blocked
        for name in TOYS:
            _APPS.pop(name, None)
        _BACKENDS.pop(INTERPRET.name, None)


def _isolated(query):
    s = build_query_session(query)
    return s.run(), dict(s.ledger.invocations)


def _front(result):
    return repr(result.planned), repr(result.mapped)


def _wait_running(handle):
    deadline = time.monotonic() + 10
    while handle.poll() == "queued":
        assert time.monotonic() < deadline
        time.sleep(0.01)


# ----------------------------------------------------------------------
# (1) N concurrent tenants == N isolated runs, byte-identical
# ----------------------------------------------------------------------
def test_concurrent_tenants_match_isolated_runs():
    queries = [
        DSEQuery(app="svc-toy-a", tenant="t0"),
        DSEQuery(app="svc-toy-a", delta=0.5, tenant="t1"),
        DSEQuery(app="svc-toy-b", tenant="t2"),
        DSEQuery(app="svc-toy-b", delta=0.4, tenant="t3"),
        DSEQuery(app="svc-toy-a", tenant="t4"),      # exact duplicate of t0
    ]
    iso = {q.tenant: _isolated(q) for q in queries}
    with DSEService(max_pending=8, workers=4) as svc:
        handles = svc.submit_all(queries)
        results = {h.query.tenant: h.result(timeout=TIMEOUT)
                   for h in handles}
        stats = svc.stats()
    for h in handles:
        ref, ref_inv = iso[h.query.tenant]
        assert _front(results[h.query.tenant]) == _front(ref), h.query
        assert h.invocations() == ref_inv, h.query
        assert h.status == "done" and h.done()
    tenant_sum = sum(sum(inv.values()) for _, inv in iso.values())
    assert stats["shared_invocations"] < tenant_sum
    assert stats["tenant_invocations"] == tenant_sum
    pool_a = stats["pools"]["svc-toy-a-analytical"]
    assert pool_a["tenants"] == 3
    assert pool_a["hits"] + pool_a["joins"] > 0


def test_stats_reports_per_pool_front_sizes():
    queries = [
        DSEQuery(app="svc-toy-a", delta=0.5, tenant="s0"),
        DSEQuery(app="svc-toy-a", delta=0.4, tenant="s1"),
        DSEQuery(app="svc-toy-b", delta=0.5, tenant="s2"),
    ]
    with DSEService(max_pending=4, workers=2) as svc:
        handles = svc.submit_all(queries)
        fronts = {h.query.tenant: len(h.result(timeout=TIMEOUT).pareto())
                  for h in handles}
        stats = svc.stats()
    assert stats["pools"]["svc-toy-a-analytical"]["front_sizes"] == {
        "delta=0.5": fronts["s0"], "delta=0.4": fronts["s1"]}
    assert stats["pools"]["svc-toy-b-analytical"]["front_sizes"] == {
        "delta=0.5": fronts["s2"]}
    assert all(n >= 1 for n in fronts.values())


def test_query_pool_key_and_list_inputs():
    q = DSEQuery(app="wami", backend="cuda", share_plm=True, tiles=[64, 128],
                 tile_sizes=[64], delta=0.5, tenant="x")
    assert q.tiles == (64, 128) and q.tile_sizes == (64,)
    assert q.pool_key == ("wami", "cuda", True, (64, 128))
    assert q.pool_key == RefQuery(app="wami", backend="cuda", share_plm=True,
                                  tiles=(64, 128)).pool_key
    assert hash(q) == hash(dataclasses.replace(q))


# ----------------------------------------------------------------------
# (2) randomized tenant mixes / interleavings (property test)
# ----------------------------------------------------------------------
_REF_CACHE = {}


def _reference(query):
    key = query.pool_key + (query.delta,)
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _isolated(query)
    return _REF_CACHE[key]


@settings(max_examples=8, deadline=None)
@given(mix=st.lists(
    st.tuples(st.sampled_from(["svc-toy-a", "svc-toy-b"]),
              st.sampled_from([None, 0.4, 0.5])),
    min_size=1, max_size=6),
    workers=st.integers(min_value=1, max_value=4))
def test_randomized_tenant_mixes_stay_deterministic(mix, workers):
    for app in TOYS.values():          # hypothesis reruns outlive fixtures
        register_app(app)
    queries = [DSEQuery(app=a, delta=d, tenant=f"t{i}")
               for i, (a, d) in enumerate(mix)]
    with DSEService(max_pending=len(queries), workers=workers) as svc:
        handles = svc.submit_all(queries)
        for h in handles:
            ref, ref_inv = _reference(h.query)
            assert _front(h.result(timeout=TIMEOUT)) == _front(ref)
            assert h.invocations() == ref_inv


# ----------------------------------------------------------------------
# (3) seeded failure: surfaces to that tenant only
# ----------------------------------------------------------------------
def test_failure_is_isolated_to_its_tenant():
    queries = [
        DSEQuery(app="svc-toy-a", tenant="healthy-0"),
        DSEQuery(app="svc-toy-broken", tenant="doomed"),
        DSEQuery(app="svc-toy-b", tenant="healthy-1"),
    ]
    iso = {q.tenant: _isolated(q) for q in queries if q.tenant != "doomed"}
    with DSEService(max_pending=4, workers=3) as svc:
        handles = svc.submit_all(queries)
        doomed = next(h for h in handles if h.query.tenant == "doomed")
        with pytest.raises(RuntimeError, match="seeded oracle failure"):
            doomed.result(timeout=TIMEOUT)
        assert doomed.status == "failed"
        assert isinstance(doomed.exception(timeout=TIMEOUT), RuntimeError)
        for h in handles:
            if h.query.tenant == "doomed":
                continue
            ref, ref_inv = iso[h.query.tenant]
            assert _front(h.result(timeout=TIMEOUT)) == _front(ref)
            assert h.invocations() == ref_inv
        stats = svc.stats()
    assert stats["queries"]["failed"] == 1 and stats["queries"]["done"] == 2
    broken = stats["pools"]["svc-toy-broken-analytical"]
    assert broken["cache"]["entries"] <= broken["invocations"]


def test_error_is_never_cached_and_retry_reinvokes():
    calls = []

    class Flaky(HLSTool):
        def synthesize(self, component, **kw):
            calls.append(component)
            if len(calls) == 1:
                raise RuntimeError("transient")
            return super().synthesize(component, **kw)

    cache = PersistentOracleCache(max_entries=None)
    shared = SharedOracle(Flaky(_toy_specs()), cache=cache, name="flaky")
    req = InvocationRequest(component="a", unrolls=1, ports=1)
    try:
        with pytest.raises(RuntimeError, match="shared oracle invocation"):
            shared.evaluate(req)
        assert cache.get(req.key) is None
        assert shared.evaluate(req).feasible and len(calls) == 2
        assert shared.total("a") == 2
        assert cache.get(req.key) is not None
    finally:
        shared.close()


def test_failing_batch_is_repriced_per_point():
    """One failing point of a multi-point drain does not take the drain
    down: the batch is re-priced point by point and only the failing
    key's waiter sees the error."""
    gate, entered = threading.Event(), threading.Event()

    class BadB(HLSTool):
        def synthesize(self, component, **kw):
            if component == "c":
                entered.set()
                if not gate.wait(timeout=30):
                    raise TimeoutError("test gate never opened")
            if component == "b":
                raise RuntimeError("seeded")
            return super().synthesize(component, **kw)

    specs = dict(_toy_specs(), c=_toy_specs(2)["a"])
    shared = SharedOracle(BadB(specs), cache=PersistentOracleCache(None),
                          name="mixed")
    out = {}

    def ask(comp):
        try:
            out[comp] = shared.evaluate(
                InvocationRequest(component=comp, unrolls=1, ports=1))
        except RuntimeError as exc:
            out[comp] = exc

    threads = [threading.Thread(target=ask, args=(c,)) for c in "cab"]
    try:
        threads[0].start()           # its drain holds the dispatcher
        assert entered.wait(timeout=TIMEOUT)
        for t in threads[1:]:
            t.start()
        while shared.outcome_counts()["fresh"] < 3:
            time.sleep(0.01)
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        shared.close()
    assert out["c"].feasible and out["a"].feasible
    assert isinstance(out["b"], RuntimeError)
    assert shared.batches == 2 and shared.batch_retries == 1


# ----------------------------------------------------------------------
# (4) LRU eviction: evicted points re-invoke exactly once
# ----------------------------------------------------------------------
def test_lru_eviction_reinvokes_exactly_once():
    calls = []

    class Counting(HLSTool):
        def synthesize(self, component, **kw):
            calls.append((component, kw["unrolls"]))
            return super().synthesize(component, **kw)

    cache = PersistentOracleCache(max_entries=2)
    shared = SharedOracle(Counting(_toy_specs()), cache=cache, name="lru")
    reqs = [InvocationRequest(component="a", unrolls=u, ports=1)
            for u in (1, 2, 4)]
    try:
        for r in reqs:
            shared.evaluate(r)
        assert len(calls) == 3 and cache.stats()["evictions"] == 1
        shared.evaluate(reqs[1])
        shared.evaluate(reqs[2])
        assert len(calls) == 3 and shared.hits == 2
        shared.evaluate(reqs[0])
        assert len(calls) == 4
        shared.evaluate(reqs[0])
        assert len(calls) == 4
        stats = cache.stats()
        assert stats["entries"] == 2 and stats["evictions"] == 2
        assert stats["hits"] == 3 and stats["misses"] >= 4
    finally:
        shared.close()


def test_lru_eviction_keeps_tenant_ledgers_consistent():
    shared = SharedOracle(HLSTool(_toy_specs()),
                          cache=PersistentOracleCache(max_entries=1),
                          name="tiny")
    t1, t2 = OracleLedger(shared), OracleLedger(shared)
    r1 = InvocationRequest(component="a", unrolls=1, ports=1)
    r2 = InvocationRequest(component="a", unrolls=2, ports=1)
    try:
        t1.evaluate(r1)
        t1.evaluate(r2)              # evicts r1 from the shared cache
        t1.evaluate(r1)              # tenant repeat: own cache, no count
        assert t1.total("a") == 2 and shared.total("a") == 2
        t2.evaluate(r1)              # new tenant, evicted key: re-pays
        assert t2.total("a") == 1 and shared.total("a") == 3
    finally:
        shared.close()


def test_persistent_lru_bound_survives_reload(tmp_path):
    root = str(tmp_path / "cache")
    cache = PersistentOracleCache(root, max_entries=2, flush_every=1)
    shared = SharedOracle(HLSTool(_toy_specs()), cache=cache)
    reqs = [InvocationRequest(component="a", unrolls=u, ports=1)
            for u in (1, 2, 4)]
    try:
        for r in reqs:
            shared.evaluate(r)
    finally:
        shared.close()
    fresh = PersistentOracleCache(root, max_entries=2)
    assert fresh.stats()["entries"] == 2
    assert fresh.get(reqs[0].key) is None
    assert fresh.get(reqs[1].key) is not None
    assert fresh.get(reqs[2].key) is not None
    with pytest.raises(ValueError, match="max_entries"):
        PersistentOracleCache(max_entries=0)


def test_shared_pool_cache_replays_across_a_restart(tmp_path):
    """A pool's durable cache, reopened, serves every point as a
    ``replay`` exactly once, then as plain cache hits."""
    root = str(tmp_path / "svc")
    q = DSEQuery(app="svc-toy-a", tenant="first")
    with DSEService(cache_root=root, flush_every=1) as svc:
        svc.submit(q).result(timeout=TIMEOUT)
    with DSEService(cache_root=root) as svc:
        h = svc.submit(dataclasses.replace(q, tenant="second"))
        h.result(timeout=TIMEOUT)
        pool = svc.stats()["pools"]["svc-toy-a-analytical"]
    assert pool["invocations"] == 0
    assert pool["outcomes"]["replay"] == h.ledger.total() > 0


# ----------------------------------------------------------------------
# (5) backpressure: bounded queue, callers block or get Busy
# ----------------------------------------------------------------------
def test_backpressure_busy_and_unblock():
    svc = DSEService(max_pending=1, workers=1)
    try:
        running = svc.submit(DSEQuery(app="svc-toy-gated", tenant="slow"))
        _wait_running(running)
        queued = svc.submit(DSEQuery(app="svc-toy-a", tenant="q"))
        assert not isinstance(queued, Busy)
        busy = svc.submit(DSEQuery(app="svc-toy-a", tenant="rejected"),
                          block=False)
        assert isinstance(busy, Busy) and "queue full" in busy.reason
        busy2 = svc.submit(DSEQuery(app="svc-toy-a", tenant="timed-out"),
                           timeout=0.05)
        assert isinstance(busy2, Busy) and "timed out" in busy2.reason
        _GatedTool.gate.set()
        assert running.result(timeout=TIMEOUT) is not None
        assert queued.result(timeout=TIMEOUT) is not None
        assert svc.stats()["queries"]["rejected_busy"] == 2
    finally:
        _GatedTool.gate.set()
        svc.close()


def test_blocking_submit_waits_out_the_backpressure():
    svc = DSEService(max_pending=1, workers=1)
    try:
        running = svc.submit(DSEQuery(app="svc-toy-gated", tenant="slow"))
        _wait_running(running)
        queued = svc.submit(DSEQuery(app="svc-toy-a", tenant="q1"))
        got = []

        def blocked_submit():
            got.append(svc.submit(DSEQuery(app="svc-toy-a", tenant="q2")))

        t = threading.Thread(target=blocked_submit)
        t.start()
        t.join(timeout=0.1)
        assert t.is_alive()          # genuinely blocked on the full queue
        _GatedTool.gate.set()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        assert not isinstance(got[0], Busy)
        assert got[0].result(timeout=TIMEOUT) is not None
        assert queued.result(timeout=TIMEOUT) is not None
    finally:
        _GatedTool.gate.set()
        svc.close()


# ----------------------------------------------------------------------
# (6) submission-time validation + lifecycle
# ----------------------------------------------------------------------
def test_unknown_names_raise_at_submit_not_in_the_worker():
    with DSEService(max_pending=2, workers=1) as svc:
        with pytest.raises(KeyError, match="unknown app"):
            svc.submit(DSEQuery(app="no-such-app"))
        with pytest.raises(KeyError, match="unknown backend"):
            svc.submit(DSEQuery(app="svc-toy-a", backend="verilog"))
        assert svc.stats()["queries"]["submitted"] == 0
    with pytest.raises(ValueError, match="max_pending"):
        DSEService(max_pending=0)


def test_close_without_drain_fails_queued_handles():
    svc = DSEService(max_pending=4, workers=1)
    try:
        running = svc.submit(DSEQuery(app="svc-toy-gated", tenant="slow"))
        _wait_running(running)
        abandoned = svc.submit(DSEQuery(app="svc-toy-a", tenant="late"))
    finally:
        _GatedTool.gate.set()
        svc.close(drain=False)
    with pytest.raises(RuntimeError, match="closed before"):
        abandoned.result(timeout=5)
    assert abandoned.status == "failed"
    assert running.result(timeout=5) is not None
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(DSEQuery(app="svc-toy-a"))


def test_result_timeout_raises_timeouterror():
    svc = DSEService(max_pending=2, workers=1)
    try:
        h = svc.submit(DSEQuery(app="svc-toy-gated", tenant="slow"))
        with pytest.raises(TimeoutError):
            h.result(timeout=0.05)
        assert not h.wait(timeout=0.01)
    finally:
        _GatedTool.gate.set()
        svc.close()


# ----------------------------------------------------------------------
# Part 0: one measurement lock per device, across oracles
# ----------------------------------------------------------------------
def test_two_oracles_never_time_at_the_same_moment():
    """Four measure-mode oracles on one device, driven from four
    threads: a timer that records its own entry and exit shows no two
    timings overlap (each holds the device's one lock)."""
    spans, active, most = [], [0], [0]
    guard = threading.Lock()

    def timer(name, ports, unrolls, runner):
        with guard:
            active[0] += 1
            most[0] = max(most[0], active[0])
            t0 = time.monotonic()
        time.sleep(0.002)
        with guard:
            active[0] -= 1
            spans.append((t0, time.monotonic()))
        return 1e-6 * (1 + ports) / unrolls

    specs = wami_cuda_components(device="cpu")
    oracles = [CudaOracle(specs, device="cpu", device_kind="interpret",
                          smem_budget=SMEM_16MIB, timer=timer)
               for _ in range(4)]
    assert all(o._measure_lock is oracles[0]._measure_lock
               for o in oracles)
    points = [(p, u) for p in (1, 2, 4) for u in (1, 2, 4, 8)]

    def drive(oracle):
        for p, u in points:
            oracle.synthesize("grayscale", ports=p, unrolls=u)

    threads = [threading.Thread(target=drive, args=(o,)) for o in oracles]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(spans) == len(oracles) * len(points) and most[0] == 1
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    replay = CudaOracle(specs, mode="replay", device="cpu",
                        device_kind="interpret", smem_budget=SMEM_16MIB,
                        measurements=_wami_interpret_set())
    assert replay._measure_lock is None          # replay never times


def _wami_interpret_set():
    from repro_torch.core import MeasurementSet, MeasurementStore
    return MeasurementSet.from_store(MeasurementStore.load(os.path.join(
        MEASUREMENTS, "wami_pallas_tile128.json")), tile=128)


# ----------------------------------------------------------------------
# (7) acceptance: 4 tenants over 2 apps x 2 backends, against the JAX
#     package's service with its pallas backend
# ----------------------------------------------------------------------
def test_acceptance_matches_the_reference_service():
    spec = [("wami", "analytical", None, False, "t0"),
            ("wami", "analytical", 0.5, False, "t1"),
            ("wami", "cuda-interpret", None, True, "t2"),
            ("fleet", "analytical", None, False, "t3")]
    queries = [DSEQuery(app=a, backend=b, delta=d, share_plm=s, tenant=t)
               for a, b, d, s, t in spec]
    ref_queries = [RefQuery(app=a, backend="pallas" if b != "analytical"
                            else b, delta=d, share_plm=s, tenant=t)
                   for a, b, d, s, t in spec]
    iso = {q.tenant: _isolated(q) for q in queries}
    with DSEService(max_pending=8, workers=3) as svc:
        handles = svc.submit_all(queries)
        results = {h.query.tenant: h.result(timeout=300) for h in handles}
        stats = svc.stats()
    with RefService(max_pending=8, workers=3) as ref_svc:
        ref_handles = ref_svc.submit_all(ref_queries)
        ref_results = {h.query.tenant: h.result(timeout=300)
                       for h in ref_handles}
        ref_stats = ref_svc.stats()
    ref_inv = {h.query.tenant: h.invocations() for h in ref_handles}
    for h in handles:
        t = h.query.tenant
        assert _front(results[t]) == _front(iso[t][0]), t
        assert h.invocations() == iso[t][1], t
        if t != "t3":       # the fleet prices the H100 table, not a TPU
            assert _front(results[t]) == _front(ref_results[t]), t
            assert h.invocations() == ref_inv[t], t
    iso_ref_t3 = ref_build_query(ref_queries[3])
    iso_ref_t3.run()
    assert iso["t3"][1] == dict(iso_ref_t3.ledger.invocations)
    tenant_sum = sum(sum(inv.values()) for _, inv in iso.values())
    assert stats["shared_invocations"] < tenant_sum
    assert stats["shared_invocations"] == ref_stats["shared_invocations"]
    assert len(stats["pools"]) == len(ref_stats["pools"]) == 3
    assert stats["tenant_invocations"] == ref_stats["tenant_invocations"]
