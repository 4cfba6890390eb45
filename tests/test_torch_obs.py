"""Observability of the PyTorch package: tracer and metrics units, the
trace schema, and span-for-span agreement with the JAX package.

  * a ``LogicalClock`` analytical drive with ``workers=1`` exports the
    same span JSONL as the JAX package's — names, nesting, attributes
    and ticks, byte for byte — on a toy system and on WAMI with the PLM
    planner (``plm.plan_point`` spans);
  * every evaluated point carries one outcome from
    ``fresh | cache_hit | inflight_join | replay``, and the traced tags
    reconcile with the ledger's totals;
  * the metrics registry is lock-consistent and create-on-first-use,
    and its snapshot matches the JAX package's on the same operations.
"""

import json
import subprocess
import sys
import threading

import pytest

from repro.core import ExplorationSession as RefSession
from repro.core import HLSTool as RefHLSTool
from repro.core import KnobSpace as RefKnobSpace
from repro.core import LogicalClock as RefLogicalClock
from repro.core import MetricsRegistry as RefRegistry
from repro.core import Tracer as RefTracer
from repro.core import build_session as ref_build_session
from repro.core import pipeline_tmg as ref_pipeline_tmg
from repro.core.hlsim import ComponentSpec as RefSpec
from repro.core.hlsim import LoopNest as RefLoopNest
from repro_torch.core import (DSEQuery, ExplorationSession, HLSTool,
                              KnobSpace, LogicalClock, MetricsRegistry,
                              NULL_TRACER, OracleLedger,
                              PersistentOracleCache, SharedOracle, Tracer,
                              build_session, pipeline_tmg)
from repro_torch.core.hlsim import ComponentSpec, LoopNest
from repro_torch.core.obs import OUTCOMES, validate_chrome, validate_jsonl
from repro_torch.core.oracle import InvocationRequest
from repro_torch.core.registry import _APPS, App, register_app
from repro_torch.serve import DSEService

_LOOPS = {"a": ((256, 2, 1, 8, 3, 6), 1024, 1024),
          "b": ((128, 1, 1, 4, 2, 4), 512, 512)}


def _system(ref=False):
    spec, loop_nest = (RefSpec, RefLoopNest) if ref else \
        (ComponentSpec, LoopNest)
    knob_space = RefKnobSpace if ref else KnobSpace
    tmg_of = ref_pipeline_tmg if ref else pipeline_tmg
    specs = {n: spec(n, loop_nest(*loop), w_in, w_out)
             for n, (loop, w_in, w_out) in _LOOPS.items()}
    tmg = tmg_of(list(specs), buffers=2)
    spaces = {n: knob_space(clock_ns=1.0, max_ports=4, max_unrolls=8)
              for n in specs}
    return specs, tmg, spaces


def _traced_run(tracer=None, ref=False):
    specs, tmg, spaces = _system(ref)
    if ref:
        tracer = tracer or RefTracer(clock=RefLogicalClock())
        s = RefSession(tmg, RefHLSTool(dict(specs)), spaces, delta=0.3,
                       tracer=tracer)
    else:
        tracer = tracer or Tracer(clock=LogicalClock())
        s = ExplorationSession(tmg, HLSTool(dict(specs)), spaces,
                               delta=0.3, tracer=tracer)
    s.run()
    return s, tracer


# ----------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------
@pytest.mark.parametrize("registry", [MetricsRegistry, RefRegistry],
                         ids=["port", "reference"])
def test_counter_gauge_histogram_basics(registry):
    snaps = []
    for make in (registry, MetricsRegistry):
        reg = make()
        c = reg.counter("n")
        c.inc()
        c.inc(4)
        assert c.value == 5
        g = reg.gauge("depth")
        g.set(3)
        g.add(-1)
        assert g.value == 2
        h = reg.histogram("lat", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        snaps.append(reg.snapshot())
    snap = snaps[1]
    assert snaps[0] == snap
    assert snap["n"] == 5 and snap["depth"] == 2
    assert snap["lat"]["count"] == 3
    assert snap["lat"]["buckets"] == {"le_0.1": 1, "le_1": 1, "le_inf": 1}
    assert snap["lat"]["sum"] == pytest.approx(5.55)


def test_registry_create_on_first_use_and_conflicts():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    reg.histogram("h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=(1.0, 3.0))


def test_counter_thread_consistency():
    c = MetricsRegistry().counter("hits")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(500)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 4000


# ----------------------------------------------------------------------
# tracer units
# ----------------------------------------------------------------------
def test_span_nesting_follows_with_stack():
    tr = Tracer(clock=LogicalClock())
    with tr.span("outer") as outer:
        with tr.span("inner") as inner:
            assert tr.current() is inner
        assert tr.current() is outer
    assert tr.current() is None
    [i] = tr.spans("inner")
    assert i.parent_id == outer.span_id


def test_span_error_status_recorded_and_not_swallowed():
    tr = Tracer(clock=LogicalClock())
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("seeded")
    [sp] = tr.spans("boom")
    assert sp.status == "error" and "seeded" in sp.error


def test_null_tracer_is_inert():
    with NULL_TRACER.span("anything", k=1) as sp:
        sp.set("more", 2)
    NULL_TRACER.instant("evt")
    assert NULL_TRACER.spans() == [] and NULL_TRACER.outcome_counts() == {}


def test_exports_are_valid_and_schema_checked():
    _, tr = _traced_run()
    assert validate_jsonl(tr.export_jsonl()) == []
    doc = tr.export_chrome()
    assert doc["displayTimeUnit"] == "ms"
    assert validate_chrome(doc) == []
    assert validate_chrome(json.loads(json.dumps(doc))) == []


def test_schema_rejects_bad_documents():
    assert validate_chrome({"traceEvents": "nope"})
    bad = {"displayTimeUnit": "ms",
           "traceEvents": [{"name": "x", "cat": "x", "ph": "X", "pid": 1,
                            "tid": 0, "ts": 1.0, "args": {}}]}
    assert validate_chrome(bad)
    bad = {"displayTimeUnit": "ms",
           "traceEvents": [{"name": "oracle.point", "cat": "oracle",
                            "ph": "X", "pid": 1, "tid": 0, "ts": 1.0,
                            "dur": 1.0, "args": {}}]}
    assert validate_chrome(bad)
    assert validate_jsonl("not json\n")


def test_schema_command_line(tmp_path):
    """``python -m repro_torch.core.obs.schema`` exits 0 on valid exports
    and 1 on a bad one, and the JAX package's validator agrees."""
    from repro.core.obs import validate_chrome as ref_validate
    _, tr = _traced_run()
    good = tmp_path / "run.trace.json"
    good.write_text(json.dumps(tr.export_chrome()))
    lines = tmp_path / "run.jsonl"
    lines.write_text(tr.export_jsonl())
    bad = tmp_path / "bad.trace.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    cmd = [sys.executable, "-m", "repro_torch.core.obs.schema"]
    ok = subprocess.run(cmd + [str(good), str(lines)], capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    no = subprocess.run(cmd + [str(bad)], capture_output=True, text=True,
                        timeout=120)
    assert no.returncode == 1 and "FAIL" in no.stderr
    assert ref_validate(tr.export_chrome()) == []


# ----------------------------------------------------------------------
# span-for-span agreement with the JAX package
# ----------------------------------------------------------------------
def test_toy_drive_exports_the_reference_s_spans():
    _, tr = _traced_run()
    _, ref = _traced_run(ref=True)
    assert tr.export_jsonl() == ref.export_jsonl()


@pytest.mark.parametrize("share_plm", [False, True])
def test_wami_drive_exports_the_reference_s_spans(share_plm):
    tr, ref = Tracer(clock=LogicalClock()), RefTracer(clock=RefLogicalClock())
    build_session("wami", share_plm=share_plm, tracer=tr).run()
    ref_build_session("wami", share_plm=share_plm, tracer=ref).run()
    assert tr.export_jsonl() == ref.export_jsonl()
    if share_plm:
        assert tr.spans("plm.plan_point")


def test_two_logical_clock_runs_export_identical_bytes():
    _, tr1 = _traced_run()
    _, tr2 = _traced_run()
    assert tr1.export_jsonl() == tr2.export_jsonl()
    assert (json.dumps(tr1.export_chrome(), sort_keys=True)
            == json.dumps(tr2.export_chrome(), sort_keys=True))


# ----------------------------------------------------------------------
# session phases <-> spans
# ----------------------------------------------------------------------
def test_session_spans_mirror_phases():
    s, tr = _traced_run()
    names = {sp.name for sp in tr.spans()}
    assert {"session.characterize", "session.component", "session.plan",
            "session.map", "session.map_point",
            "oracle.point", "tool.point"} <= names
    [char] = tr.spans("session.characterize")
    comps = tr.spans("session.component")
    assert {c.attrs["component"] for c in comps} == {"a", "b"}
    assert all(c.parent_id == char.span_id for c in comps)
    [mapped] = tr.spans("session.map")
    points = tr.spans("session.map_point")
    assert len(points) == len(s.planned)
    assert all(p.parent_id == mapped.span_id for p in points)


def test_progress_instants_match_events():
    specs, tmg, spaces = _system()
    events = []
    tr = Tracer(clock=LogicalClock())
    ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3,
                       on_event=events.append, tracer=tr).run()
    instants = tr.spans("session.progress")
    assert ([(i.attrs["phase"], i.attrs["label"]) for i in instants]
            == [(e.phase, e.label) for e in events])


# ----------------------------------------------------------------------
# outcome partition <-> ledger reconciliation (Fig. 11)
# ----------------------------------------------------------------------
def test_ledger_outcomes_reconcile_with_totals():
    s, tr = _traced_run()
    counts = s.ledger.outcome_counts()
    assert set(counts) == set(OUTCOMES)
    assert counts["fresh"] + counts["replay"] == s.ledger.total()
    assert counts["cache_hit"] > 0
    assert {o: n for o, n in counts.items() if n} == \
        tr.outcome_counts("oracle.point")
    assert sum(counts.values()) == len(tr.spans("oracle.point"))


def test_replay_outcome_from_persistent_restore(tmp_path):
    specs, tmg, spaces = _system()

    def run_once(tracer):
        cache = PersistentOracleCache(str(tmp_path / "c"), flush_every=1)
        ledger = OracleLedger(HLSTool(dict(specs)), cache=cache,
                              tracer=tracer)
        ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3,
                           ledger=ledger).run()
        return ledger

    assert run_once(Tracer(clock=LogicalClock())).outcome_counts()[
        "replay"] == 0
    tr = Tracer(clock=LogicalClock())
    warm = run_once(tr)
    counts = warm.outcome_counts()
    assert counts["fresh"] == 0 and counts["replay"] == warm.total() > 0
    assert tr.outcome_counts("oracle.point") == \
        {o: n for o, n in counts.items() if n}


def test_shared_oracle_outcomes_and_inflight_join():
    specs, _, _ = _system()
    tr = Tracer(clock=LogicalClock())
    gate = threading.Event()

    class SlowTool(HLSTool):
        def synthesize(self, component, **kw):
            gate.wait(timeout=30)
            return super().synthesize(component, **kw)

    shared = SharedOracle(SlowTool(dict(specs)),
                          cache=PersistentOracleCache(None), tracer=tr)
    req = InvocationRequest("a", 2, 2)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(shared.evaluate(req)))
        for _ in range(3)]
    try:
        for t in threads:
            t.start()
        while shared.outcome_counts().get("inflight_join", 0) < 2:
            if not any(t.is_alive() for t in threads):
                break
            gate.wait(0.01)
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=30)
    counts = shared.outcome_counts()
    assert counts["fresh"] == 1 and counts["inflight_join"] == 2
    assert shared.evaluate(req) is not None
    assert shared.outcome_counts()["cache_hit"] == 1
    assert tr.outcome_counts("shared.point") == \
        {o: n for o, n in shared.outcome_counts().items() if n}
    assert len(results) == 3
    shared.close()


# ----------------------------------------------------------------------
# service-level reconciliation
# ----------------------------------------------------------------------
@pytest.fixture
def _toy_app():
    specs, _, _ = _system()
    app = App(
        name="obs-toy",
        description="runnable toy for the observability battery",
        tmg=lambda: pipeline_tmg(["a", "b"], buffers=2),
        knob_spaces=lambda **_: {n: KnobSpace(clock_ns=1.0, max_ports=4,
                                              max_unrolls=8)
                                 for n in ("a", "b")},
        analytical=lambda: HLSTool(dict(specs)),
    )
    register_app(app)
    try:
        yield app
    finally:
        _APPS.pop("obs-toy", None)


def test_service_stats_embed_metrics_and_partition(_toy_app):
    tr = Tracer(clock=LogicalClock())
    with DSEService(max_pending=4, workers=1, tracer=tr) as svc:
        h1 = svc.submit(DSEQuery(app="obs-toy", tenant="t0"))
        h1.result(timeout=120)
        h2 = svc.submit(DSEQuery(app="obs-toy", tenant="t1"))
        h2.result(timeout=120)
        stats = svc.stats()
    m = stats["metrics"]
    assert m["service.submitted"] == 2 and m["service.done"] == 2
    assert m["service.queue_wait_s"]["count"] == 2
    assert m["service.latency_s"]["count"] == 2
    tenant_fresh = sum(h.outcome_counts()["fresh"] for h in (h1, h2))
    pool_outcomes = {}
    for p in stats["pools"].values():
        for o, n in p["outcomes"].items():
            pool_outcomes[o] = pool_outcomes.get(o, 0) + n
    assert sum(pool_outcomes.values()) == tenant_fresh
    assert pool_outcomes["fresh"] == stats["shared_invocations"]
    assert pool_outcomes["cache_hit"] > 0
    assert tr.outcome_counts("shared.point") == \
        {o: n for o, n in pool_outcomes.items() if n}
    svc_q = tr.spans("service.query")
    assert len(svc_q) == 2
    assert all(sp.attrs.get("status") != "failed" for sp in svc_q)
    # the trace's oracle.point outcomes are the tenants' ledgers' sum
    tenant = {}
    for h in (h1, h2):
        for o, n in h.outcome_counts().items():
            tenant[o] = tenant.get(o, 0) + n
    assert tr.outcome_counts() == {o: n for o, n in tenant.items() if n}
    assert validate_chrome(tr.export_chrome()) == []
