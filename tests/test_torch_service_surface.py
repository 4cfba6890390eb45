"""The four keywords the port's service surface had dropped, restored
and held against the JAX package's on the same inputs:
``DSEService(cache_entries=, verify_plans=, metrics=)`` and
``PersistentOracleCache(keep=)``."""

import pytest

from repro.core import DSEQuery as RefQuery
from repro.core.obs import MetricsRegistry as RefMetrics
from repro.core.oracle import InvocationRequest as RefRequest
from repro.core.oracle import PersistentOracleCache as RefCache
from repro.core.hlsim import ComponentSpec as RefSpec
from repro.core.hlsim import HLSTool as RefTool
from repro.core.hlsim import LoopNest as RefNest
from repro.checkpoint import store as ref_store
from repro.serve import DSEService as RefService

import repro_torch.serve.dse_service as T_service
from repro_torch.checkpoint import store
from repro_torch.core import DSEQuery
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest
from repro_torch.core.obs import MetricsRegistry
from repro_torch.core.oracle import InvocationRequest, PersistentOracleCache
from repro_torch.serve import DSEService

TIMEOUT = 300
TENANTS = [("wami", None, "t0"), ("wami", 0.5, "t1"), ("fleet", None, "t2")]


def _front(result):
    return repr(result.planned), repr(result.mapped)


def _run(service_cls, query_cls, **kw):
    queries = [query_cls(app=a, backend="analytical", delta=d, tenant=t)
               for a, d, t in TENANTS]
    # one worker: the tenants run in turn, so LRU traffic is deterministic
    with service_cls(max_pending=8, workers=1, **kw) as svc:
        handles = svc.submit_all(queries)
        fronts = {h.query.tenant: _front(h.result(timeout=TIMEOUT))
                  for h in handles}
        inv = {h.query.tenant: h.invocations() for h in handles}
        stats = svc.stats()
    return fronts, inv, stats, svc


def test_cache_entries_bounds_each_pool_like_the_reference():
    fronts, inv, stats, _ = _run(DSEService, DSEQuery, cache_entries=4)
    r_fronts, r_inv, r_stats, _ = _run(RefService, RefQuery, cache_entries=4)
    assert fronts["t0"] == r_fronts["t0"] and fronts["t1"] == r_fronts["t1"]
    assert inv["t0"] == r_inv["t0"] and inv["t1"] == r_inv["t1"]
    pools = {k: v for k, v in stats["pools"].items() if "wami" in k}
    r_pools = {k: v for k, v in r_stats["pools"].items() if "wami" in k}
    assert pools.keys() == r_pools.keys()
    for slug, pool in pools.items():
        assert pool["cache"]["entries"] <= 4
        assert pool["cache"] == r_pools[slug]["cache"], slug
        assert pool["invocations"] == r_pools[slug]["invocations"], slug
    # unbounded, the same tenants evict nothing and price less
    _, _, free, _ = _run(DSEService, DSEQuery)
    for slug, pool in pools.items():
        assert free["pools"][slug]["cache"]["evictions"] == 0
        assert pool["cache"]["evictions"] > 0
        assert free["pools"][slug]["invocations"] < pool["invocations"]


def test_verify_plans_reaches_every_tenant_session(monkeypatch):
    seen = []
    real = T_service.build_query_session

    def spy(query, **kw):
        session = real(query, **kw)
        seen.append(session.verify_plans)
        return session

    monkeypatch.setattr(T_service, "build_query_session", spy)
    fronts, inv, _, _ = _run(DSEService, DSEQuery, verify_plans=True)
    r_fronts, r_inv, _, _ = _run(RefService, RefQuery, verify_plans=True)
    assert seen == [True] * len(TENANTS)
    for t in ("t0", "t1"):
        assert fronts[t] == r_fronts[t] and inv[t] == r_inv[t], t
    seen.clear()
    _run(DSEService, DSEQuery)
    assert seen == [False] * len(TENANTS)


def test_given_metrics_registry_is_the_one_stats_embeds():
    reg, r_reg = MetricsRegistry(), RefMetrics()
    _, _, stats, svc = _run(DSEService, DSEQuery, metrics=reg)
    _, _, r_stats, r_svc = _run(RefService, RefQuery, metrics=r_reg)
    assert svc.metrics is reg and r_svc.metrics is r_reg
    assert stats["metrics"] == reg.snapshot()
    snap, r_snap = reg.snapshot(), r_reg.snapshot()
    assert snap.keys() == r_snap.keys()
    assert snap["service.done"] == r_snap["service.done"] == len(TENANTS)
    for name, value in snap.items():
        if name.startswith(("service.", "cache.")) and isinstance(value, int):
            assert value == r_snap[name], name
    # without one, each service counts into a registry of its own
    _, _, _, a = _run(DSEService, DSEQuery)
    _, _, _, b = _run(DSEService, DSEQuery)
    assert a.metrics is not b.metrics


def _specs(spec, nest):
    return {"a": spec("a", nest(256, 2, 1, 8, 3, 6), 1024, 1024)}


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_keep_is_the_steps_a_flush_leaves_like_the_reference(tmp_path, keep):
    port = PersistentOracleCache(str(tmp_path / "port"), flush_every=1,
                                 keep=keep)
    ref = RefCache(str(tmp_path / "ref"), flush_every=1, keep=keep)
    tool, r_tool = (HLSTool(_specs(ComponentSpec, LoopNest)),
                    RefTool(_specs(RefSpec, RefNest)))
    for u in (1, 2, 4, 8, 16):
        req, r_req = (InvocationRequest(component="a", unrolls=u, ports=1),
                      RefRequest(component="a", unrolls=u, ports=1))
        port.put(req.key, tool.evaluate(req))
        ref.put(r_req.key, r_tool.evaluate(r_req))
        assert len(store.list_steps(port.root)) == \
            len(ref_store.list_steps(ref.root)) == min(u.bit_length(), keep)
    assert port.keep == ref.keep == keep
    fresh = PersistentOracleCache(port.root)
    assert fresh.stats()["entries"] == 5
    assert PersistentOracleCache(keep=0).keep == RefCache(keep=0).keep == 1
