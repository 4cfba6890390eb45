"""COSMOS planning for LLM training (beyond-paper): knob ladders priced
analytically on the chip table.

For each train cell the planner walks the Algorithm-1-style knob ladder
(microbatches x remat) and prices device memory per GPU against the
chip table (:data:`CHIP`, an H100 SXM's 80 GB); the chosen rung is the
one the dry run traces (one trace instead of a ladder of them — the
paper's invocation-frugality argument on the graph oracle).

The second pseudo-cell (``service/soak``) is the multi-tenant DSE
service soak: N tenants over >= 2 apps x 2 backends driven concurrently
through :class:`repro_torch.serve.DSEService` with ``workers > 1`` at
both the service and session level, gated on byte-equality of every
tenant's front against its isolated sequential run AND on the shared
ledger pricing strictly fewer real invocations than the tenants' sum.
Its ``cuda`` tenant replays the card's recordings.  It writes
``BENCH_serve.json`` beside its CSV (queries/sec, coalescing hit rate,
invocation counts).  ``DSE_SOAK_TENANTS=2`` shrinks it to the cheap
two-tenant load.

The third (``service/trace``) is the deterministic logical-clock trace:
a two-tenant service run whose Chrome ``trace_event`` export is
byte-identical across runs and machines.
"""
from __future__ import annotations

import json
import os
import time

from ..configs import SHAPES, get_config, list_archs
from ..core.autotune import XLAOracle, choose_train_knobs
from ..core.chips import H100_SXM
from ..core.oracle import OracleLedger

MESH = {"data": 16, "model": 16}
#: the chip table the zoo planner prices against, and its budget
CHIP = H100_SXM

# fixed pseudo-cells: the zoo planner walks the LLM config zoo through
# the analytical autotune pricing (no registered App's TMG), the
# service soak drives registered apps through the DSE service, and the
# service trace commits the deterministic logical-clock trace artifact
SCENARIOS = {"pairs": (("zoo", "analytical"), ("service", "soak"),
                       ("service", "trace"))}


def _soak_queries(tenants):
    """The soak tenant mix, overlap-first: the first two tenants share
    one oracle pool (characterization is delta-independent, so the
    two-tenant soak already exercises coalescing + the shared
    cache); four tenants cover 2 apps x 2 backends."""
    from ..core import DSEQuery
    from ..core.registry import get_app, get_backend
    base = [
        DSEQuery(app="wami", backend="analytical", workers=2, tenant="t0"),
        DSEQuery(app="wami", backend="analytical", delta=0.5, tenant="t1"),
        DSEQuery(app="wami", backend="cuda", share_plm=True,
                 workers=2, tenant="t2"),
        DSEQuery(app="fleet", backend="analytical", tenant="t3"),
    ]
    picked, dropped = [], []
    for q in base[:max(2, tenants)]:
        reason = get_backend(q.backend).skip_reason(get_app(q.app))
        (dropped if reason else picked).append((q, reason))
    return [q for q, _ in picked], [(q, r) for q, r in dropped]


def _run_soak(report, cell, device=None) -> None:
    from ..core.registry import build_query_session
    from ..serve import DSEService

    tenants = int(os.environ.get("DSE_SOAK_TENANTS", "4"))
    queries, dropped = _soak_queries(tenants)
    # the measured tenant replays the card's recordings (its kernel
    # specs' tensors on ``device``); analytical tools take no options
    replay = {"mode": "replay", "device": device}

    # isolated sequential references: per-tenant front + attribution
    iso = {}
    for q in queries:
        s = build_query_session(q, **replay)
        iso[q.tenant] = (s.run(), dict(s.ledger.invocations))

    t0 = time.time()
    with DSEService(max_pending=len(queries), workers=3,
                    tool_options=replay) as svc:
        handles = svc.submit_all(queries)
        results = {h.query.tenant: h.result(timeout=600) for h in handles}
        stats = svc.stats()
    wall_s = time.time() - t0

    lines = [f"# DSE-service soak: {len(queries)} concurrent tenants "
             f"vs isolated sequential runs",
             "tenant,app,backend,share_plm,delta,invocations,"
             "front_identical,attribution_identical"]
    for h in handles:
        q = h.query
        ref, ref_inv = iso[q.tenant]
        res = results[q.tenant]
        front_ok = (repr(res.planned) == repr(ref.planned)
                    and repr(res.mapped) == repr(ref.mapped))
        inv_ok = h.invocations() == ref_inv
        lines.append(f"{q.tenant},{q.app},{q.backend},{q.share_plm},"
                     f"{q.delta},{sum(ref_inv.values())},"
                     f"{'Y' if front_ok else 'N'},"
                     f"{'Y' if inv_ok else 'N'}")
        # the gates: concurrency must be invisible per tenant
        assert front_ok, (f"tenant {q.tenant} ({q.app}/{q.backend}): "
                          f"concurrent front differs from isolated run")
        assert inv_ok, (f"tenant {q.tenant}: ledger attribution differs "
                        f"from isolated run")
    for q, reason in dropped:
        lines.append(f"# dropped {q.tenant} ({q.app}/{q.backend}): {reason}")

    tenant_sum = sum(sum(inv.values()) for _, inv in iso.values())
    shared = stats["shared_invocations"]
    # ...while the shared ledger prices strictly fewer real calls
    assert shared < tenant_sum, (
        f"no cross-tenant dedup: shared ledger {shared} >= "
        f"tenant sum {tenant_sum}")
    hits = sum(p["hits"] for p in stats["pools"].values())
    joins = sum(p["joins"] for p in stats["pools"].values())
    hit_rate = (hits + joins) / tenant_sum if tenant_sum else 0.0
    lines.append(f"# shared ledger: {shared} real invocations for "
                 f"{tenant_sum} attributed ({tenant_sum - shared} saved; "
                 f"{hits} cache hits + {joins} in-flight joins)")
    report.write("dse_service_soak", lines)
    report.csv("dse_service_soak", wall_s * 1e6,
               f"tenants={len(queries)}_saved="
               f"{tenant_sum - shared}of{tenant_sum}")

    # the service's numbers (version 2: with the per-pool outcome
    # partition and the service-level queue-wait / latency histograms
    # from the metrics registry)
    metrics = stats["metrics"]
    path = os.path.join(report.out_dir, "BENCH_serve.json")
    doc = {"version": 2, "bench": "dse-service soak",
           "generated_by": "python -m repro_torch.bench.run --cell "
                           "autoshard/service-soak",
           "tenants": len(queries),
           "queries_per_sec": round(len(queries) / wall_s, 3),
           "wall_s": round(wall_s, 3),
           "coalescing_hit_rate": round(hit_rate, 4),
           "cache_hits": hits,
           "inflight_joins": joins,
           "tenant_invocations": tenant_sum,
           "shared_invocations": shared,
           "saved_invocations": tenant_sum - shared,
           "queue_wait_s": metrics["service.queue_wait_s"],
           "latency_s": metrics["service.latency_s"],
           "pools": {slug: {"invocations": p["invocations"],
                            "hits": p["hits"], "joins": p["joins"],
                            "batches": p["batches"],
                            "tenants": p["tenants"],
                            "outcomes": p["outcomes"]}
                     for slug, p in sorted(stats["pools"].items())}}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def _run_trace(report, cell) -> None:
    """The observability artifact: a two-tenant service run
    driven strictly sequentially under a :class:`LogicalClock`, so the
    Chrome ``trace_event`` export is byte-identical across runs and
    machines (two fresh runs compare equal byte for byte).

    A second service instance reuses the first one's persistent cache
    root so every outcome tag in the partition appears: ``fresh`` and
    ``cache_hit`` in pass 1, ``replay`` in pass 2 (``inflight_join``
    needs concurrent submitters and stays 0 here by construction —
    determinism requires the sequential drive; the soak cell covers
    joins).  Before exporting, the run re-proves the Fig. 11
    reconciliation invariants.
    """
    import shutil
    import tempfile

    from ..core import DSEQuery
    from ..core.obs import (LogicalClock, MetricsRegistry, Tracer,
                            validate_chrome)
    from ..serve import DSEService

    queries = [
        DSEQuery(app="wami", backend="analytical", tenant="alpha"),
        DSEQuery(app="wami", backend="analytical", delta=0.5, tenant="beta"),
    ]
    tracer = Tracer(clock=LogicalClock())
    cache_root = tempfile.mkdtemp(prefix="dse-trace-")
    ledgers = {}
    try:
        # pass 1 (cold cache): fresh + cache_hit outcomes.  flush_every=1
        # so pass 2 sees every entry on disk while svc stays open — its
        # worker threads stay alive, which keeps thread idents (and so
        # the tracer's tid assignment) from being reused by svc2.
        with DSEService(max_pending=4, workers=1, cache_root=cache_root,
                        flush_every=1, tracer=tracer,
                        metrics=MetricsRegistry()) as svc:
            for q in queries:
                h = svc.submit(q)
                h.result(timeout=600)       # sequential: determinism
                ledgers[q.tenant] = h.outcome_counts()
            stats1 = svc.stats()
            # pass 2 (warm persistent cache, new instance): replay
            with DSEService(max_pending=4, workers=1,
                            cache_root=cache_root, tracer=tracer,
                            metrics=MetricsRegistry()) as svc2:
                h = svc2.submit(DSEQuery(app="wami", backend="analytical",
                                         tenant="alpha2"))
                h.result(timeout=600)
                ledgers["alpha2"] = h.outcome_counts()
                stats2 = svc2.stats()

        # --- Fig. 11 reconciliation gates ---------------------------
        # per-tenant: the four outcomes partition all evaluated points,
        # and fresh+replay is exactly the ledger's real-invocation total
        point_counts = tracer.outcome_counts("oracle.point")
        tenant_total = {t: sum(c.values()) for t, c in ledgers.items()}
        agg = {}
        for counts in ledgers.values():
            for o, n in counts.items():
                agg[o] = agg.get(o, 0) + n
        assert {o: n for o, n in agg.items() if n} == point_counts, (
            f"ledger outcome counters {agg} != traced oracle.point "
            f"outcomes {point_counts}")
        assert agg.get("cache_hit", 0) > 0, "no cache_hit points"
        assert agg.get("inflight_join", 0) == 0, (
            "sequential drive cannot join flights")

        # shared level: every tenant-fresh point reaches the shared
        # oracle exactly once, and the shared fresh count is the real
        # tool-invocation total
        shared_counts = tracer.outcome_counts("shared.point")
        pool_outcomes = {}
        for stats in (stats1, stats2):
            for p in stats["pools"].values():
                for o, n in p["outcomes"].items():
                    pool_outcomes[o] = pool_outcomes.get(o, 0) + n
        pool_outcomes = {o: n for o, n in sorted(pool_outcomes.items()) if n}
        assert pool_outcomes == shared_counts, (
            f"pool outcome counters {pool_outcomes} != traced "
            f"shared.point outcomes {shared_counts}")
        # the tenant ledgers hold no persistent cache, so ``replay``
        # appears exactly where the restored entries live: the shared
        # pool cache that pass 2 rehydrated from disk
        assert shared_counts.get("replay", 0) > 0, (
            "pass 2 produced no replay points at the shared level")
        assert sum(shared_counts.values()) == agg["fresh"], (
            f"shared.point total {sum(shared_counts.values())} != "
            f"tenant fresh sum {agg['fresh']}")
        shared_real = (stats1["shared_invocations"]
                       + stats2["shared_invocations"])
        assert shared_counts.get("fresh", 0) == shared_real, (
            f"shared fresh {shared_counts.get('fresh', 0)} != shared "
            f"ledger total {shared_real}")

        doc = tracer.export_chrome()
        problems = validate_chrome(doc)
        assert not problems, f"invalid trace_event export: {problems[:5]}"
        report.write_json("service_trace", doc, kind="trace")

        lines = [f"# deterministic service trace: {len(ledgers)} queries, "
                 f"{len(doc['traceEvents'])} events (logical clock)",
                 "tenant,fresh,cache_hit,inflight_join,replay,total"]
        for tenant, counts in sorted(ledgers.items()):
            lines.append(f"{tenant},{counts.get('fresh', 0)},"
                         f"{counts.get('cache_hit', 0)},"
                         f"{counts.get('inflight_join', 0)},"
                         f"{counts.get('replay', 0)},{tenant_total[tenant]}")
        lines.append(f"# shared pool outcomes: {pool_outcomes} "
                     f"({shared_real} real tool invocations)")
        report.write("service_trace", lines)
        report.csv("service_trace", float(len(doc["traceEvents"])),
                   f"events_outcomes=f{agg.get('fresh', 0)}"
                   f"_c{agg.get('cache_hit', 0)}"
                   f"_r{shared_counts.get('replay', 0)}")
    finally:
        shutil.rmtree(cache_root, ignore_errors=True)


def run(report, cell, *, device=None) -> None:
    if cell.app == "service":
        if cell.backend == "trace":
            _run_trace(report, cell)
        else:
            _run_soak(report, cell, device)
        return
    _run_zoo(report, cell)


def _run_zoo(report, cell) -> None:
    t0 = time.time()
    shape = SHAPES[0]           # train_4k
    lines = [f"# COSMOS planner: train_4k knob choice per arch "
             f"(256-GPU pod, {CHIP.name}, "
             f"{CHIP.hbm_bytes / 1e9:g} GB budget)",
             "arch,microbatches,remat,accum,planned_gb,fits,ladder_rungs_priced"]
    n_fit = 0
    for arch in list_archs():
        cfg = get_config(arch)
        # price the whole ladder for visibility
        rungs = 0
        for mb in (1, 2, 4, 8, 16, 32, 64):
            if shape.global_batch // 16 < mb:
                break
            rungs += 1
        plan = choose_train_knobs(cfg, shape, MESH, ledger=OracleLedger(
            XLAOracle(chip=CHIP)))
        fits = plan.est_bytes <= CHIP.hbm_bytes
        n_fit += fits
        lines.append(f"{arch},{plan.microbatches},{plan.remat},"
                     f"{plan.accum_dtype},{plan.est_bytes / 1e9:.1f},"
                     f"{'Y' if fits else 'N'},{rungs}")
    lines.append("# an exhaustive trace sweep would cost "
                 "(7 mb x 3 remat) = 21 traces/arch; the planner "
                 "traces 1 (21x fewer oracle invocations, the Fig. 11 "
                 "argument on the graph oracle)")
    report.write("autoshard_llm", lines)
    report.csv("autoshard_planner", (time.time() - t0) * 1e6,
               f"fit={n_fit}/{len(list_archs())}_archs")
