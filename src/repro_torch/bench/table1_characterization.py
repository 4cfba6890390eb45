"""Table 1: per-component characterization — COSMOS vs No-Memory spans.

The cell also writes ``BENCH_pricing.json`` beside its CSV: the
vectorized-pricing + frugality numbers (deterministic ledger counts and
front-equality proofs, and the host's pricing throughput)."""

from __future__ import annotations

import json
import os
import statistics
import time

from ..apps.wami import wami_cosmos
from ..apps.wami.pipeline import wami_cosmos_no_memory

# the COSMOS-vs-No-Memory span comparison is an analytical-model
# experiment (the No-Memory ablation has no measured counterpart)
SCENARIOS = {"apps": ("wami",), "backends": ("analytical",)}


def _ledgered_run(reg, *, batch=False, guided=False):
    """One full wami analytical session through a metrics-instrumented
    ledger; returns (session, result, ledger, invoke-wall histogram)."""
    from ..core import BatchPricer, OracleLedger, build_session, build_tool
    tool = build_tool("wami", "analytical")
    if batch or guided:
        tool = BatchPricer.wrap(tool)
    ledger = OracleLedger(tool, metrics=reg)
    sess = build_session("wami", "analytical", ledger=ledger, guided=guided)
    res = sess.run()
    hist = reg.snapshot()["oracle.invoke_wall_s"]
    return sess, res, ledger, hist


_RAW_PLANE_UNROLLS = 128


def _scalar_plane(tool):
    """Wall time for the scalar path to price the full (pow2 ports x
    unrolls) knob plane of every component, one call per point."""
    n = 0
    t0 = time.perf_counter()
    for name in tool.components:
        for ports in (1, 2, 4, 8):
            for unrolls in range(1, _RAW_PLANE_UNROLLS + 1):
                tool.synthesize(name, unrolls=unrolls, ports=ports)
                n += 1
    return time.perf_counter() - t0, n


def _batched_plane(tool, pricer_cls):
    """Wall time for the vectorized path to price the identical plane:
    one corner request per component forces the covering grid build."""
    pricer = pricer_cls(tool)
    t0 = time.perf_counter()
    for name in tool.components:
        pricer.synthesize(name, unrolls=_RAW_PLANE_UNROLLS, ports=8)
    return time.perf_counter() - t0, pricer.grid_points_priced


def _write_pricing(report) -> None:
    """BENCH_pricing.json v2 — the vectorized-pricing + frugality bench,
    written into the report's directory.

    Two subtrees:

    * ``deterministic`` — ledger counts, grid accounting, and the
      front-equality proofs.  Byte-identical between any two runs on
      any host.
    * ``timing`` — host-dependent throughput (points priced per second
      through the scalar and batched paths, raw-loop speedup, best of
      3).
    """
    from ..apps.wami import wami_exhaustive
    from ..core import BatchPricer, build_tool
    from ..core.obs import MetricsRegistry

    scalar_s, scalar_res, scalar_led, scalar_hist = _ledgered_run(
        MetricsRegistry())
    batch_s, batch_res, batch_led, batch_hist = _ledgered_run(
        MetricsRegistry(), batch=True)
    guided_s, guided_res, guided_led, _ = _ledgered_run(
        MetricsRegistry(), guided=True)
    exhaustive = wami_exhaustive()

    def front(res):
        return repr(res.planned), repr(res.mapped)

    pricer = batch_led.tool               # the session's BatchPricer
    guided_stats = guided_s.guided or {}
    ratio = exhaustive.total_invocations / max(1, guided_led.total())
    deterministic = {
        "exhaustive": {"invocations": exhaustive.total_invocations},
        "unguided": {"points": scalar_led.total(),
                     "per_component": dict(sorted(
                         scalar_led.invocations.items())),
                     "outcomes": scalar_led.outcome_counts()},
        "batched": {"points": batch_led.total(),
                    "outcomes": batch_led.outcome_counts(),
                    "ledger_books_equal_scalar":
                        dict(batch_led.invocations)
                        == dict(scalar_led.invocations)
                        and dict(batch_led.failed)
                        == dict(scalar_led.failed),
                    "front_equal_scalar":
                        front(batch_res) == front(scalar_res),
                    "grid": {"builds": pricer.grid_builds,
                             "points_priced": pricer.grid_points_priced,
                             "lookups": pricer.lookups,
                             "fallbacks": pricer.fallbacks}},
        "guided": {"points": guided_led.total(),
                   "per_component": dict(sorted(
                       guided_led.invocations.items())),
                   "confirmed": sum(v["confirmed"]
                                    for v in guided_stats.values()),
                   "fell_back": sorted(n for n, v in guided_stats.items()
                                       if v["fell_back"]),
                   "grid_invocations": sum(v["grid_invocations"]
                                           for v in guided_stats.values()),
                   "front_equal_unguided":
                       front(guided_res) == front(scalar_res),
                   "reduction_vs_exhaustive_x": round(ratio, 2)},
    }

    # host-dependent throughput.  The headline
    # prices the identical full knob plane both ways, best of 3 —
    # warm: each rep rebuilds its grids, while the pure-function noise
    # memo is process-wide by design, which is the steady state every
    # repeated session and the service's pool-level pricer run at.
    # Ledger-path numbers from the invoke-wall histograms ride along
    # for the session-shaped (cold, 141-point) view.
    tool = build_tool("wami", "analytical")
    _scalar_plane(tool), _batched_plane(tool, BatchPricer)   # warmup rep
    raw_scalar, raw_n = min(_scalar_plane(tool) for _ in range(3))
    raw_batch, _ = min(_batched_plane(tool, BatchPricer) for _ in range(3))
    scalar_pps = (scalar_led.total() / scalar_hist["sum"]
                  if scalar_hist["sum"] else None)
    batch_pps = (pricer.grid_points_priced / batch_hist["sum"]
                 if batch_hist["sum"] else None)
    timing = {
        "raw_plane_points": raw_n,
        "points_per_sec_scalar": round(raw_n / raw_scalar, 1),
        "points_per_sec_batched": round(raw_n / raw_batch, 1),
        "speedup_raw_plane_x": round(raw_scalar / raw_batch, 2),
        "ledger_path": {
            "points_per_sec_scalar": round(scalar_pps, 1)
                                     if scalar_pps else None,
            "points_per_sec_batched": round(batch_pps, 1)
                                      if batch_pps else None,
            "tool_wall_s_scalar": round(scalar_hist["sum"], 6),
            "tool_wall_s_batched": round(batch_hist["sum"], 6),
            "invoke_wall_hist": scalar_hist["buckets"],
        },
        "best_of": 3,
    }

    doc = {"version": 2, "bench": "vectorized-pricing+frugality",
           "generated_by": "python -m repro_torch.bench.run --cell "
                           "table1/wami-analytical",
           "app": "wami", "backend": "analytical",
           "deterministic": deterministic, "timing": timing}
    path = os.path.join(report.out_dir, "BENCH_pricing.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    report.csv("oracle_pricing",
               scalar_hist["sum"] / max(1, scalar_led.total()) * 1e6,
               f"points={scalar_led.total()}_batched_x="
               f"{timing['speedup_raw_plane_x']}_frugality_x="
               f"{deterministic['guided']['reduction_vs_exhaustive_x']}")


def run(report, cell, *, device=None) -> None:
    t0 = time.time()
    full = wami_cosmos(delta=0.25)
    nomem = wami_cosmos_no_memory(delta=0.25)
    wall = time.time() - t0

    lines = ["# Table 1 — component characterization (COSMOS vs No Memory)",
             "component,reg,lam_span,area_span,nm_lam_span,nm_area_span"]
    ls_c, as_c, ls_n, as_n = [], [], [], []
    for name, c in full.characterizations.items():
        n = nomem.characterizations[name]
        lines.append(f"{name},{len(c.regions)},{c.lam_span:.2f},"
                     f"{c.area_span:.2f},{n.lam_span:.2f},{n.area_span:.2f}")
        ls_c.append(c.lam_span); as_c.append(c.area_span)
        ls_n.append(n.lam_span); as_n.append(n.area_span)
    avg = (statistics.mean(ls_c), statistics.mean(as_c),
           statistics.mean(ls_n), statistics.mean(as_n))
    lines.append(f"AVERAGE,-,{avg[0]:.2f},{avg[1]:.2f},{avg[2]:.2f},{avg[3]:.2f}")
    lines.append(f"# paper: 4.06x/2.58x (COSMOS) vs 1.73x/1.22x (No Memory)")
    report.write("table1_characterization", lines)
    report.csv("table1_spans", wall * 1e6,
               f"lam={avg[0]:.2f}x/{avg[2]:.2f}x_area={avg[1]:.2f}x/{avg[3]:.2f}x")
    _write_pricing(report)
