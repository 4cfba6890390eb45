"""Beyond-paper: SoC composition — a chip's worth of accelerators.

The layer above one accelerator's DSE: each cell takes a two-app
traffic mix (WAMI frames + fleet pipeline requests), resolves both
apps' system-level Pareto fronts through the port's registry (WAMI on
its PLM-shared front, the fleet on the chip table), and has
:class:`repro_torch.core.soc.SoCComposer` pick replica counts +
operating points to maximize sustained mix throughput under the
``sys_medium`` budgets.  Per cell it writes the CSV report plus the
``*.composition.json`` sidecar that ``python -m
repro_torch.core.soc.verify`` independently re-proves, and the primary
mix cell writes ``BENCH_soc.json`` beside them — the
sustained-throughput-per-area file.

Every run also gates the greedy allocator against the exhaustive
packer on a small gate budget: the gap must stay within the pinned
bound (0.40%: packing granularity), and the composition itself must
survive :func:`assert_composition_sound`.

    PYTHONPATH=src python -m repro_torch.bench.run --cell \
        soc/soc-analytical-wami60_fleet40
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

# fixed pseudo-cells (the "soc" app is the composition layer, not a
# registered App): one cell per traffic mix
SCENARIOS = {"pairs": (("soc", "analytical"),),
             "variants": ("wami60_fleet40", "wami90_fleet10")}

#: variant -> mix spec (parsed with the per-app DEFAULT_DEMANDS pricing)
MIXES: Dict[str, str] = {
    "wami60_fleet40": "wami=0.6,fleet=0.4",
    "wami90_fleet10": "wami=0.9,fleet=0.1",
}
PRIMARY = "wami60_fleet40"       # the cell that writes BENCH_soc.json
BUDGET_NAME = "sys_medium"

#: the greedy-vs-exhaustive gate: small enough for the exhaustive
#: packer, tight enough that replica packing granularity matters
GATE_BUDGET = dict(name="soc_gate", area_mm2=40.0, power_w=16.0,
                   bw_gbps=64.0)
GATE_MAX_GAP = 0.004             # pinned: greedy within 0.40% of optimal

_FRONT_CACHE: Dict[tuple, Dict[str, list]] = {}


def _fronts(composer) -> Dict[str, list]:
    """Within-process front cache — both mix cells share the same
    (app, backend, share_plm, delta) explorations."""
    key = tuple((d.app, d.backend, d.share_plm, d.delta)
                for d in composer.mix.demands)
    if key not in _FRONT_CACHE:
        _FRONT_CACHE[key] = composer.fronts()
    return _FRONT_CACHE[key]


def _compose(mix_name: str, budget, tracer=None, metrics=None):
    from ..core.soc import SoCComposer, TrafficMix
    mix = TrafficMix.parse(MIXES[mix_name], name=mix_name)
    composer = SoCComposer(budget, mix, workers=8, tracer=tracer,
                           metrics=metrics)
    composer._fronts = _fronts(composer)
    return composer, composer.compose()


def run(report, cell, *, device=None) -> None:
    from ..core.obs import LogicalClock, MetricsRegistry, Tracer
    from ..core.soc import (SoCBudget, assert_composition_sound,
                                get_budget, greedy_composition,
                                optimal_composition)
    budget = get_budget(BUDGET_NAME)
    tracer = Tracer(LogicalClock())
    metrics = MetricsRegistry()
    t0 = time.time()
    composer, comp = _compose(cell.variant, budget, tracer=tracer,
                              metrics=metrics)
    wall = time.time() - t0
    fronts = composer.fronts()

    # the strict post-pass: the composition must survive independent
    # re-verification (pricing, budgets, throughput claim, front pin)
    assert_composition_sound(comp, fronts=fronts)

    # the greedy-vs-exhaustive gate on the small instance
    gate = SoCBudget(**GATE_BUDGET)
    g = greedy_composition(gate, comp.mix, fronts)
    o = optimal_composition(gate, comp.mix, fronts)
    gap = ((o.sustained_throughput - g.sustained_throughput)
           / o.sustained_throughput)
    assert gap <= GATE_MAX_GAP, (
        f"greedy fell {gap:.4%} short of the exhaustive packer "
        f"(pinned bound {GATE_MAX_GAP:.2%})")

    b = comp.budget
    lines = [f"# SoC composition — mix {comp.mix.name} on {b.name} "
             f"@{b.tech_nm}nm ({comp.method})",
             "app,share,point,replicas,theta_per_replica,capacity_rps,"
             "area_mm2,power_w,bw_gbps"]
    for a in comp.allocations:
        lines.append(f"{a.app},{a.share:.4f},{a.point.index},"
                     f"{a.replicas},{a.point.theta:.6g},"
                     f"{a.capacity:.6g},{a.area_mm2:.6g},"
                     f"{a.power_w:.6g},{a.bw_gbps:.6g}")
    lines.append(f"# sustained T={comp.sustained_throughput:.6g} req/s; "
                 f"totals: area {comp.area_mm2:.6g}/{b.area_mm2:g} mm2, "
                 f"power {comp.power_w:.6g}/{b.power_w:g} W, "
                 f"bw {comp.bw_gbps:.6g}/{b.bw_gbps:g} GB/s")
    lines.append(f"# throughput per area "
                 f"{comp.throughput_per_area:.6g} req/s/mm2")
    lines.append(f"# greedy-vs-exhaustive gate ({gate.name}: "
                 f"{gate.area_mm2:g} mm2, {gate.power_w:g} W, "
                 f"{gate.bw_gbps:g} GB/s): greedy "
                 f"T={g.sustained_throughput:.6g}, exhaustive "
                 f"T={o.sustained_throughput:.6g}, gap {gap * 100:.3f}% "
                 f"<= {GATE_MAX_GAP * 100:.2f}% pinned")
    moves = metrics.snapshot().get("soc.moves", 0)
    lines.append(f"# obs: {len(tracer.spans())} spans "
                 f"(soc.compose > soc.front/soc.allocate), "
                 f"{moves} allocator moves")
    lines.append("# verify: composition independently re-proved feasible "
                 "(python -m repro_torch.core.soc.verify)")
    name = f"soc_compose_{cell.variant}"
    report.write(name, lines)
    report.write_json(name, comp.to_json(), kind="composition")

    if cell.variant == PRIMARY:
        _write_trajectory(report, budget, gate, g, o, gap)

    report.csv(name, wall * 1e6,
               f"T={comp.sustained_throughput:.4g}rps_tpa="
               f"{comp.throughput_per_area:.4g}_gap={gap * 100:.2f}pct")


def _write_trajectory(report, budget, gate, g, o, gap) -> None:
    """``BENCH_soc.json`` in the report's directory — sustained
    throughput per area across every mix."""
    mixes: Dict[str, dict] = {}
    for mix_name in sorted(MIXES):
        _, comp = _compose(mix_name, budget)
        mixes[mix_name] = {
            "sustained_throughput_rps": comp.sustained_throughput,
            "area_mm2": comp.area_mm2,
            "power_w": comp.power_w,
            "bw_gbps": comp.bw_gbps,
            "throughput_per_area_rps_per_mm2": comp.throughput_per_area,
            "replicas": {a.app: a.replicas for a in comp.allocations},
            "points": {a.app: a.point.index for a in comp.allocations},
            "method": comp.method,
        }
    doc = {"version": 1, "bench": "soc_compose",
           "generated_by": "python -m repro_torch.bench.run --cell "
                           f"soc/soc-analytical-{PRIMARY}",
           "budget": budget.to_json(),
           "gate": {"budget": gate.to_json(),
                    "greedy_T": g.sustained_throughput,
                    "exhaustive_T": o.sustained_throughput,
                    "gap": gap, "max_gap": GATE_MAX_GAP},
           "mixes": mixes}
    path = os.path.join(report.out_dir, "BENCH_soc.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def main(argv=None) -> int:
    import argparse
    from .run import CellReport
    from .scenarios import Cell
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.soc_compose")
    ap.add_argument("--variant", choices=sorted(MIXES), default=PRIMARY)
    args = ap.parse_args(argv)
    cell = Cell("soc", "soc", "analytical", args.variant)
    run(CellReport(cell), cell)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
