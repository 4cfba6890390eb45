"""Fig. 10: compositional DSE Pareto curve — planned (LP) vs mapped.

``--backend analytical`` drives the simulated HLS tool; ``--backend
cuda`` (default) replays the card's recordings of the CUDA kernels
(``artifacts/measurements/wami_cuda_tile*.json``: deterministic, and on
any host with ``--device cpu``) so the same planned-vs-mapped sigma
analysis runs on real kernel timings.

``--share-plm`` runs the memory-co-design variant: the tile knob opens
as a third axis and the map phase prices the memory subsystem through
the system-level PLM planner.  The report then carries both fronts — the
planned shared-bank system cost and the paper's naive per-component sum
— and the shared front dominates or equals the naive one at every
throughput point by construction.

Standalone, as the determinism gate (two runs must be byte-identical):

    PYTHONPATH=src python -m repro_torch.bench.fig10_pareto --smoke \\
        --backend cuda --device cpu
"""

from __future__ import annotations

import statistics
import sys
import time

# the WAMI system Pareto, on both oracle families; share_plm is the
# memory-co-design variant (tile axis + shared-PLM system cost), tiles
# the multi-recording routing drive (measured backends with >= 2
# recordings on disk), workers1 the fan-out determinism gate — all cell
# axes, not global flags
SCENARIOS = {"apps": ("wami",), "backends": "*",
             "variants": ("", "share_plm", "tiles", "workers1")}

# the cost-unit token of each backend's columns: the card's recordings
# price a point in shared-memory bytes
_COST_UNIT = {"analytical": "mm2", "cuda": "smem_bytes"}


def cell_skip_reason(app, backend, variant):
    """Tighten the default check for the new variants: ``tiles``
    replays multiple recordings (measured backends with >= 2 tiles on
    disk only); ``workers1`` runs everywhere the base cell does."""
    from .scenarios import default_skip_reason
    base = "share_plm" if variant in ("share_plm", "tiles") else ""
    reason = default_skip_reason(app, backend, base)
    if reason:
        return reason
    if variant == "tiles":
        if not backend.measured:
            return (f"tiles variant routes multiple recordings; backend "
                    f"{backend.name!r} has no measured surface")
        tiles = backend.supported_tiles(app)
        if len(tiles) < 2:
            return (f"tiles variant needs >= 2 recordings on disk; app "
                    f"{app.name!r} has {sorted(tiles)}")
    return None


def _replay(backend: str, device) -> dict:
    """The measured backend's options for a cell: replay the card's
    recordings, the kernel specs' tensors on ``device``."""
    from ..core.registry import get_backend
    return (dict(mode="replay", device=device)
            if get_backend(backend).measured else {})


def _share_plm_result(backend: str, workers: int = 8, device=None):
    """Registry-resolved: ``build_session("wami", backend,
    share_plm=True)``.  The measured drive goes through
    :func:`~repro_torch.apps.wami.cuda.wami_cuda_plm_session` (the same
    ``build_session`` call underneath) so its measured-tiles default
    stays in one place.  ``verify_plans=True`` makes the map phase a
    strict gate: every emitted memory plan is independently re-proved
    race-free before it lands in the report."""
    if backend == "cuda":
        from ..apps.wami import wami_cuda_plm_session
        return wami_cuda_plm_session(0.25, workers=workers,
                                     verify_plans=True,
                                     **_replay(backend, device)).run()
    from ..core.registry import build_session
    return build_session("wami", backend, share_plm=True,
                         workers=workers, verify_plans=True,
                         **_replay(backend, device)).run()


def _plans_doc(res) -> dict:
    """The ``*.plans.json`` sidecar: every mapped point's memory plan
    plus the LP schedule it conditions on, in the format ``python -m
    repro_torch.core.analysis.verify`` re-proves."""
    from ..core.plm.spec import memory_plan_to_json
    points = []
    for m in sorted(res.mapped, key=lambda m: m.theta_planned):
        if m.memory_plan is None:
            continue
        points.append({
            "theta_planned": m.theta_planned,
            "schedule": (m.schedule.to_json()
                         if m.schedule is not None else None),
            "plan": memory_plan_to_json(m.memory_plan),
        })
    return {"app": "wami", "points": points}


def _run_tiles(report, cell, device=None) -> None:
    """The multi-recording drive: the shared-PLM front with the first
    two recorded tiles routed through the :class:`MeasurementSet` (the
    share_plm cell replays only the native tile and prices the rest
    through the calibrated fallback)."""
    from ..apps.wami import wami_cuda_plm_session
    from ..core.registry import get_app, get_backend
    tiles = tuple(sorted(
        get_backend(cell.backend).supported_tiles(get_app("wami"))))[:2]
    t0 = time.time()
    res = wami_cuda_plm_session(0.25, measured_tiles=tiles, workers=8,
                                verify_plans=True,
                                **_replay(cell.backend, device)).run()
    wall = time.time() - t0
    lines = [f"# Fig. 10 tiles variant — shared-PLM WAMI front, "
             f"multi-recording routing (backend={cell.backend}, "
             f"measured tiles {'+'.join(str(t) for t in tiles)})",
             "theta_mapped_fps,cost_mapped_bytes,cost_unshared"]
    for m in sorted(res.mapped, key=lambda m: (m.theta_actual,
                                               m.cost_actual)):
        lines.append(f"{m.theta_actual:.2f},{m.cost_actual:.3f},"
                     f"{m.cost_unshared:.3f}")
    lines.append(f"# {len(res.mapped)} points; recordings routed: "
                 + ",".join(str(t) for t in tiles)
                 + " (vs native-only in the share_plm cell)")
    report.write(f"fig10_pareto_{cell.backend}_tiles", lines)
    report.csv(f"fig10_pareto_{cell.backend}_tiles", wall * 1e6,
               f"points={len(res.mapped)}_tiles="
               + "+".join(str(t) for t in tiles))


def _run_workers1(report, cell, device=None) -> None:
    """The fan-out determinism gate as a matrix cell: the workers=1
    sequential drive must produce the same front — point for point,
    knob for knob — as the workers=8 batched drive."""
    from ..core.registry import build_session
    backend = cell.backend
    cost_unit = _COST_UNIT[backend]
    opts = _replay(backend, device)
    t0 = time.time()
    front1 = build_session("wami", backend, workers=1,
                           **opts).run().pareto()
    front8 = build_session("wami", backend, workers=8,
                           **opts).run().pareto()
    wall = time.time() - t0
    sig1 = repr([(p.perf, p.cost, p.knobs) for p in front1])
    sig8 = repr([(p.perf, p.cost, p.knobs) for p in front8])
    assert sig1 == sig8, (f"workers=1 front differs from workers=8 "
                          f"fan-out on backend {backend!r}")
    lines = [f"# Fig. 10 workers1 variant — WAMI front under workers=1 "
             f"(backend={backend})",
             f"theta_fps,cost_{cost_unit}"]
    for p in front1:
        lines.append(f"{p.perf:.2f},{p.cost:.3f}")
    lines.append(f"# {len(front1)} points, byte-identical to the "
                 f"workers=8 batched drive (repr-compared, knobs "
                 f"included)")
    report.write(f"fig10_pareto_{backend}_workers1", lines)
    report.csv(f"fig10_pareto_{backend}_workers1", wall * 1e6,
               f"points={len(front1)}_deterministic=yes")


def run(report, cell, *, device=None) -> None:
    from ..core.registry import build_session
    if cell.variant == "tiles":
        return _run_tiles(report, cell, device)
    if cell.variant == "workers1":
        return _run_workers1(report, cell, device)
    backend = cell.backend
    share_plm = cell.variant == "share_plm"
    t0 = time.time()
    if share_plm:
        res = _share_plm_result(backend, device=device)
        cost_unit = "bytes" if backend == "cuda" else "mm2"
    else:
        res = build_session("wami", backend, workers=8,
                            **_replay(backend, device)).run()
        cost_unit = _COST_UNIT[backend]
    wall = time.time() - t0

    suffix = "_share_plm" if share_plm else ""
    lines = [f"# Fig. 10 — WAMI system Pareto: planned vs mapped "
             f"(backend={backend}{', shared PLM' if share_plm else ''})",
             f"theta_planned_fps,cost_planned_{cost_unit},"
             f"theta_mapped_fps,cost_mapped_{cost_unit},sigma_pct"
             + (",cost_unshared" if share_plm else "")]
    sigmas = []
    for m in res.mapped:
        # under the planner, sigma keeps comparing like with like: the
        # LP plans per-component (unshared) costs, so mapping fidelity
        # is planned vs the naive sum; the sharing saving is its own
        # column, not folded into sigma
        sigma = (abs(m.cost_unshared - m.cost_planned) / m.cost_planned
                 if share_plm else m.sigma_mismatch)
        row = (f"{m.theta_planned:.2f},{m.cost_planned:.3f},"
               f"{m.theta_actual:.2f},{m.cost_actual:.3f},"
               f"{sigma * 100:.1f}")
        if share_plm:
            row += f",{m.cost_unshared:.3f}"
        lines.append(row)
        sigmas.append(sigma * 100)
    lines.append(f"# theta range [{res.theta_min:.2f}, {res.theta_max:.2f}] "
                 f"frames/s, {len(res.mapped)} points, delta=0.25")
    lines.append(f"# sigma: median {statistics.median(sigmas):.1f}% "
                 f"max {max(sigmas):.1f}% (paper: most <10%, a few >10% "
                 f"where region gaps force the conservative fallback)")
    if share_plm:
        saved = [m.cost_unshared - m.cost_actual for m in res.mapped]
        groups = sorted({g for m in res.mapped for g in m.plm_groups})
        lines.append(f"# shared-PLM savings vs per-component sum: "
                     f"median {statistics.median(saved):.3f} "
                     f"max {max(saved):.3f} {cost_unit}")
        lines.append(f"# shared groups: "
                     + "; ".join("+".join(g) for g in groups))
    name = ("fig10_pareto" if backend == "analytical"
            else f"fig10_pareto_{backend}") + suffix
    report.write(name, lines)
    if share_plm and hasattr(report, "write_json"):
        report.write_json(name, _plans_doc(res))
    report.csv(name, wall * 1e6,
               f"points={len(res.mapped)}_median_sigma="
               f"{statistics.median(sigmas):.1f}pct")


def smoke(backend: str = "cuda", device=None) -> int:
    """The memory-co-design gate: shared-PLM front must dominate or
    equal the naive per-component-sum front at every point, be strictly
    cheaper somewhere, and the printout must be byte-identical across
    runs.  No wall-clock output."""
    res = _share_plm_result(backend, device=device)
    lines = [f"fig10-smoke backend={backend} share-plm "
             f"points={len(res.mapped)}"]
    ok_dom, ok_strict = True, False
    for m in sorted(res.mapped, key=lambda m: (m.theta_actual,
                                               m.cost_actual)):
        if m.cost_actual > m.cost_unshared + 1e-9:
            ok_dom = False
        if m.cost_actual < m.cost_unshared * (1.0 - 1e-12):
            ok_strict = True
        lines.append(f"theta={m.theta_actual:.6g} "
                     f"shared={m.cost_actual:.6g} "
                     f"unshared={m.cost_unshared:.6g} "
                     f"groups={';'.join('+'.join(g) for g in m.plm_groups)}")
    tile_axis = sorted(
        n for n, ch in res.characterizations.items()
        if len({dict(p.knobs).get("tile", 0) for p in ch.points} - {0}) >= 2)
    lines.append(f"tile-axis components ({len(tile_axis)}): "
                 + ",".join(tile_axis))
    print("\n".join(lines))
    if not ok_dom:
        print("fig10-smoke: FAIL — shared-PLM cost exceeds the naive sum",
              file=sys.stderr)
        return 1
    if not ok_strict:
        print("fig10-smoke: FAIL — sharing never strictly cheaper",
              file=sys.stderr)
        return 1
    if len(tile_axis) < 3:
        print("fig10-smoke: FAIL — tile axis on fewer than 3 components",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    import argparse
    from .run import Report
    from .scenarios import Cell
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.fig10_pareto")
    ap.add_argument("--smoke", action="store_true",
                    help="deterministic shared-vs-naive dominance gate")
    ap.add_argument("--share-plm", action="store_true",
                    help="run the memory-co-design variant")
    ap.add_argument("--backend", choices=["analytical", "cuda"],
                    default="cuda")
    ap.add_argument("--device", default=None,
                    help="torch device of the kernel specs' tensors "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.backend, args.device)
    run(Report(), Cell("fig10", "wami", args.backend,
                       "share_plm" if args.share_plm else ""),
        device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
