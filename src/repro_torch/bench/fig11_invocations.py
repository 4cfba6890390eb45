"""Fig. 11: HLS-tool invocations — exhaustive vs COSMOS, per component.

Also runnable standalone as the frugality gate:

    PYTHONPATH=src python -m repro_torch.bench.fig11_invocations --smoke

which runs a reduced WAMI exploration and exits non-zero unless COSMOS
still beats the exhaustive baseline on invocations (ratio > 1).
"""

from __future__ import annotations

import sys
import time

# the frugality count compares against the WAMI exhaustive baseline,
# which only the analytical model can afford to price in full
SCENARIOS = {"apps": ("wami",), "backends": ("analytical",)}


def run(report, cell, *, device=None) -> None:
    from ..apps.wami import wami_exhaustive
    from ..core.registry import build_session

    t0 = time.time()
    session = build_session("wami", "analytical", delta=0.25, workers=8)
    cos = session.run()
    exh = wami_exhaustive(workers=8)
    wall = time.time() - t0

    lines = ["# Fig. 11 — invocations to the HLS tool",
             "component,exhaustive,cosmos,reduction"]
    reductions = []
    for name in exh.invocations:
        e = exh.invocations[name]
        c = cos.invocations.get(name, 0)
        r = e / max(1, c)
        reductions.append(r)
        lines.append(f"{name},{e},{c},{r:.1f}x")
    total_r = exh.total_invocations / cos.total_invocations
    lines.append(f"TOTAL,{exh.total_invocations},{cos.total_invocations},"
                 f"{total_r:.1f}x")
    by_phase = session.ledger.records_by_phase()
    lines.append(f"# paper: 6.7x average, up to 14.6x per component")
    lines.append(f"# ours: {total_r:.1f}x average, up to {max(reductions):.1f}x")
    lines.append(f"# cosmos breakdown by phase: "
                 + ",".join(f"{k}={v}" for k, v in sorted(by_phase.items())))
    lines.append(f"# exhaustive composition would need "
                 f"{exh.combinations():.2e} combinations (paper: >9e12)")
    report.write("fig11_invocations", lines)
    report.csv("fig11_invocations", wall * 1e6,
               f"avg={total_r:.1f}x_max={max(reductions):.1f}x")


def smoke() -> int:
    """Fast invocation-frugality gate on a reduced WAMI knob space."""
    from ..apps.wami import (MATRIX_INV_LATENCY_S, wami_hls_tool,
                             wami_knob_spaces, wami_tmg)
    from ..core import KnobSpace, cosmos_dse, exhaustive_dse

    spaces = {n: KnobSpace(clock_ns=s.clock_ns, max_ports=min(4, s.max_ports),
                           max_unrolls=min(8, s.max_unrolls))
              for n, s in wami_knob_spaces().items()}
    t0 = time.time()
    cos = cosmos_dse(wami_tmg(), wami_hls_tool(), spaces, delta=0.3,
                     fixed={"matrix_inv": MATRIX_INV_LATENCY_S}, workers=8)
    exh = exhaustive_dse(list(spaces), wami_hls_tool(), spaces, workers=8)
    ratio = exh.total_invocations / max(1, cos.total_invocations)
    print(f"fig11-smoke: exhaustive={exh.total_invocations} "
          f"cosmos={cos.total_invocations} ratio={ratio:.2f}x "
          f"({time.time() - t0:.1f}s)")
    if ratio <= 1.0:
        print("fig11-smoke: FAIL — COSMOS no longer beats exhaustive",
              file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    import argparse
    from .run import PrintReport
    from .scenarios import Cell
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.fig11_invocations")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced run asserting the invocation ratio > 1")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()
    run(PrintReport(), Cell("fig11", "wami", "analytical"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
