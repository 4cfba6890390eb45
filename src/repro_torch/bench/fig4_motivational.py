"""Fig. 4: the (ports x unrolls) design space of the Gradient component.

Reproduces the paper's motivational example: sweeping the PLM port count
moves both latency and area by integer factors; unrolling moves latency
within a port region with diminishing returns; the with-memory span
dwarfs the dual-port-only span.  Also prices the same knob pair on the
H100 side through the wami_gradient CUDA kernel's shared-memory and grid
model (ports -> column banks -> CTA grid columns, unrolls -> rows per
CTA).
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..apps.wami import wami_knob_space
from ..core import InvocationRequest, OracleLedger, span
from ..core.registry import build_tool
from ..kernels.wami_gradient import grid_steps, vmem_bytes

# the Gradient component is WAMI's; both oracle families price it
SCENARIOS = {"apps": ("wami",), "backends": "*"}


def _gradient_rows(backend: str, device=None):
    """The priced (ports x unrolls) points of the Gradient component.

    Both oracles resolve through the registry (``build_tool("wami",
    backend)``).  ``analytical`` sweeps the full Table-1 knob space
    through the HLS model.  ``cuda`` replays the *measured* points of
    the card's recording at the native tile — the subset the COSMOS
    drive actually paid for (exhaustively measuring the space is exactly
    what the paper's methodology avoids).
    """
    space = wami_knob_space("gradient")       # canonical Table-1 bounds
    if backend == "cuda":
        tool = OracleLedger(build_tool("wami", backend, mode="replay",
                                       device=device), workers=8)
        store = tool.tool.store           # the native-tile recording
        keys = sorted(k for k in store.entries if k[0] == "gradient")
        requests = [InvocationRequest("gradient", unrolls=u, ports=p)
                    for _, p, u in keys]
        unit = ("lam_ms", "area_bytes", 1e3)
    else:
        tool = OracleLedger(build_tool("wami", backend), workers=8)
        requests = [InvocationRequest("gradient", unrolls=unrolls,
                                      ports=ports)
                    for ports in space.ports()
                    for unrolls in range(max(1, ports),
                                         space.max_unrolls + 1)]
        unit = ("lam_ms", "area_mm2", 1e3)
    rows: List[Dict] = []
    for req, s in zip(requests, tool.evaluate_batch(requests)):
        if s.feasible:
            rows.append({"ports": req.ports, "unrolls": req.unrolls,
                         "lam_ms": s.lam * unit[2], "area": s.area})
    return rows, unit


def run(report, cell, *, device=None) -> None:
    backend = cell.backend
    t0 = time.time()
    rows, (lam_col, area_col, _) = _gradient_rows(backend, device)
    wall = time.time() - t0

    all_lam = [r["lam_ms"] for r in rows]
    all_area = [r["area"] for r in rows]
    dual = [r for r in rows if r["ports"] == 2]
    lam_span, area_span = span(all_lam), span(all_area)
    lam_dual = span([r["lam_ms"] for r in dual]) if dual else 1.0
    area_dual = span([r["area"] for r in dual]) if dual else 1.0

    lines = [f"# Fig. 4 — Gradient design space ({len(rows)} syntheses, "
             f"backend={backend})",
             f"ports,unrolls,{lam_col},{area_col}"]
    lines += [f"{r['ports']},{r['unrolls']},{r['lam_ms']:.4f},"
              f"{r['area']:.4f}" for r in rows]
    lines.append(f"# span with memory co-design: lambda {lam_span:.2f}x, "
                 f"area {area_span:.2f}x (paper: 7.9x / 3.7x)")
    lines.append(f"# span dual-port only:        lambda {lam_dual:.2f}x, "
                 f"area {area_dual:.2f}x (paper: 1.4x / 1.2x)")
    lines.append("# H100 analogue (wami_gradient kernel, 512x512 frame):")
    lines.append("# ports,unrolls,smem_bytes_per_step,grid_steps")
    for ports in (1, 2, 4, 8):
        for unrolls in (8, 32):
            lines.append(f"# {ports},{unrolls},"
                         f"{vmem_bytes(512, 512, ports=ports, unrolls=unrolls)},"
                         f"{grid_steps(512, 512, ports=ports, unrolls=unrolls)}")
    name = ("fig4_motivational" if backend == "analytical"
            else f"fig4_motivational_{backend}")
    report.write(name, lines)
    csv_name = ("fig4_gradient_space" if backend == "analytical"
                else f"fig4_gradient_space_{backend}")
    report.csv(csv_name, wall * 1e6 / max(1, len(rows)),
               f"lam_span={lam_span:.2f}x_vs_dual={lam_dual:.2f}x")
