"""Memory co-design on WAMI: tile as a knob + cross-component PLM sharing.

The walkthrough for the system-level PLM planner, replayed from the
card's committed recordings at tiles 64 and 128 (deterministic, on the
card or, with ``--device cpu``, on any host):

  1. fit the unit system: per-component latency scales plus one global
     bytes-per-mm² area rate, so the analytical fallback prices in the
     measured backend's cost unit (shared-memory bytes);
  2. derive the memory compatibility graph from the Fig. 8 TMG — the
     one-token LK refinement cycle certifies six components mutually
     exclusive;
  3. run the DSE with the tile knob open (tiles 128 and 64 replay their
     recordings; a point either walk never timed is priced by the
     calibrated fallback) and the PLM planner pricing the memory
     subsystem per mapped point;
  4. show the system front against the paper's naive per-component sum:
     the shared-PLM front dominates or equals it everywhere.

    PYTHONPATH=src python -m repro_torch.examples.wami_plm --device cpu
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from . import _cli

# the tiles whose card recordings the drive replays
MEASURED_TILES = (64, 128)


def run(device=None) -> List[str]:
    """The walkthrough's lines."""
    from ..apps.wami import wami_cuda_plm_session, wami_cuda_unit_system
    from ..apps.wami.pipeline import wami_tmg
    from ..core.plm import MemoryCompatGraph
    lines = []

    # ---- 1. one cost unit per system ---------------------------------
    units = wami_cuda_unit_system()
    lines.append(f"[units] area: 1 mm² == {units.area_scale:.4g} "
                 f"shared-memory bytes ({units.area_points} fitted points, "
                 f"residual spread x{units.area_spread:.1f})")
    for name in sorted(units.lam.scales):
        lines.append(f"[units]   lam {name:14s} "
                     f"x{units.lam.scales[name]:.3g}")

    # ---- 2. who may share --------------------------------------------
    compat = MemoryCompatGraph(wami_tmg())
    shareable = sorted(n for n in compat.names if compat.neighbours(n))
    lines.append(f"[compat] mutually exclusive (one-token LK cycle): "
                 f"{', '.join(shareable)}")

    # ---- 3. the co-design drive --------------------------------------
    session = wami_cuda_plm_session(0.25, workers=8, mode="replay",
                                    measured_tiles=MEASURED_TILES,
                                    device=device)
    res = session.run()
    lines.append(f"[dse] {res.total_invocations} oracle invocations, "
                 f"{len(res.mapped)} mapped points, theta in "
                 f"[{res.theta_min:.1f}, {res.theta_max:.1f}] fps")
    for name, ch in sorted(res.characterizations.items()):
        tiles = sorted({dict(p.knobs).get("tile", 0)
                        for p in ch.points} - {0})
        if len(tiles) >= 2:
            lines.append(f"[dse]   {name:14s} tile axis {tiles}, "
                         f"{len(ch.regions)} regions")

    # ---- 4. shared front vs per-component sum ------------------------
    lines.append("[front] theta_fps   shared_cost   naive_sum   saved   "
                 "groups")
    for m in sorted(res.mapped, key=lambda m: m.theta_actual):
        groups = ";".join("+".join(g) for g in m.plm_groups) or "-"
        lines.append(f"[front] {m.theta_actual:9.2f}  {m.cost_actual:12.0f}  "
                     f"{m.cost_unshared:10.0f}  "
                     f"{m.cost_unshared - m.cost_actual:6.0f}   {groups}")
    if not all(m.cost_actual <= m.cost_unshared + 1e-9 for m in res.mapped):
        raise AssertionError("a shared-PLM point costs more than the "
                             "naive per-component sum")
    lines.append("[front] shared-PLM front dominates or equals the naive "
                 "sum at every point")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.wami_plm",
        description=__doc__.split("\n")[0])
    _cli.add_device(ap)
    args = ap.parse_args(argv)
    for line in run(args.device):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
