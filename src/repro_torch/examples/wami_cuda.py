"""COSMOS over the *measured* backend: the WAMI DSE driven by a
CudaOracle that prices each (component, knob) point by timing the
stage's knob-parameterized CUDA kernel on the card.

The default run replays a recording (``--recording PATH``, or
``artifacts/measurements/wami_cuda_tile{T}.json``): deterministic, on
the card or, with ``--device cpu``, on any host, since the device kind
and the shared-memory budget come from the recording.  It then fits the
analytical HLSTool's latency constants to the measured points and
reports both backends' Pareto views side by side.

    PYTHONPATH=src python -m repro_torch.examples.wami_cuda --device cpu
    PYTHONPATH=src python -m repro_torch.examples.wami_cuda --record \\
        --tile 256 --out-dir build/measurements            # on the card

``--record`` times every point the drive touches on the card and writes
``wami_cuda_tile{T}.json`` into ``--out-dir`` (default
``artifacts/measurements``).  A recording already there is resumed: its
points are not timed again.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence

from . import _cli

PREFIX = "[cuda]"


def drive(mode: str, *, tile: int, path: str, delta: float = 0.25,
          device=None):
    """The measured WAMI drive at ``tile`` over the recording at
    ``path``: (session, result, oracle, saved path or None, host s).
    Record mode walks on one worker, as the JAX package's recorder."""
    from ..apps.wami import wami_cuda_oracle, wami_cuda_session
    oracle = wami_cuda_oracle(mode, tile=tile, device=device,
                              store_path=path)
    t0 = time.time()
    session = wami_cuda_session(delta, oracle=oracle,
                                workers=1 if mode == "record" else 8)
    res = session.run()
    saved = oracle.flush()
    return session, res, oracle, saved, time.time() - t0


def front_lines(res) -> List[str]:
    """The drive's Pareto front, as the JAX package's script prints it."""
    return [f"   theta {pt.perf:8.2f} fps   cost {pt.cost:12.1f}"
            for pt in res.pareto()]


def report(mode: str, session, res, oracle, saved: Optional[str],
           wall: float, delta: float = 0.25) -> List[str]:
    """The lines the run prints: the drive, the recording's provenance and
    walls per stage, the invocations by phase, the front, then the
    analytical tool calibrated to the measured points."""
    from ..apps.wami import WAMI_CUDA_STAGES, wami_hls_tool
    from ..core import ExplorationSession, calibrate_to_records
    from ..core.calibrate import CalibratedTool
    store = oracle.store
    lines = [f"{PREFIX} {mode} drive: {res.total_invocations} oracle "
             f"invocations, {len(res.mapped)} mapped points, {wall:.1f}s"]
    if saved:
        lines.append(f"{PREFIX} recording saved: {saved} "
                     f"({len(store)} measured points)")
    lines.append(f"{PREFIX} recording: {_cli.provenance_line(store.meta)}")
    failed = dict(session.ledger.failed)
    lines += [f"{PREFIX}   {ln}" for ln in
              _cli.stage_lines(store, failed, WAMI_CUDA_STAGES)]
    by_phase = session.ledger.records_by_phase()
    lines.append(f"{PREFIX} invocations by phase: "
                 + ", ".join(f"{k}={v}" for k, v in sorted(by_phase.items())))
    lines.append(f"{PREFIX} invocations by component: "
                 + ", ".join(f"{k}={v}" for k, v in res.invocations.items()))
    lines.append(f"{PREFIX} Pareto front (theta in [{res.theta_min:.2f}, "
                 f"{res.theta_max:.2f}] frames/s; cost = shared-memory "
                 f"bytes + fallback mm^2):")
    lines += front_lines(res)

    # ---- calibrate the analytical backend to the measured points -----
    measured_comps = set(oracle.components)
    hls = wami_hls_tool()
    fit = calibrate_to_records(
        hls, [r for r in session.ledger.records
              if r.component in measured_comps])
    lines.append("[calibrate] per-component latency scale (measured / "
                 "analytical):")
    for name in sorted(fit.scales):
        lines.append(f"   {name:14s} x{fit.scales[name]:10.3g}   "
                     f"({fit.points[name]} pts, residual spread "
                     f"x{fit.lam_spread[name]:.2f})")
    cal = ExplorationSession(
        session.tmg, CalibratedTool(hls, fit), session.spaces,
        delta=delta, fixed=session.fixed, workers=8).run()
    lines.append(f"[calibrate] theta range, calibrated analytical: "
                 f"[{cal.theta_min:.2f}, {cal.theta_max:.2f}] fps "
                 f"vs measured: [{res.theta_min:.2f}, {res.theta_max:.2f}] "
                 f"fps")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.wami_cuda",
        description=__doc__.split("\n")[0])
    ap.add_argument("--record", action="store_true",
                    help="time every point this drive touches on the card "
                         "and write the recording into --out-dir")
    ap.add_argument("--tile", type=int, default=None,
                    help="PLM tile edge (default: the recording's, or the "
                         "WAMI 128)")
    ap.add_argument("--delta", type=float, default=0.25)
    ap.add_argument("--recording", default=None,
                    help="the recording a replay reads (default: "
                         "artifacts/measurements/wami_cuda_tile{T}.json)")
    ap.add_argument("--out-dir", default=_cli.MEASUREMENTS_DIR,
                    help="where --record writes wami_cuda_tile{T}.json")
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    from ..apps.wami.cuda import default_measurement_path
    from ..apps.wami.components import TILE
    from ..core import MeasurementStore
    counters = _cli.wami_kernel_counters()
    if args.record:
        if args.recording:
            ap.error("--record writes into --out-dir; --recording names "
                     "what a replay reads")
        _cli.require_card(ap, args.device)
        tile = args.tile or TILE
        path = os.path.join(args.out_dir, f"wami_cuda_tile{tile}.json")
        resumed = _cli.resume_check(ap, path, args.device)
        if resumed is not None:
            print(f"{PREFIX} resuming {path}: {resumed} points recorded "
                  f"already")
        mode = "record"
    else:
        path = args.recording or default_measurement_path(args.tile or TILE)
        recorded = MeasurementStore.load(path).tile
        if args.tile and recorded and args.tile != recorded:
            ap.error(f"{path} was recorded at tile {recorded}, not "
                     f"{args.tile}")
        tile = args.tile or recorded or TILE
        mode = "replay"
    for c in counters.values():
        c.launches = 0
    session, res, oracle, saved, wall = drive(
        mode, tile=tile, path=path, delta=args.delta, device=args.device)
    for line in report(mode, session, res, oracle, saved, wall, args.delta):
        print(line)
    if mode == "record":
        print(f"{PREFIX} {_cli.launches_line(counters)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
