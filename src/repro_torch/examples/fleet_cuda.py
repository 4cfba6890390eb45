"""The fleet app over the measured backend: flash attention feeding the
Mamba2 SSD scan, each (stage, knob) point priced by timing its CUDA
kernel on the card.

The default run replays a recording (``--recording PATH``, or
``artifacts/measurements/fleet_cuda.json``): deterministic, on the card
or, with ``--device cpu``, on any host.  It prints the drive's
invocations and its front as the fleet allocation table (theta,
shared-memory bytes, each stage's knobs).

    PYTHONPATH=src python -m repro_torch.examples.fleet_cuda --device cpu
    PYTHONPATH=src python -m repro_torch.examples.fleet_cuda --record \\
        --out-dir build/measurements                       # on the card

``--record`` drives ``build_session("fleet", "cuda")`` on one worker with
a record-mode oracle and writes ``fleet_cuda.json`` into ``--out-dir``
(default ``artifacts/measurements``), resuming a recording already
there.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Sequence

from . import _cli

PREFIX = "[fleet]"


def drive(mode: str, *, path: str, device=None):
    """The measured fleet drive over the recording at ``path``:
    (session, result, oracle, saved path or None, host s)."""
    from ..apps.fleet import fleet_cuda_oracle
    from ..core import build_session
    oracle = fleet_cuda_oracle(mode, device=device, store_path=path)
    t0 = time.time()
    session = build_session("fleet", "cuda", tool=oracle,
                            workers=1 if mode == "record" else 4)
    res = session.run()
    saved = oracle.flush()
    return session, res, oracle, saved, time.time() - t0


def front_lines(res) -> List[str]:
    """The mapped points as the fleet allocation table: theta, the
    shared-memory bytes, and each stage's (ports, unrolls)."""
    lines = ["theta_per_s,total_cost_smem_bytes,flash_ports,flash_unrolls,"
             "ssd_ports,ssd_unrolls"]
    for m in res.mapped:
        knobs = {o.component: (o.synthesis.ports, o.synthesis.unrolls)
                 for o in m.outcomes}
        fa = knobs.get("flash_attention", (0, 0))
        ss = knobs.get("ssd_scan", (0, 0))
        lines.append(f"{m.theta_actual:.3f},{m.cost_actual:.3f},"
                     f"{fa[0]},{fa[1]},{ss[0]},{ss[1]}")
    return lines


def report(mode: str, session, res, oracle, saved: Optional[str],
           wall: float) -> List[str]:
    lines = []
    if saved:
        lines.append(f"fleet-record: {len(oracle.store)} measured points "
                     f"-> {saved} ({res.total_invocations} oracle "
                     f"invocations)")
    lines.append(f"{PREFIX} {mode} drive: {res.total_invocations} oracle "
                 f"invocations, {len(res.mapped)} mapped points, "
                 f"{wall:.1f}s")
    lines.append(f"{PREFIX} recording: "
                 f"{_cli.provenance_line(oracle.store.meta)}")
    lines += [f"{PREFIX}   {ln}" for ln in _cli.stage_lines(
        oracle.store, dict(session.ledger.failed), list(oracle.components))]
    by_phase = session.ledger.records_by_phase()
    lines.append(f"{PREFIX} invocations by phase: "
                 + ", ".join(f"{k}={v}" for k, v in sorted(by_phase.items())))
    lines.append(f"{PREFIX} invocations by component: "
                 + ", ".join(f"{k}={v}" for k, v in res.invocations.items()))
    lines.append(f"# COSMOS fleet allocation (flash_attention + ssd_scan "
                 f"pipeline, backend=cuda, {len(res.pareto())} points on "
                 f"the front)")
    lines += front_lines(res)
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.fleet_cuda",
        description=__doc__.split("\n")[0])
    ap.add_argument("--record", action="store_true",
                    help="time every point the drive touches on the card "
                         "and write fleet_cuda.json into --out-dir")
    ap.add_argument("--recording", default=None,
                    help="the recording a replay reads (default: "
                         "artifacts/measurements/fleet_cuda.json)")
    ap.add_argument("--out-dir", default=_cli.MEASUREMENTS_DIR,
                    help="where --record writes fleet_cuda.json")
    _cli.add_device(ap)
    args = ap.parse_args(argv)

    from ..apps.fleet import default_measurement_path
    counters = _cli.fleet_kernel_counters()
    if args.record:
        if args.recording:
            ap.error("--record writes into --out-dir; --recording names "
                     "what a replay reads")
        _cli.require_card(ap, args.device)
        path = os.path.join(args.out_dir, "fleet_cuda.json")
        resumed = _cli.resume_check(ap, path, args.device)
        if resumed is not None:
            print(f"{PREFIX} resuming {path}: {resumed} points recorded "
                  f"already")
        mode = "record"
    else:
        path = args.recording or default_measurement_path()
        mode = "replay"
    for c in counters.values():
        c.launches = 0
    session, res, oracle, saved, wall = drive(mode, path=path,
                                              device=args.device)
    for line in report(mode, session, res, oracle, saved, wall):
        print(line)
    if mode == "record":
        print(f"{PREFIX} {_cli.launches_line(counters)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
