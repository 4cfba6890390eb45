"""COSMOS planning a training mesh: train knobs for every arch on a
256-device mesh (data 16, model 16), then an elastic event (12 of 512
ranks lost on the two-pod mesh) and a re-plan — the paper's
invocation-frugality argument applied to sharded training.  Every plan
is priced on the chip table's H100 SXM (80 GB a device).

All pricing runs through the same ``Oracle``/``OracleLedger`` protocol
as the WAMI exploration (:mod:`repro_torch.examples.wami_dse`): one
shared ledger accounts every priced knob point across all stages, and a
re-plan of an unchanged stage is a cache hit, not a new pricing.  The
walk is pure host arithmetic; nothing runs on a device.

    PYTHONPATH=src python -m repro_torch.examples.autoshard
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

# the elastic event: 12 of the two-pod mesh's 512 ranks lost
SURVIVORS = 500


def walk(prefix: str = "") -> Dict[str, Any]:
    """Plan every arch on train_4k over (data 16, model 16) through one
    ledger, re-plan gemma2-9b after the elastic event, then plan the
    unchanged stage again; print each step (lines led by ``prefix``) and
    return the plans (mb, remat, accumulation dtype, GB to 2 places),
    the priced count, the re-plan and the invocations each step added."""
    from ..configs import get_config, get_shape, list_archs
    from ..core.autotune import (HBM_BYTES_PER_CHIP, XLAOracle,
                                 choose_train_knobs)
    from ..core.oracle import OracleLedger
    from ..ft import replan
    shape = get_shape("train_4k")
    mesh = {"data": 16, "model": 16}
    ledger = OracleLedger(XLAOracle())     # one ledger for the whole fleet
    plans = {}
    print(f"{prefix}{'arch':24s} {'mb':>3s} {'remat':6s} {'accum':9s} "
          f"{'plan GB':>8s} fit", flush=True)
    for arch in list_archs():
        p = choose_train_knobs(get_config(arch), shape, mesh, ledger=ledger)
        plans[arch] = (p.microbatches, p.remat, p.accum_dtype,
                       round(p.est_bytes / 1e9, 2))
        fit = "Y" if p.est_bytes <= HBM_BYTES_PER_CHIP else "N"
        print(f"{prefix}{arch:24s} {p.microbatches:3d} {p.remat:6s} "
              f"{p.accum_dtype:9s} {p.est_bytes / 1e9:8.1f} {fit}",
              flush=True)
    priced, stages = ledger.total(), len(ledger.invocations)
    print(f"{prefix}-- {priced} priced invocations across {stages} stages "
          f"(ladder walk, batched) --", flush=True)

    print(f"{prefix}-- elastic event: {512 - SURVIVORS} chips lost on the "
          f"multi-pod mesh --", flush=True)
    plan = replan((2, 16, 16), ("pod", "data", "model"), SURVIVORS)
    print(f"{prefix}new mesh {dict(zip(plan.axis_names, plan.new_shape))}, "
          f"usable {plan.usable_devices}, resharding "
          f"{'required' if plan.needs_resharding else 'NOT required'}: "
          f"{plan.note}", flush=True)
    mesh2 = dict(zip(plan.axis_names, plan.new_shape))
    gemma = get_config("gemma2-9b")
    p2 = choose_train_knobs(gemma, shape, mesh2, ledger=ledger)
    replan_new = ledger.total() - priced
    print(f"{prefix}gemma2-9b re-planned: mb={p2.microbatches} "
          f"remat={p2.remat} ({p2.est_bytes / 1e9:.1f} GB/chip) — "
          f"{replan_new} new pricings, one compile to remap", flush=True)
    # planning the unchanged stage again costs nothing
    before = ledger.total()
    choose_train_knobs(gemma, shape, mesh, ledger=ledger)
    again = ledger.total() - before
    print(f"{prefix}unchanged-stage re-plan: {again} new invocations "
          f"(cache)", flush=True)
    return {"plans": plans, "priced": priced, "replan_mesh": mesh2,
            "replan": [p2.microbatches, p2.remat, p2.est_bytes],
            "replan_new": replan_new, "unchanged_new": again}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.autoshard",
        description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    walk()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
