"""The roofline table, derived from the port's dry-run records
(``artifacts/dryrun_torch/*.json``, written by ``python -m
repro_torch.launch.dryrun``; none are committed, so a fresh checkout
gives the header only).

compute    = traced FLOPs / (devices x peak FLOP/s of the chip table)
memory     = traced bytes / (devices x device-memory bandwidth)
collective = modelled collective bytes / (devices x link bandwidth)
MODEL_FLOPS = 6ND (dense) / 6 N_active D (MoE) for train;
              2ND per generated token for decode/prefill.
"""

from __future__ import annotations

import glob
import json
import os
import time

from ..core.chips import H100_SXM
from ..launch.roofline import ART, model_flops

# a fixed pseudo-cell: the table derives from the LLM config zoo's
# dry-run records, not from a registered App x Backend pair
SCENARIOS = {"pairs": (("zoo", "dryrun"),)}

#: the chip table the dry run prices against, and the fits column's bound
CHIP = H100_SXM


def run(report, cell, *, device=None) -> None:
    t0 = time.time()
    hbm_gb = CHIP.hbm_bytes / 1e9
    lines = [f"# Roofline table (per device; {CHIP.name}: "
             f"{CHIP.peak_flops / 1e12:g}TF bf16, "
             f"{CHIP.hbm_bw / 1e9:g}GB/s HBM, "
             f"{CHIP.link_bw / 1e9:g}GB/s link)",
             "arch,shape,mesh,t_compute_ms,t_memory_ms,t_collective_ms,"
             f"bound,model_flops_ratio,hbm_gb,fits_{hbm_gb:g}g"]
    n_cells = 0
    worst = ("", 0.0)
    for f in sorted(glob.glob(os.path.join(ART, "*.json"))):
        if "__tuned" in f or "naive" in f:
            continue
        with open(f) as fh:
            r = json.load(fh)
        if r["status"] == "skip":
            lines.append(f"{r['arch']},{r['shape']},{r['mesh']},SKIP,,,"
                         f"{r['skip_reason'][:60]},,,")
            continue
        if r["status"] != "ok":
            lines.append(f"{r['arch']},{r['shape']},{r['mesh']},ERROR,,,,,,")
            continue
        n_cells += 1
        ro = r["roofline"]
        mf = model_flops(r["arch"], r["shape"])
        traced_total = r["cost"]["flops_per_device"] * r["devices"]
        ratio = mf / traced_total if traced_total else 0.0
        mem = r["memory"]
        hbm = (mem["argument_bytes"] + mem["temp_bytes"]
               + mem["output_bytes"]) / 1e9
        lines.append(
            f"{r['arch']},{r['shape']},{r['mesh']},"
            f"{ro['t_compute_s'] * 1e3:.2f},{ro['t_memory_s'] * 1e3:.2f},"
            f"{ro['t_collective_s'] * 1e3:.2f},{ro['bound']},"
            f"{ratio:.2f},{hbm:.1f},{'Y' if hbm <= hbm_gb else 'N'}")
        if ro["t_bound_s"] > worst[1]:
            worst = (f"{r['arch']}/{r['shape']}/{r['mesh']}", ro["t_bound_s"])
    report.write("roofline_table", lines)
    report.csv("roofline_table", (time.time() - t0) * 1e6,
               f"cells={n_cells}_slowest={worst[0]}")
