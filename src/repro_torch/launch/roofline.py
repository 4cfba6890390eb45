"""Roofline report generator: artifacts/dryrun_torch/*.json -> markdown
tables (the JAX package's ``launch/roofline.py``, on the chip table).

    PYTHONPATH=src python -m repro_torch.launch.roofline [DIR]

Per (arch x shape x mesh): the three roofline terms in seconds on an
H100 SXM (:mod:`..core.chips`), the dominant bottleneck, MODEL_FLOPS /
traced FLOPs (useful-compute fraction), device-memory fit, and a
one-line "what would move the dominant term" note.  It reads records of
either package's dry run: they share their keys.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from ..configs import get_config, get_shape
from ..core.chips import H100_SXM, ChipSpec

__all__ = ["model_flops", "ideal_mem_bytes", "load", "render", "main"]

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")

_MOVES = {
    "compute": "raise tensor-core utilization: bf16 (not f32) attention "
               "scores, larger per-device tiles, fewer pad/transpose "
               "copies, fuse elementwise chains",
    "memory": "cut HBM3 traffic: more microbatches / tighter remat, bf16 "
              "accumulation, fuse attention (flash kernel), avoid "
              "recompute re-reads",
    "collective": "cut NVLink traffic: sequence-parallel residuals "
                  "(reduce-scatter instead of all-gather), overlap "
                  "collectives with compute, head counts that divide the "
                  "model axis, gradient compression on the pod axis",
}


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch


def ideal_mem_bytes(arch: str, shape_name: str, devices: int,
                    microbatches: int) -> float:
    """Analytic minimum device-memory traffic per device per step (lower
    bound): weight reads (x3 per microbatch for fwd/bwd/remat on train;
    x1 for serving) + activation residual stream + KV/state traffic.  The
    traced bytes are an upper bound (every eager op reads and writes
    device memory); truth lies between."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    tp = 16
    dp = max(1, devices // tp)      # a mesh under 16 devices: no DP
    n_act = cfg.active_param_count()
    w_dev = 2.0 * n_act / tp
    B, S = shape.global_batch, shape.seq_len
    d, L = cfg.d_model, max(cfg.n_layers, 1)
    act = L * (B / dp) * S * d * 2.0 * 4   # residual r/w fwd+bwd
    if shape.kind == "train":
        opt = 12.0 * cfg.param_count() / (tp * dp)
        return 3.0 * w_dev * max(1, microbatches) + act + opt
    if shape.kind == "prefill":
        return w_dev + act / 2
    # decode: weights + full cache read
    hd = cfg.hd() if cfg.n_heads else 0
    cache = 2.0 * L * B * S * cfg.n_kv_heads * hd * 2.0 / devices
    return w_dev + cache


def load(directory: str = ART):
    return [json.load(open(f))
            for f in sorted(glob.glob(os.path.join(directory, "*.json")))]


def render(rows, out=sys.stdout, chip: ChipSpec = H100_SXM):
    w = out.write
    hbm_gb = chip.hbm_bytes / 1e9
    w(f"Chip table: {chip.name} ({chip.peak_flops / 1e12:g} TFLOP/s, "
      f"{chip.hbm_bw / 1e12:g} TB/s, {chip.link_bw / 1e9:g} GB/s a link, "
      f"{hbm_gb:g} GB)\n\n")
    w("| arch | shape | mesh | compute s | memory s (hi/lo) | "
      "collective s | bound | useful/traced | roofline frac (lo–hi) | "
      "HBM GB | fits |\n")
    w("|---|---|---|---|---|---|---|---|---|---|---|\n")
    for r in rows:
        if r["status"] == "skip":
            w(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
              f"SKIP | — | — | — | ({r['skip_reason'][:44]}…) |\n")
            continue
        if r["status"] != "ok":
            w(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | "
              f"ERROR | — | — | — | — |\n")
            continue
        ro = r["roofline"]
        mf = model_flops(r["arch"], r["shape"])
        traced = r["cost"]["flops_per_device"] * r["devices"]
        ratio = mf / traced if traced else 0.0
        mem = r["memory"]
        hbm = (mem["argument_bytes"] + mem["temp_bytes"]
               + mem["output_bytes"]) / 1e9
        t_mem_lo = ideal_mem_bytes(r["arch"], r["shape"], r["devices"],
                                   r.get("microbatches", 1)) / chip.hbm_bw
        tc = ro["t_compute_s"]
        hi_bound = max(tc, ro["t_memory_s"], ro["t_collective_s"])
        lo_bound = max(tc, t_mem_lo, ro["t_collective_s"])
        frac_lo = tc / hi_bound if hi_bound else 0.0   # pessimistic traffic
        frac_hi = tc / lo_bound if lo_bound else 0.0   # analytic-min traffic
        w(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
          f"| {tc:.4f} | {ro['t_memory_s']:.4f}/{t_mem_lo:.4f} "
          f"| {ro['t_collective_s']:.4f} | **{ro['bound']}** "
          f"| {ratio:.2f} | {frac_lo:.0%}–{frac_hi:.0%} "
          f"| {hbm:.1f} | {'Y' if hbm <= hbm_gb else 'N'} |\n")
    w("\nBottleneck remedies:\n")
    for k, v in _MOVES.items():
        w(f"- **{k}**: {v}\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    render(load(argv[0] if argv else ART))


if __name__ == "__main__":
    main()
