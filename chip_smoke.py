#!/usr/bin/env python3
"""Drive the PyTorch/CUDA package of COSMOS on one NVIDIA card and check it.

    python3 chip_smoke.py [--out PATH]

Run from a checkout of the repository; it needs one CUDA card, ``nvcc``
(on PATH or under /usr/local/cuda) and nothing else.  Phases, each of
which fails the run on any error:

  1. device  — the card's name and power limit; build every kernel
     under ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. parity  — every WAMI kernel against its plain PyTorch version on
     the card, at tile 128 and at the 512x512 frame, over the stage's
     Table-1 knob points (the Hessian over every dividing point of its
     Table-1 grid, and the same bits on three runs; tolerance max|d| /
     max(1, max|ref|): 1e-5, Hessian 1e-4; the change-detection mask
     exactly equal; debayer and gradient the same bits), debayer also on
     a 30x64 frame whose 5-row blocks do not align to the Bayer quad,
     debayer, gradient and change detection also on 30x66 (W % 4 != 0),
     gradient and change detection on 32x72 and debayer on 64x72 frames
     (tiles off the 16-byte grid: the scalar head and tail of the runs of
     4),
     warp also at the DSE's affine parameters (which clamp at the
     border), and every stage of ``wami_cuda_parity_cases``; then, with
     TF32 products off, flash attention at every knob point of the fleet
     DSE in f32 (3xTF32 mma.sync) and bf16 (wgmma, TMA), at
     tests/test_kernels.py's shapes in both, its window and soft-cap
     cases and head dim 256 at the gemma blocks, the reference's four
     blockings (the spread across them printed), head dims 80, 128, 100,
     50, 33, 20, 24, 200 and 250 (every general body), decode, and blocks
     of 12 and 20 over 1,500 keys (max|d| < 2e-5 in f32, 2e-2 in bf16;
     bf16 also against ``flash_tiled_ref``, which has the kernel's
     numerics with accurate exp and tanh), and the
     SSD scan at the fleet geometry (heads 1-8, chunks 8-64: chunk 8
     carries the state across 32 chunks), tests/test_kernels.py's
     shapes, N 128, and chunk 256 at N 128 and 64 (max|d| < 1e-4; the
     mamba2-780m layer in phase 5, relative to max(1, max|ref|));
  3. functional — ``wami_app`` on three synthetic 512x512 Bayer frames,
     and at 64x64 against the same code on the CPU;
  4. measured DSE — the main paths, each with its kernels' launch
     counts zeroed just before and read just after: ``wami_cuda_session``
     in record mode (characterize, plan, map, with the seven WAMI kernels
     timed on the card) and ``exhaustive_dse`` over the same oracle; then
     ``fleet_cuda_session`` and its exhaustive baseline over one
     record-mode oracle (flash attention and the SSD scan timed).  Each
     recording is replayed and must give the same front; the
     change-detection, debayer and gradient walls per knob point print
     beside those of their earlier kernels (``PREV_WALLS_US``); the
     analytical fleet drive on the H100 chip table follows;
  5. times   — each kernel, its plain version and (where one exists) one
     PyTorch library call on the same inputs: device time per call by
     CUDA events with the host's issue time kept out (as the oracle
     times), and the least time the card could take (bytes over
     3.35 TB/s; flops over 67 TFLOP/s in float32, 989 TFLOP/s in bf16:
     an H100 SXM's published peaks at its 700 W limit; for the SSD, whose
     products run on the tensor cores as three TF32 products each, also
     at 495 TFLOP/s of TF32, and its time per pass by torch.profiler).
     WAMI at tile 128 and 512x512 (with the per-call time a Python
     caller sees), the fleet kernels at the DSE's geometry (flash: also
     its bound at the 3xTF32 rate, and SDPA under each backend) and at
     model width (a gemma2-9b local layer at each of GEMMA_BLOCKS, with
     ``flex_attention`` under ``torch.compile`` as its yardstick; a
     mamba2-780m layer at chunk 64 and at its own chunk 256).

The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, it exits 2 and prints no result.  ``--out`` also
writes every number of the run to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# an H100 SXM's published peaks, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TILE, FRAME = 128, 512
# calls per timed reading: short enough that a plain version's kernels
# fit the device's queue of pending launches (about a thousand):
# 20 calls for the kernels and the short plain versions (up to ~10
# kernels a call), 5 for the plain versions of ~40-55 kernels a call
TIME_LAUNCHES = 20
TIME_LAUNCHES_LONG = 5
TIME_REPS = 10                   # readings; the best is kept


def _require(ok, what) -> None:
    """A check of the run's results (kept under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _close_err(got, want):
    """(max|d|, max|d| / max(1, max|want|)) of two tensors."""
    d = float((got.double() - want.double()).abs().max())
    return d, d / max(1.0, float(want.double().abs().max()))


def kernel_table():
    """Per kernel: its wrapper, plain version, launch counter, inputs,
    knob points, tolerance, bytes and flops per pixel, library call."""
    import numpy as np
    import torch
    from repro_torch.apps.wami.cuda import DSE_P_AFFINE, PARITY_P_AFFINE
    from repro_torch.kernels import wami_change_det as CD
    from repro_torch.kernels import wami_debayer as D
    from repro_torch.kernels import wami_gradient as G
    from repro_torch.kernels import wami_grayscale as Y
    from repro_torch.kernels import wami_steep as S
    from repro_torch.kernels import wami_warp as WP

    def inputs(n, dev, seed, width=None):
        """Inputs of an (n, width or n) frame on ``dev``."""
        H, W = n, width or n
        rng = np.random.default_rng(seed)
        f32 = np.float32
        mk = lambda a: torch.from_numpy(a.astype(f32)).to(dev)  # noqa: E731
        x = {
            "rgb": mk(rng.uniform(size=(H, W, 3)) * 255.0),
            "gray": mk(rng.uniform(size=(H, W)) * 255.0),
            "gx": mk(rng.standard_normal((H, W))),
            "gy": mk(rng.standard_normal((H, W))),
            "sd": mk(rng.standard_normal((H, W, 6))),
            # BT.601 weights, for the library call that computes luma
            "lum": mk(np.array([0.299, 0.587, 0.114])),
            "bayer": mk(rng.uniform(size=(H, W)) * 1023.0),
            "p": mk(np.array(PARITY_P_AFFINE)),
            "p_dse": mk(np.array(DSE_P_AFFINE)),
            "var": mk(np.full((H, W, 3), 36.0)),
            # unequal mixture weights, with ties between the first two
            # components in every third row
            "w": mk(rng.uniform(0.05, 0.6, size=(H, W, 3))),
        }
        x["mu"] = x["gray"][..., None] + mk(
            rng.standard_normal((H, W, 3))) * 8.0
        x["w"][::3, :, 1] = x["w"][::3, :, 0]
        return x

    def table1(max_ports, max_unrolls):
        """Knob points of a stage's Table-1 space: its corners, the
        default (1, 8) and one point inside."""
        return sorted({(1, 1), (1, 8), (4, 8), (1, max_unrolls),
                       (max_ports, max_unrolls), (2, max_unrolls // 2)})

    knobs = table1(16, 32)
    sd_knobs = table1(8, 16)
    # every point of the Hessian's Table-1 grid that divides the tile:
    # each point its DSE can time
    hess_knobs = [(p, u) for p in (1, 2, 4, 8, 16) for u in range(1, 33)
                  if TILE % u == 0]
    return inputs, [
        dict(name="wami_debayer", stage="debayer", op=D.debayer,
             ref=D.debayer_oracle, counter=D.debayer_kernel,
             args=("bayer",), knobs=knobs, tol=1e-5, exact=True,
             # 30 x 64 at (2, 5): 5-row blocks off the 2 x 2 Bayer quad;
             # its four bodies: one pixel a thread (<= 256 pixels a
             # tile), runs with a scalar head and tail (W % 4 != 0 at
             # 30 x 66 (2, 15); 18- and 9-column tiles at 64 x 72), whole
             # runs, and whole runs with staged stores (>= 1,024 pixels)
             odd_frames=[((30, 64), [(2, 5), (1, 5), (4, 3)]),
                         ((30, 66), [(11, 5), (2, 3), (1, 1), (2, 15)]),
                         ((64, 72), [(4, 16), (8, 32), (4, 8)])],
             bytes_px=16, flops_px=12, library=None,
             plain_launches=TIME_LAUNCHES_LONG,
             source="src/repro_torch/csrc/wami_debayer.cu",
             replaces="src/repro/kernels/wami_debayer/kernel.py:70"),
        dict(name="wami_grayscale", stage="grayscale", op=Y.grayscale,
             ref=Y.grayscale_oracle, counter=Y.grayscale_kernel,
             args=("rgb",), knobs=knobs, tol=1e-5,
             bytes_px=16, flops_px=5,
             library=lambda x: x["rgb"] @ x["lum"],
             source="src/repro_torch/csrc/wami_grayscale.cu",
             replaces="src/repro/kernels/wami_grayscale/kernel.py:35"),
        dict(name="wami_gradient", stage="gradient", op=G.gradient,
             ref=G.gradient_oracle, counter=G.gradient_kernel,
             args=("gray",), knobs=knobs, tol=1e-5, exact=True,
             # runs of 4 pixels: 18- and 9-column tiles start off the
             # 16-byte grid; W % 4 != 0 is scalar throughout
             odd_frames=[((30, 64), [(2, 5), (1, 5), (4, 3)]),
                         ((30, 66), [(11, 5), (2, 3), (1, 1)]),
                         ((32, 72), [(4, 8), (8, 4), (4, 1)])],
             bytes_px=12, flops_px=4, library=None,
             source="src/repro_torch/csrc/wami_gradient.cu",
             replaces="src/repro/kernels/wami_gradient/kernel.py:56"),
        dict(name="wami_steepest_descent", stage="steep_descent",
             op=S.steepest_descent, ref=S.steepest_descent_oracle,
             counter=S.steepest_descent_kernel, args=("gx", "gy"),
             knobs=sd_knobs, tol=1e-5, bytes_px=32, flops_px=4,
             library=None,
             source="src/repro_torch/csrc/wami_steep.cu",
             replaces="src/repro/kernels/wami_steep/kernel.py:56"),
        dict(name="wami_hessian", stage="hessian", op=S.hessian,
             ref=S.hessian_oracle, counter=S.hessian_kernel,
             args=("sd",), knobs=hess_knobs, tol=1e-4,
             bytes_px=24, flops_px=42, bytes_fixed=36 * 4,
             library=lambda x: (x["sd"].reshape(-1, 6).T
                                @ x["sd"].reshape(-1, 6)),
             source="src/repro_torch/csrc/wami_steep.cu",
             replaces="src/repro/kernels/wami_steep/kernel.py:87"),
        dict(name="wami_warp", stage="warp", op=WP.warp_affine,
             ref=WP.warp_affine_oracle, counter=WP.warp_kernel,
             args=("gray", "p"), knobs=sd_knobs, tol=1e-5,
             # the DSE's p, whose source cells clamp at the border
             alt_args=[("gray", "p_dse")],
             bytes_px=8, flops_px=22, bytes_fixed=6 * 4, library=None,
             plain_launches=TIME_LAUNCHES_LONG,
             source="src/repro_torch/csrc/wami_warp.cu",
             replaces="src/repro/kernels/wami_warp/kernel.py:64"),
        dict(name="wami_change_det", stage="change_det",
             op=CD.change_detection, ref=CD.change_detection_oracle,
             counter=CD.change_det_kernel, args=("gray", "mu", "var", "w"),
             knobs=sd_knobs, tol=1e-5, bytes_px=77, flops_px=86,
             # runs of 4 pixels: W % 4 != 0 takes the scalar path
             # throughout; 18- and 9-column tiles start off the 16-byte
             # grid and end with a scalar tail
             odd_frames=[((30, 66), [(11, 5), (2, 3), (1, 1)]),
                         ((32, 72), [(4, 8), (8, 4), (4, 1)])],
             library=None, plain_launches=TIME_LAUNCHES_LONG,
             source="src/repro_torch/csrc/wami_change_det.cu",
             replaces="src/repro/kernels/wami_change_det/kernel.py:88"),
    ]


def _check_outputs(what, got, want, tol):
    """max|d| of a kernel's outputs against its plain version's; a bool
    output (a mask) must be exactly equal."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    _require(len(got) == len(want), (what, len(got), len(want)))
    worst = 0.0
    for g, w in zip(got, want):
        _require(g.shape == w.shape and g.dtype == w.dtype,
                 (what, g.shape, w.shape, g.dtype, w.dtype))
        if g.dtype == torch.bool:
            bad = int((g != w).sum())
            if bad:
                raise RuntimeError(f"{what}: {bad} mask pixels differ")
            continue
        d, rel = _close_err(g, w)
        if not rel < tol:
            raise RuntimeError(f"{what}: max|d|={d:.3g}, relative "
                               f"{rel:.3g} >= {tol}")
        worst = max(worst, d)
    return worst


def _parity_cases(k):
    """(H, W, input names, knob points) a kernel is checked at."""
    for names in [k["args"]] + k.get("alt_args", []):
        for n in (TILE, FRAME):
            yield n, n, names, k["knobs"]
    for (H, W), knobs in k.get("odd_frames", []):
        yield H, W, k["args"], knobs


def phase_parity(dev, inputs, table):
    """Every kernel against its plain version on the card; returns the
    largest absolute error per kernel."""
    import torch
    from repro_torch.apps.wami.cuda import wami_cuda_parity_cases
    errs = {}
    for k in table:
        worst, points = 0.0, 0
        for H, W, names, knobs in _parity_cases(k):
            x = inputs(H, dev, seed=3, width=W)
            args = [x[a] for a in names]
            want = k["ref"](*args)
            for ports, unrolls in knobs:
                got = k["op"](*args, ports=ports, unrolls=unrolls)
                torch.cuda.synchronize(dev)
                worst = max(worst, _check_outputs(
                    f"{k['name']} at {H}x{W} ({', '.join(names)}), "
                    f"ports={ports}, unrolls={unrolls}", got, want,
                    k["tol"]))
                points += 1
        # the plain version's arithmetic in its order: the same bits
        _require(not k.get("exact") or worst == 0.0,
                 f"{k['name']}: max|d| {worst:.3g}, the same bits required")
        if k["name"] == "wami_hessian":
            # a last-CTA sum in index order, no float atomics: the same
            # bits on every run
            x = inputs(FRAME, dev, seed=4)
            runs = [k["op"](x["sd"], ports=4, unrolls=8) for _ in range(3)]
            _require(all(torch.equal(r, runs[0]) for r in runs),
                     "Hessian differs from run to run")
        errs[k["name"]] = worst
        print(f"[parity] {k['name']}: max|d| {worst:.3g} over "
              f"{points} (shape, knob) points, tol {k['tol']:g} relative",
              flush=True)
    for name, op, ref, args in wami_cuda_parity_cases(TILE, dev):
        got, want = op(*args), ref(*args)
        torch.cuda.synchronize(dev)
        d = _check_outputs(f"{name} (parity case)", got, want,
                           1e-4 if name == "wami_hessian" else 1e-5)
        print(f"[parity] wami_cuda_parity_cases {name}: max|d| {d:.3g}",
              flush=True)
    return errs


def synthetic_bayer(n, frames=3, seed=0):
    """A smooth scene, the same scene again, and the scene with a bright
    square moved in: a (frames, n, n) float32 Bayer stream."""
    import numpy as np
    rng = np.random.default_rng(seed)
    raw = rng.uniform(size=(n + 8, n + 8))
    k = np.ones(9) / 9.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 0, raw)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, img)
    base = (img * 1000.0).astype(np.float32)
    out = np.stack([base] * frames)
    s = n // 8
    out[-1, s:2 * s, s:2 * s] += 1500.0
    return out


def phase_functional(dev):
    import torch
    from repro_torch.apps.wami import wami_app
    frames = synthetic_bayer(FRAME)
    t0 = time.perf_counter()
    masks, ps = wami_app(frames, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    _require(masks.shape == (2, FRAME, FRAME) and ps.shape == (2, 6),
             (masks.shape, ps.shape))
    _require(bool(torch.isfinite(ps).all()), ps)
    fg = [float(m.float().mean()) for m in masks]
    s = FRAME // 8
    moved = float(masks[1, s:2 * s, s:2 * s].float().mean())
    print(f"[functional] wami_app 3 x {FRAME}x{FRAME}: {wall:.3f} s; "
          f"p = {[[round(v, 6) for v in p.tolist()] for p in ps]}; "
          f"foreground {fg[0]:.4f}, {fg[1]:.4f} (moved square "
          f"{moved:.3f})", flush=True)
    _require(fg[0] < 0.1 and moved > 0.5, (fg, moved))
    # the same code on the CPU at a small size is the reference
    small = synthetic_bayer(64, seed=1)
    m_gpu, p_gpu = wami_app(small, device=dev)
    m_cpu, p_cpu = wami_app(small, device="cpu")
    dp = float((p_gpu.cpu() - p_cpu).abs().max())
    dm = int((m_gpu.cpu() != m_cpu).sum())
    print(f"[functional] 64x64 card vs CPU: max|d p| {dp:.3g}, "
          f"mask pixels differing {dm} of {m_cpu.numel()}", flush=True)
    _require(dp < 1e-3 and dm <= m_cpu.numel() // 1000, (dp, dm))
    return {"p": ps.tolist(), "foreground": fg, "moved_square": moved,
            "wall_s": wall, "cpu_max_dp": dp, "cpu_mask_diff": dm}


def phase_dse(dev, table):
    """The main path: record-mode COSMOS session + exhaustive baseline
    over one CudaOracle.  Launch counts are zeroed just before and read
    just after."""
    import torch
    from repro_torch.apps.wami import (wami_cuda_oracle, wami_cuda_session,
                                       wami_knob_spaces)
    from repro_torch.core import (MeasurementSet, MeasurementStore,
                                  OracleLedger, exhaustive_dse)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wami_cuda_tile128.json")
        for k in table:
            k["counter"].launches = 0
        t0 = time.perf_counter()
        oracle = wami_cuda_oracle("record", store_path=path, device=dev)
        session = wami_cuda_session(oracle=oracle)
        res = session.run()
        spaces = wami_knob_spaces()
        exh_ledger = OracleLedger(oracle)
        exh = exhaustive_dse(list(spaces), oracle, spaces, exh_ledger)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {k["name"]: k["counter"].launches for k in table}
        oracle.flush()
        rec = MeasurementStore.load(path)
        replay = wami_cuda_oracle(
            "replay", device=dev, measurements=MeasurementSet.from_store(
                MeasurementStore.load(path), tile=TILE))
        res2 = wami_cuda_session(oracle=replay).run()
    front = res.pareto()
    print(f"[dse] device_kind {oracle.device_kind!r}, shared-memory "
          f"budget {oracle.smem_budget} B, {wall:.2f} s", flush=True)
    failed = dict(session.ledger.failed)
    exh_failed = dict(exh_ledger.failed)
    print(f"[dse] {'component':<14}{'cosmos':>8}{'failed':>8}"
          f"{'exhaustive':>12}{'failed':>8}  (failed: infeasible points, "
          f"shared memory {oracle.smem_budget} B)")
    for name in spaces:
        print(f"[dse] {name:<14}{res.invocations.get(name, 0):>8}"
              f"{failed.get(name, 0):>8}{exh.invocations.get(name, 0):>12}"
              f"{exh_failed.get(name, 0):>8}")
    print(f"[dse] {'total':<14}{res.total_invocations:>8}"
          f"{sum(failed.values()):>8}{exh.total_invocations:>12}"
          f"{sum(exh_failed.values()):>8}  "
          f"(x{exh.total_invocations / res.total_invocations:.2f}); "
          f"mapped points {len(res.mapped)}, front {len(front)}, "
          f"theta [{res.theta_min:.6g}, {res.theta_max:.6g}]", flush=True)
    print(f"[dse] launches in the drive: {launches}", flush=True)
    walls = {}
    for (comp, p, u), w in sorted(rec.entries.items()):
        walls.setdefault(comp, {})[f"p{p}:u{u}"] = w
    for comp, ws in walls.items():
        vals = sorted(ws.values())
        print(f"[dse] {comp}: {len(vals)} knob points timed, wall "
              f"{vals[0] * 1e6:.2f}..{vals[-1] * 1e6:.2f} us per launch",
              flush=True)
    for comp, (design, prev) in PREV_WALLS_US.items():
        print(f"[dse] {comp} walls per knob point, us (this run | {design}, "
              f"{PREV_CARD}): "
              + ", ".join(f"{pt} {w * 1e6:.2f} | "
                          + (f"{prev[pt]:.2f}" if pt in prev else "-")
                          for pt, w in sorted(walls.get(comp, {}).items())),
              flush=True)
    dead = [n for n, c in launches.items() if c <= 0]
    _require(not dead, f"kernels never launched on the main path: {dead}")
    _require(set(walls) == {k["stage"] for k in table}, sorted(walls))
    _require(res.mapped and all(
        math.isfinite(m.theta_actual) and m.theta_actual > 0
        and math.isfinite(m.cost_actual) for m in res.mapped),
        "a mapped system point is not finite")
    _require(res.total_invocations < exh.total_invocations,
             "COSMOS did not beat the exhaustive baseline on invocations")
    _require(repr(res2.mapped) == repr(res.mapped),
             "replaying the recording changed the front")
    print("[dse] replay of the recording reproduces the front", flush=True)
    return {"launches": launches, "cosmos": res.invocations,
            "exhaustive": exh.invocations, "cosmos_failed": failed,
            "exhaustive_failed": exh_failed, "front": len(front),
            "mapped": len(res.mapped), "wall_s": wall, "walls": walls,
            "smem_budget": oracle.smem_budget}


# Walls of the WAMI DSE's recording with an earlier kernel, read by that
# commit's chip_smoke.py (its --out JSON), in us per launch: change
# detection's scalar kernel of commit 8a11b55 (one pixel a thread, at
# most 256 threads a CTA), and debayer's and gradient's of commit
# f6001f2 (the same design).
PREV_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PREV_WALLS_US = {
    "change_det": ("the scalar design of commit 8a11b55", {
        "p1:u1": 3.157, "p1:u2": 3.237, "p1:u4": 4.267, "p1:u8": 6.402,
        "p2:u2": 3.050, "p2:u4": 3.240, "p2:u8": 4.269, "p2:u16": 6.395,
        "p4:u4": 3.070, "p4:u8": 3.237, "p4:u16": 4.320, "p8:u8": 3.205,
        "p8:u16": 3.384}),
    "debayer": ("the scalar design of commit f6001f2", {
        "p1:u1": 2.490, "p1:u2": 2.410, "p1:u4": 2.814, "p1:u8": 3.397,
        "p1:u16": 4.650, "p2:u2": 2.496, "p2:u4": 2.424, "p2:u8": 2.800,
        "p2:u16": 3.386, "p2:u32": 4.611, "p4:u4": 2.459, "p4:u8": 2.389,
        "p4:u16": 2.797, "p4:u32": 3.403, "p8:u8": 2.501, "p8:u16": 2.486,
        "p8:u32": 2.798, "p16:u16": 2.579, "p16:u32": 2.621}),
    "gradient": ("the scalar design of commit f6001f2", {
        "p1:u1": 2.360, "p1:u2": 2.411, "p1:u4": 2.626, "p1:u8": 2.976,
        "p1:u16": 3.957, "p1:u32": 5.702, "p2:u2": 2.360, "p2:u4": 2.384,
        "p2:u8": 2.550, "p2:u16": 3.051, "p2:u32": 4.058, "p4:u4": 2.344,
        "p4:u8": 2.397, "p4:u16": 2.552, "p4:u32": 3.030, "p8:u8": 2.357,
        "p8:u16": 2.394, "p8:u32": 2.562, "p16:u16": 2.478,
        "p16:u32": 2.397}),
}


def _time_ms(dev, fn, launches=TIME_LAUNCHES, reps=TIME_REPS):
    """Device milliseconds per call, host issue time excluded."""
    from repro_torch.core.cuda_oracle import device_time_s
    return device_time_s(fn, launches=launches, reps=reps,
                         device=dev) * 1e3


def _call_ms(dev, fn):
    """Milliseconds per call as a Python caller sees them: CUDA events
    around back-to-back calls, host issue time included."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(TIME_REPS):
        start.record()
        for _ in range(TIME_LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / TIME_LAUNCHES)
    return best


def phase_times(dev, inputs, table, ports=1, unrolls=8):
    out = {}
    for k in table:
        for n in (TILE, FRAME):
            x = inputs(n, dev, seed=5)
            args = [x[a] for a in k["args"]]
            ms = _time_ms(dev, lambda: k["op"](*args, ports=ports,
                                               unrolls=unrolls))
            plain = _time_ms(dev, lambda: k["ref"](*args),
                             k.get("plain_launches", TIME_LAUNCHES))
            lib = (None if k["library"] is None
                   else _time_ms(dev, lambda: k["library"](x)))
            nbytes = k["bytes_px"] * n * n + k.get("bytes_fixed", 0)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = k["flops_px"] * n * n / FP32_FLOPS_PER_S * 1e3
            call = _call_ms(dev, lambda: k["op"](*args, ports=ports,
                                                 unrolls=unrolls))
            row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "call_ms": call,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": k["flops_px"] * n * n}
            out.setdefault(k["name"], {})[n] = row
            lib_s = "-" if lib is None else f"{lib:.5f}"
            print(f"[times] {k['name']} {n}x{n} (ports={ports}, "
                  f"unrolls={unrolls}): kernel {ms:.5f} ms (per Python "
                  f"call {call:.5f} ms), plain {plain:.5f} ms, library "
                  f"{lib_s} ms, bound {row['bound_ms']:.6f} ms "
                  f"({row['bound_by']})", flush=True)
    return out


# ----------------------------------------------------------------------
# the fleet app: flash attention and the SSD scan
# ----------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12        # bf16 dense, the tensor cores
TF32_FLOPS_PER_S = 495e12        # TF32 dense, the tensor cores
# tests/test_kernels.py's tolerances: max|d| absolute
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = 1e-4
# tests/test_kernels.py::test_flash_block_size_invariance's blockings
REF_BLOCKINGS = ((64, 64), (128, 128), (64, 256), (256, 64))
# one gemma2-9b local layer and one mamba2-780m layer at model width
GEMMA_LAYER = dict(B=1, S=4096, H=16, K=8, d=256, window=4096,
                   softcap=50.0)
# its (block_q, block_kv): the blocks the f32-staging kernel of commit
# 8a11b55 ran at, then the larger ones the bf16 TMA ring allows
GEMMA_BLOCKS = ((64, 32), (64, 64))
MAMBA_LAYER = dict(Bz=1, S=4096, H=48, P=64, N=128, chunk=64)
MAMBA_CHUNK = 256                # configs/mamba2_780m.py's ssm_chunk
FLEET_KERNELS = (
    dict(name="flash_attention", stage="flash_attention",
         source="src/repro_torch/csrc/flash_attention.cu",
         replaces="src/repro/kernels/flash_attention/kernel.py:107"),
    dict(name="ssd_scan", stage="ssd_scan",
         source="src/repro_torch/csrc/ssd_scan.cu",
         replaces="src/repro/kernels/ssd_scan/kernel.py:91"),
)


def _flash_inputs(dev, B, Sq, Skv, H, K, d, dtype, seed):
    """Standard-normal q (B, Sq, H, d), k and v (B, Skv, K, d) in
    ``dtype``, from seeded numpy."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(dev, dtype)
                 for shape in ((B, Sq, H, d), (B, Skv, K, d),
                               (B, Skv, K, d)))


def _ssd_inputs(dev, Bz, S, H, P, N, seed):
    """x, dt, A, B, C in tests/test_kernels.py's distributions, from
    seeded numpy, float32."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((Bz, S, H, P)),
            np.logaddexp(0.0, rng.standard_normal((Bz, S, H)) * 0.5),
            -np.exp(rng.standard_normal((H,)) * 0.3),
            rng.standard_normal((Bz, S, N)) * 0.3,
            rng.standard_normal((Bz, S, N)) * 0.3)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                 for a in arrs)


def _abs_err(what, got, want, tol):
    """max|d| of a kernel's outputs against its plain version's, in
    float64; raises at ``tol`` or beyond, or on a non-finite output."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        _require(g.shape == w.shape and g.dtype == w.dtype,
                 (what, g.shape, w.shape, g.dtype, w.dtype))
        _require(bool(torch.isfinite(g).all()), f"{what}: not finite")
        d = float((g.double() - w.double()).abs().max())
        if not d < tol:
            raise RuntimeError(f"{what}: max|d|={d:.3g} >= {tol}")
        worst = max(worst, d)
    return worst


def phase_fleet_parity(dev):
    """Flash attention and the SSD scan against their plain versions on
    the card; returns the largest absolute error per kernel.  Every flash
    case keeps each query row's diagonal in its window (q_offset =
    Skv - Sq >= 0, window > 0 only with q_offset 0): a row masked
    everywhere is NaN in the plain version and 0 in the kernel."""
    import torch
    from repro_torch.apps.fleet import (FLASH_S, SSD_S,
                                        fleet_cuda_parity_cases)
    from repro_torch.kernels.flash_attention import (flash_tiled_ref, mha,
                                                     mha_ref)
    from repro_torch.kernels.build import smem_optin
    from repro_torch.kernels.ssd_scan import ssd, ssd_oracle, ssd_plan
    errs, points = {"flash_attention": 0.0, "ssd_scan": 0.0}, {}

    def check(name, what, got, want, tol):
        torch.cuda.synchronize(dev)
        errs[name] = max(errs[name], _abs_err(what, got, want, tol))
        points[name] = points.get(name, 0) + 1

    BOTH = (torch.float32, torch.bfloat16)

    def flash(what, q, k, v, **kw):
        tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
        want = mha_ref(q, k, v, **kw)
        check("flash_attention", what, mha(q, k, v, **kw), want, tol)

    # the fleet DSE's geometry at every dividing knob point
    _, op, ref, args = fleet_cuda_parity_cases(FLASH_S, dev)[0]
    want = ref(*args)
    for ports in (1, 2, 4):
        for unrolls in (1, 2, 4, 8):
            check("flash_attention", f"flash (ports {ports}, unrolls "
                  f"{unrolls})", op(*args, ports=ports, unrolls=unrolls),
                  want, FLASH_TOL["float32"])
    # tests/test_kernels.py's shapes, f32 and bf16, q_offset = Skv - Sq
    for B, Sq, Skv, H, K, d in ((1, 128, 128, 4, 4, 64),
                                (2, 128, 128, 8, 2, 64),
                                (1, 256, 256, 4, 2, 32),
                                (1, 128, 256, 4, 2, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(dev, B, Sq, Skv, H, K, d, dtype, 7)
            flash(f"flash {(B, Sq, Skv, H, K, d)} {dtype}", q, k, v,
                  q_offset=Skv - Sq, block_q=64, block_kv=64)
    # its window and soft-cap cases
    q, k, v = _flash_inputs(dev, 1, 128, 128, 4, 2, 64, torch.float32, 8)
    for window, softcap in ((64, 0.0), (0, 30.0), (32, 20.0)):
        flash(f"flash window {window} softcap {softcap}", q, k, v,
              window=window, softcap=softcap, block_q=64, block_kv=64)
    # the bf16 body (wgmma, TMA) at the DSE's geometry and knob points:
    # block_q 32 pads the m64 tile, 128 takes two warpgroups
    q, k, v = (t.to(torch.bfloat16) for t in args)
    for ports in (1, 2, 4):
        for unrolls in (1, 2, 4, 8):
            flash(f"flash bf16 (ports {ports}, unrolls {unrolls})", q, k, v,
                  block_q=FLASH_S // ports, block_kv=16 * unrolls)
    q, k, v = _flash_inputs(dev, 1, 128, 128, 4, 2, 64, torch.bfloat16, 8)
    for window, softcap in ((64, 0.0), (0, 30.0), (32, 20.0)):
        flash(f"flash bf16 window {window} softcap {softcap}", q, k, v,
              window=window, softcap=softcap, block_q=64, block_kv=64)
    # head dim 256 (gemma2-9b) at S 512: bf16 at the model-width blocks,
    # f32 at the blocks its staging allows
    q, k, v = _flash_inputs(dev, 1, 512, 512, 16, 8, 256, torch.bfloat16, 9)
    for block_q, block_kv in GEMMA_BLOCKS:
        flash(f"flash d 256, S 512, blocks {block_q} x {block_kv}", q, k, v,
              window=256, softcap=50.0, block_q=block_q, block_kv=block_kv)
    # against the rehearsal of its own numerics (bf16 P, accurate expf and
    # tanhf): what exp via ex2.approx and tanh.approx.f32 add
    kw = dict(window=256, softcap=50.0, block_q=GEMMA_BLOCKS[0][0],
              block_kv=GEMMA_BLOCKS[0][1])
    approx = _abs_err("flash d 256 against flash_tiled_ref",
                      mha(q, k, v, **kw), flash_tiled_ref(q, k, v, **kw),
                      FLASH_TOL["bfloat16"])
    print(f"[parity] flash bf16 d 256 against flash_tiled_ref (accurate "
          f"exp and tanh, the kernel's blocks): max|d| {approx:.3g}",
          flush=True)
    q, k, v = (t.float() for t in (q, k, v))
    flash("flash d 256, S 512, f32", q, k, v, window=256, softcap=50.0,
          block_q=64, block_kv=32)

    # the reference's blockings (tests/test_kernels.py::
    # test_flash_block_size_invariance): over-sized blocks run as
    # sub-tiles; the spread across them beside the reference's 1e-5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _flash_inputs(dev, 1, 256, 256, 4, 2, 64, dtype, 10)
        outs = []
        for block_q, block_kv in REF_BLOCKINGS:
            outs.append(mha(q, k, v, block_q=block_q, block_kv=block_kv))
            check("flash_attention", f"flash blocks {block_q} x {block_kv} "
                  f"{dtype}", outs[-1], mha_ref(q, k, v),
                  FLASH_TOL[str(dtype).split(".")[-1]])
        spread = max(float((o.double() - outs[0].double()).abs().max())
                     for o in outs[1:])
        print(f"[parity] flash {dtype} across the blockings {REF_BLOCKINGS}:"
              f" spread {spread:.3g} (the reference's, in f32: < 1e-5)",
              flush=True)
    # head dims off the native widths (zamba2-2.7b's 80, 32 heads on 32)
    # and the native 128 (8 query heads on 1), S 256; 100 and 33 (no
    # tensor map in bf16: the producer warp's copies; 4-byte cp.async in
    # f32 at 33) and 50 (f32: 4-byte cp.async); every other general
    # body: D 32 at 20 (no tensor map) and 24 (TMA, 64-byte swizzle),
    # D 256 at 200 (TMA in bf16) and 250 (no tensor map)
    for B, S, H, K, d, dtypes in ((1, 256, 32, 32, 80, BOTH),
                                  (1, 256, 8, 1, 128, BOTH),
                                  (2, 64, 4, 2, 100, BOTH),
                                  (2, 64, 4, 2, 33, BOTH),
                                  (2, 64, 4, 2, 50, (torch.float32,)),
                                  (2, 64, 4, 2, 20, BOTH),
                                  (2, 64, 4, 2, 24, BOTH),
                                  (2, 128, 4, 2, 200, BOTH),
                                  (2, 128, 4, 2, 250, BOTH)):
        for dtype in dtypes:
            q, k, v = _flash_inputs(dev, B, S, S, H, K, d, dtype, 11)
            flash(f"flash d {d} ({H} on {K} heads, S {S}) {dtype}", q, k, v,
                  block_q=128, block_kv=128)
    # decode: one query row at q_offset = Skv - 1 (block_q clips to 1);
    # gemma2-9b's head dim, window and soft-cap in bf16
    for dtype in BOTH:
        q, k, v = _flash_inputs(dev, 2, 1, 256, 8, 2, 64, dtype, 12)
        for window in (0, 64):
            flash(f"flash decode Skv 256 window {window} {dtype}", q, k, v,
                  q_offset=255, window=window)
    q, k, v = _flash_inputs(dev, 1, 1, 512, 16, 8, 256, torch.bfloat16, 12)
    flash("flash decode d 256 Skv 512 bf16", q, k, v, q_offset=511,
          window=256, softcap=50.0, block_kv=64)
    # blocks off the 16-row grid, dividing whisper's 1,500 frames: the
    # last 16- or 32-row tile is cut short (non-causal, every key live)
    for dtype, blk in ((torch.float32, 12), (torch.bfloat16, 20)):
        q, k, v = _flash_inputs(dev, 1, 1500, 1500, 4, 4, 64, dtype, 13)
        flash(f"flash S 1500 blocks {blk} x {blk} non-causal {dtype}", q, k,
              v, causal=False, block_q=blk, block_kv=blk)

    # the SSD at the fleet geometry: heads 1-8, chunks 8-64
    _, sop, sref, sargs = fleet_cuda_parity_cases(SSD_S, dev)[1]
    x, dt, A, Bm, Cm = sargs
    for heads in (1, 2, 4, 8):
        lanes = (x[:, :, :heads].contiguous(), dt[:, :, :heads].contiguous(),
                 A[:heads].contiguous(), Bm, Cm)
        want = ssd_oracle(*lanes)
        for chunk in (8, 16, 32, 64):
            check("ssd_scan", f"ssd heads {heads} chunk {chunk}",
                  ssd(*lanes, chunk=chunk), want, SSD_TOL)
    check("ssd_scan", "ssd fleet parity case (unrolls 8)",
          sop(*sargs, ports=1, unrolls=8), sref(*sargs), SSD_TOL)
    # tests/test_kernels.py's shapes, and N 128 at chunk 64
    for Bz, S, H, P, N, chunk in ((2, 128, 4, 32, 64, 32),
                                  (1, 256, 2, 64, 128, 128),
                                  (2, 64, 8, 16, 32, 64),
                                  (1, 256, 4, 64, 128, 64)):
        args = _ssd_inputs(dev, Bz, S, H, P, N, 7)
        check("ssd_scan", f"ssd {(Bz, S, H, P, N)} chunk {chunk}",
              ssd(*args, chunk=chunk), ssd_oracle(*args), SSD_TOL)
    # chunk 256, the ssm_chunk of mamba2-780m (P 64, N 128) and
    # zamba2-2.7b (N 64): its staging exceeds the card, so it runs as
    # sub-chunks (ssd_plan)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for Bz, S, H, P, N in ((1, 512, 4, 64, 128), (1, 512, 4, 64, 64)):
        args = _ssd_inputs(dev, Bz, S, H, P, N, 7)
        run = ssd_plan(Bz, S, H, P, N, 256, sms, smem_optin(dev)).chunk
        check("ssd_scan", f"ssd {(Bz, S, H, P, N)} chunk 256 (runs at "
              f"{run})", ssd(*args, chunk=256), ssd_oracle(*args), SSD_TOL)
    for name in errs:
        print(f"[parity] {name}: max|d| {errs[name]:.3g} over "
              f"{points[name]} cases", flush=True)
    return errs


def phase_fleet_dse(dev):
    """The fleet's main path: record-mode ``fleet_cuda_session`` and the
    exhaustive baseline over one CudaOracle, launch counts zeroed just
    before and read just after; the recording must replay to the same
    front.  Then the analytical fleet drive on the H100 chip table."""
    import torch
    from repro_torch.apps.fleet import (fleet_cuda_oracle,
                                        fleet_cuda_session,
                                        fleet_knob_spaces, fleet_session)
    from repro_torch.core import (MeasurementSet, MeasurementStore,
                                  OracleLedger, exhaustive_dse)
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    counters = {"flash_attention": flash_attention_kernel,
                "ssd_scan": ssd_scan_kernel}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fleet_cuda.json")
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        oracle = fleet_cuda_oracle("record", store_path=path, device=dev)
        session = fleet_cuda_session(oracle=oracle)
        res = session.run()
        spaces = fleet_knob_spaces()
        exh_ledger = OracleLedger(oracle)
        exh = exhaustive_dse(list(spaces), oracle, spaces, exh_ledger)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {n: c.launches for n, c in counters.items()}
        oracle.flush()
        rec = MeasurementStore.load(path)
        replay = fleet_cuda_oracle(
            "replay", device=dev, measurements=MeasurementSet.from_store(
                MeasurementStore.load(path), tile=0))
        res2 = fleet_cuda_session(oracle=replay).run()
    front = res.pareto()
    failed, exh_failed = dict(session.ledger.failed), dict(exh_ledger.failed)
    print(f"[fleet-dse] shared-memory budget {oracle.smem_budget} B, "
          f"{wall:.2f} s; component, cosmos, failed, exhaustive, failed",
          flush=True)
    for name in spaces:
        bad = sorted((r.ports, r.unrolls) for r in exh_ledger.records
                     if r.component == name and not r.feasible)
        print(f"[fleet-dse] {name:<16}{res.invocations.get(name, 0):>6}"
              f"{failed.get(name, 0):>6}{exh.invocations.get(name, 0):>6}"
              f"{exh_failed.get(name, 0):>6}  infeasible (ports, unrolls): "
              f"{bad}", flush=True)
    print(f"[fleet-dse] total {res.total_invocations} against exhaustive "
          f"{exh.total_invocations}; mapped points {len(res.mapped)}, front "
          f"{len(front)}", flush=True)
    print(f"[fleet-dse] launches in the drive: {launches}", flush=True)
    walls = {}
    for (comp, p, u), w in sorted(rec.entries.items()):
        walls.setdefault(comp, {})[f"p{p}:u{u}"] = w
    for comp, ws in walls.items():
        vals = sorted(ws.values())
        print(f"[fleet-dse] {comp}: {len(vals)} knob points timed, wall "
              f"{vals[0] * 1e6:.2f}..{vals[-1] * 1e6:.2f} us per launch",
              flush=True)
    dead = [n for n, c in launches.items() if c <= 0]
    _require(not dead, f"fleet kernels never launched on the main path: "
                       f"{dead}")
    _require(set(walls) == set(counters), sorted(walls))
    _require(res.mapped and all(
        math.isfinite(m.theta_actual) and m.theta_actual > 0
        and math.isfinite(m.cost_actual) for m in res.mapped),
        "a mapped fleet point is not finite")
    _require(repr(res2.mapped) == repr(res.mapped),
             "replaying the fleet recording changed the front")
    print("[fleet-dse] replay of the recording reproduces the front",
          flush=True)
    ana = fleet_session().run()
    _require(ana.mapped and all(math.isfinite(m.theta_actual)
                                for m in ana.mapped), "analytical fleet")
    print(f"[fleet-dse] analytical (H100 chip table): invocations "
          f"{ana.invocations}, mapped {len(ana.mapped)}, front "
          f"{len(ana.pareto())}", flush=True)
    return {"launches": launches, "cosmos": res.invocations,
            "exhaustive": exh.invocations, "cosmos_failed": failed,
            "exhaustive_failed": exh_failed, "front": len(front),
            "mapped": len(res.mapped), "wall_s": wall, "walls": walls,
            "analytical": {"invocations": ana.invocations,
                           "mapped": len(ana.mapped),
                           "front": len(ana.pareto())}}


def _wall_ms(dev, fn, reps=2):
    """Milliseconds per call with the host's issue time included: CUDA
    events around one call, after a warm-up call; the best of ``reps``.
    For the SSD's plain version, whose sequential loop launches
    thousands of kernels a call, more than a spin can keep queued."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _pass_us(dev, fn, calls=5):
    """Device microseconds per call of each kernel ``fn`` launches, by
    name, from a ``torch.profiler`` trace of ``calls`` calls; {} where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"(\w+)(<[^>]*>)?\(", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out


def _flash_work(B, Sq, Skv, H, K, d, esize, causal, window, q_offset):
    """(bytes, flops) flash attention must move and do: q, k, v read and
    o written once; 4 d flops per unmasked (row, key) pair per head."""
    import torch
    pos = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(pos, max=Skv - 1) if causal else torch.full_like(
        pos, Skv - 1)
    lo = (torch.clamp(pos - window + 1, min=0) if window > 0
          else torch.zeros_like(pos))
    pairs = int((hi - lo + 1).clamp(min=0).sum())
    nbytes = esize * (2 * B * Sq * H * d + 2 * B * Skv * K * d)
    return nbytes, 4 * d * pairs * B * H


def _ssd_work(Bz, S, H, P, N, chunk):
    """(bytes, flops) of the SSD scan: inputs read and outputs written
    once; the chunked algorithm's products, C.B^T once per chunk and
    batch (it does not depend on the head)."""
    tri = chunk * (chunk + 1) // 2
    nbytes = 4 * (2 * Bz * S * H * P + Bz * S * H + H + 2 * Bz * S * N
                  + Bz * H * P * N)
    flops = Bz * (S // chunk) * (tri * 2 * N + H * (tri * 2 * P
                                                    + 4 * chunk * P * N))
    return nbytes, flops


def _bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _sdpa_backends(dev, q, k, v):
    """Device ms of one SDPA call (causal, GQA) on the model layout's
    q, k, v under each backend ``sdpa_kernel`` can force; a backend that
    refuses the inputs gets the first line of its error."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {}
    for b in (SDPBackend.MATH, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        def call(b=b):
            with sdpa_kernel(b):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        try:
            out[b.name] = _time_ms(dev, call)
        except RuntimeError as exc:
            out[b.name] = "refused: " + (str(exc).strip().splitlines()
                                         or [""])[0][:160]
    return out


def _flex_attention(dev, q, k, v, *, window, softcap):
    """The yardstick of the gemma row: ``flex_attention`` under
    ``torch.compile`` with the soft-cap as ``score_mod``, the causal
    window as a ``block_mask`` and ``enable_gqa``, timed and held
    against the plain version (never called by the package).  Where it
    does not build, the first line of the error."""
    import torch
    from repro_torch.kernels.flash_attention import mha_ref
    call = ("torch.compile(flex_attention) (score_mod soft-cap, "
            "causal/window block_mask, enable_gqa)")
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        def soft_cap(score, b, h, q_idx, kv_idx):
            return torch.tanh(score / softcap) * softcap

        def causal_window(b, h, q_idx, kv_idx):
            return (q_idx >= kv_idx) & (q_idx - kv_idx < window)

        S = q.shape[1]
        mask = create_block_mask(causal_window, None, None, S, S,
                                 device=dev)
        flex = torch.compile(flex_attention)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def run():
            return flex(qt, kt, vt, score_mod=soft_cap, block_mask=mask,
                        enable_gqa=True)
        got = run().transpose(1, 2)
        torch.cuda.synchronize(dev)
        want = mha_ref(q, k, v, causal=True, window=window, softcap=softcap)
        err = float((got.double() - want.double()).abs().max())
        return {"call": call, "ms": _time_ms(dev, run, 3, 3),
                "max_abs_err": err}
    except Exception as exc:    # the yardstick is optional; say why
        return {"call": call, "error": (f"{type(exc).__name__}: {exc}"
                                        .strip().splitlines() or [""])[0]
                [:200]}


def phase_fleet_times(dev):
    """Each fleet kernel, its plain version and (where one exists) one
    PyTorch call computing the same function: at the DSE's geometry
    (flash at ports 2, unrolls 8; SSD at ports 1, unrolls 8) and at
    model width (a gemma2-9b local layer; a mamba2-780m layer)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.apps.fleet import FLASH_D, FLASH_HEADS, FLASH_S
    from repro_torch.apps.fleet import SSD_N, SSD_P, SSD_S
    from repro_torch.kernels.flash_attention import mha, mha_ref
    from repro_torch.kernels.build import smem_optin
    from repro_torch.kernels.ssd_scan import ssd, ssd_oracle, ssd_plan
    out = {}

    def flash_row(label, B, S, H, K, d, dtype, block_q, block_kv,
                  window=0, softcap=0.0, library=True, launches=20,
                  reps=TIME_REPS, plain=None):
        q, k, v = _flash_inputs(dev, B, S, S, H, K, d, dtype, 5)
        kw = dict(causal=True, window=window, softcap=softcap)
        ms = _time_ms(dev, lambda: mha(q, k, v, block_q=block_q,
                                         block_kv=block_kv, **kw),
                      launches, reps)
        if plain is None:
            plain = _time_ms(dev, lambda: mha_ref(q, k, v, **kw),
                             min(launches, TIME_LAUNCHES_LONG), reps)
        lib = None
        if library:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = _time_ms(dev, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), launches, reps)
        err = _abs_err(f"flash {label}", mha(q, k, v, block_q=block_q,
                                              block_kv=block_kv, **kw),
                       mha_ref(q, k, v, **kw),
                       FLASH_TOL[str(dtype).split(".")[-1]])
        nbytes, flops = _flash_work(B, S, S, H, K, d, q.element_size(),
                                    True, window, 0)
        row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
               "bytes": nbytes, "flops": flops, "max_abs_err": err,
               "blocks": [block_q, block_kv]}
        if dtype == torch.bfloat16:
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                      BF16_FLOPS_PER_S)
        else:
            row["bound_ms"], row["bound_by"] = _bound(nbytes, flops,
                                                      FP32_FLOPS_PER_S)
            # the kernel's rate: three TF32 tensor-core products each
            row["bound_3xtf32_ms"], _ = _bound(nbytes, 3 * flops,
                                               TF32_FLOPS_PER_S)
        return row, (q, k, v)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def ssd_row(label, Bz, S, H, P, N, chunk, launches=20, reps=TIME_REPS,
                plain=None):
        args = _ssd_inputs(dev, Bz, S, H, P, N, 5)
        # the chunk the kernel runs at (sub-chunks where the staging of
        # ``chunk`` exceeds the card): its work is the bound's
        run = ssd_plan(Bz, S, H, P, N, chunk, sms, smem_optin(dev)).chunk
        ms = _time_ms(dev, lambda: ssd(*args, chunk=chunk), launches, reps)
        if plain is None:
            plain = _wall_ms(dev, lambda: ssd_oracle(*args))
        got, want = ssd(*args, chunk=chunk), ssd_oracle(*args)
        torch.cuda.synchronize(dev)
        # relative to max(1, max|ref|): the state sums 4096 steps here
        scale = max(1.0, max(float(w.abs().max()) for w in want))
        err = _abs_err(f"ssd {label}", got, want, SSD_TOL * scale)
        nbytes, flops = _ssd_work(Bz, S, H, P, N, run)
        bound, by = _bound(nbytes, flops, FP32_FLOPS_PER_S)
        # the kernel's rate: three TF32 tensor-core products per product
        bound_tc, _ = _bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        passes = _pass_us(dev, lambda: ssd(*args, chunk=chunk))
        return {"ms": ms, "plain_ms": plain, "plain_host_bound": True,
                "library_ms": None, "bound_ms": bound, "bound_by": by,
                "bound_3xtf32_ms": bound_tc, "passes_us": passes,
                "bytes": nbytes, "flops": flops, "max_abs_err": err,
                "chunk": chunk, "run_chunk": run}

    g, m = GEMMA_LAYER, MAMBA_LAYER
    dse, dse_qkv = flash_row("DSE (ports 2, unrolls 8)", 1, FLASH_S,
                             FLASH_HEADS, 1, FLASH_D, torch.float32,
                             FLASH_S // 2, 16 * 8)
    dse["sdpa_backends_ms"] = _sdpa_backends(dev, *dse_qkv)
    model, plain = {}, None
    for block_q, block_kv in GEMMA_BLOCKS:
        row, qkv = flash_row(
            f"gemma2-9b local layer, blocks {block_q} x {block_kv}", g["B"],
            g["S"], g["H"], g["K"], g["d"], torch.bfloat16, block_q,
            block_kv, window=g["window"], softcap=g["softcap"],
            library=False, launches=3, reps=3, plain=plain)
        plain = row["plain_ms"]
        model[f"{block_q}x{block_kv}"] = row
    flex = _flex_attention(dev, *qkv, window=g["window"],
                           softcap=g["softcap"])
    for row in model.values():
        row["library_ms"] = flex.get("ms")
        row["library"] = flex
    out["flash_attention"] = {"dse": dse, "model": model[
        "{}x{}".format(*GEMMA_BLOCKS[0])]}
    for key, row in model.items():
        if key != "{}x{}".format(*GEMMA_BLOCKS[0]):
            out["flash_attention"][f"model {key}"] = row
    mamba = ssd_row("mamba2-780m layer", m["Bz"], m["S"], m["H"], m["P"],
                    m["N"], m["chunk"], launches=3, reps=3)
    out["ssd_scan"] = {
        "dse": ssd_row("DSE (ports 1, unrolls 8)", 1, SSD_S, 1, SSD_P,
                       SSD_N, 8 * 8),
        "model": mamba,
        # its own ssm_chunk, which runs as sub-chunks
        f"model chunk {MAMBA_CHUNK}": ssd_row(
            f"mamba2-780m layer, chunk {MAMBA_CHUNK}", m["Bz"], m["S"],
            m["H"], m["P"], m["N"], MAMBA_CHUNK, launches=3, reps=3,
            plain=mamba["plain_ms"])}
    for name, rows in out.items():
        for where, r in rows.items():
            lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
            tc = ("" if "bound_3xtf32_ms" not in r else
                  f", {r['bound_3xtf32_ms']:.6f} ms at the 3xTF32 rate")
            runs = ("" if r.get("run_chunk") == r.get("chunk")
                    else f" (runs at chunk {r['run_chunk']})")
            print(f"[times] {name} {where}{runs}: kernel {r['ms']:.5f} ms, "
                  f"plain {r['plain_ms']:.5f} ms, library {lib} ms, bound "
                  f"{r['bound_ms']:.6f} ms ({r['bound_by']}; "
                  f"{r['bytes']} B, {r['flops']} flop{tc}), max|d| "
                  f"{r['max_abs_err']:.3g}", flush=True)
            if "sdpa_backends_ms" in r:
                print(f"[times] {name} {where} SDPA by backend: "
                      + ", ".join(f"{b} {v if isinstance(v, str) else f'{v:.5f} ms'}"
                                  for b, v in r["sdpa_backends_ms"].items()),
                      flush=True)
            if "library" in r:
                lib = r["library"]
                print(f"[times] {name} {where} yardstick: {lib['call']}: "
                      + (f"{lib['ms']:.5f} ms, max|d| {lib['max_abs_err']:.3g}"
                         if "ms" in lib else f"not built: {lib['error']}"),
                      flush=True)
            if "passes_us" in r:
                per = ", ".join(f"{k} {v:.2f} us"
                                for k, v in r["passes_us"].items())
                print(f"[times] {name} {where} by pass (torch.profiler): "
                      f"{per or 'no device time in the trace'}",
                      flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch is not beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    # torch.compile (the flex_attention yardstick) builds inside the
    # checkout, in one process
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(HERE, "build", sub))
    os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels.build import build_all

    # float32 products in full float32, as the plain versions' reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, Python {sys.version.split()[0]}",
          flush=True)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"[device] built {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    inputs, table = kernel_table()
    errs = phase_parity(dev, inputs, table)
    _require(not torch.backends.cuda.matmul.allow_tf32,
             "TF32 products are on: the plain versions' einsums would "
             "not be float32")
    errs.update(phase_fleet_parity(dev))
    functional = phase_functional(dev)
    dse = phase_dse(dev, table)
    fleet_dse = phase_fleet_dse(dev)
    times = phase_times(dev, inputs, table)
    fleet_times = phase_fleet_times(dev)

    kernels = []
    for k in table:
        t = times[k["name"]][TILE]
        kernels.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": dse["launches"][k["name"]],
            "max_abs_err": errs[k["name"]],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": [TILE, TILE], "knobs": {"ports": 1, "unrolls": 8},
            "call_ms": t["call_ms"],
            "frame512": {key: times[k["name"]][FRAME][key] for key in
                         ("ms", "call_ms", "plain_ms", "bound_ms",
                          "library_ms")},
        })
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "bound_3xtf32_ms", "blocks", "chunk", "run_chunk")
    for k in FLEET_KERNELS:
        rows = fleet_times[k["name"]]
        t = rows["dse"]
        entry = {
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": fleet_dse["launches"][k["name"]],
            "max_abs_err": errs[k["name"]],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
            "shape": "fleet DSE", "knobs": ({"ports": 2, "unrolls": 8}
                                            if k["name"] == "flash_attention"
                                            else {"ports": 1, "unrolls": 8}),
        }
        if "bound_3xtf32_ms" in t:
            entry["bound_3xtf32_ms"] = t["bound_3xtf32_ms"]
        for where, r in rows.items():
            if where.startswith("model"):
                entry[where.replace(" ", "_").replace("model", "model_width",
                                                      1)] = {
                    key: r[key] for key in keep if key in r}
        kernels.append(entry)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": kernels,
                       "functional": functional, "dse": dse,
                       "fleet_dse": fleet_dse, "times": times,
                       "fleet_times": fleet_times}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
