#!/usr/bin/env python3
"""Drive the PyTorch/CUDA package of COSMOS on one NVIDIA card and check it.

    python3 chip_smoke.py [--out PATH]

Run from a checkout of the repository; it needs one CUDA card, ``nvcc``
(on PATH or under /usr/local/cuda) and nothing else.  Phases, each of
which fails the run on any error:

  1. device  — the card's name and power limit; build every kernel
     under ``src/repro_torch/csrc`` (one nvcc per source, in parallel);
  2. parity  — every WAMI kernel against its plain PyTorch version on
     the card, at tiles 64 and 128 (the tiles the WAMI drives run at)
     and at the 512x512 frame, over the stage's
     Table-1 knob points (the Hessian over every dividing point of its
     Table-1 grid, and the same bits on three runs; tolerance max|d| /
     max(1, max|ref|): 1e-5, Hessian 1e-4; the change-detection mask
     exactly equal; debayer, grayscale, gradient, steepest descent and
     warp the same bits), debayer also on a 30x64 frame whose 5-row
     blocks do not align to the Bayer quad, every run-of-4 kernel also
     on 30x66 (W % 4 != 0), and on 32x72 or 64x72 frames (tiles off the
     16-byte grid: the scalar head and tail of the runs of 4), warp also
     at the DSE's affine parameters (which clamp at the border; on the
     odd frames too), and every parity case a registered app declares
     (``App.parity_cases``, the list the lint checks: WAMI's seven
     stages at tiles 64 and 128, the fleet's two kernels), at (1, 8);
     then, with TF32 products off, flash attention at every knob point
     of the fleet DSE in f32 (3xTF32 mma.sync) and bf16 (wgmma, TMA), at
     tests/test_kernels.py's shapes in both, its window and soft-cap
     cases and head dim 256 at the gemma blocks, the reference's four
     blockings (the spread across them printed), head dims 80, 128, 100,
     50, 33, 20, 24, 200 and 250 (every general body), decode, blocks
     of 12 and 20 over 1,500 keys, and head dims 257, 320, 384, 512 and
     513 (the wide body, a launch per 256-column slice of V, at every
     native slice width; window, soft-cap, decode and ragged blocks at
     the larger ones) (max|d| < 2e-5 in f32, 2e-2 in bf16;
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
     recording is replayed and must give the same front; the walls per
     knob point of the redesigned WAMI kernels print beside those of
     their earlier kernels (``PREV_WALLS_US``); the
     analytical fleet drive on the H100 chip table follows.  Then the
     share-PLM drives, each its own path with its counts zeroed just
     before and read just after: ``build_session("wami", "cuda",
     share_plm=True, mode="record", tiles=(64, 128),
     verify_plans=True)`` over the tile-128 recording of the WAMI drive
     (only new points are timed; the calibrated fallback is fitted from
     its walls) and a fresh tile-64 one, and ``build_session("fleet",
     "cuda", share_plm=True, mode="record")`` into a fresh recording
     (every fleet stage has a kernel, so nothing is priced through the
     calibrated fallback, which a fresh recording cannot fit);
     each replays to the same front, every point's planned cost is at
     most its per-component sum, every plan is re-proved by the
     verifier, at every WAMI point the structural-only plan (the one
     the planner weighs the schedule-aware plan against) shares banks
     only within the LK loop and costs no less than the plan chosen, on
     some point it shares the LK loop's certified banks, and every
     kernel of each drive launches.  Then the DSE
     service (``[service]``), its counts zeroed just before and read
     just after: ``DSEService(max_pending=8, workers=3)`` serves six
     tenants at once (``SERVICE_TENANTS``) over four pools, three of
     which time the kernels live (the share-PLM WAMI drive over this
     run's recordings, the fleet, and two WAMI tenants sharing pool D);
     every tenant's front and invocations must equal an isolated
     session's over its pool's prices, pool D must time no point twice
     and at most 1.5x phase 4's wall at any point both timed, every
     kernel must launch, and the Chrome trace (``build/``) must pass the
     schema with outcomes equal to the tenants' ledgers.  Then the SoC
     layer (``[soc]``), its counts zeroed just before its fronts are
     resolved and read just after: each registered app alone, its front
     resolved by ``SoCComposer`` on the ``cuda`` backend (every kernel
     timed live), then ``wami=0.6,fleet=0.4`` over this run's card
     fronts (WAMI's share-PLM one), each priced through the app's unit
     system fitted from this run's recording and composed under
     ``sys_medium`` (an infeasible budget is printed with its field)
     and under budgets at 4x the minimal configuration at 45 and 16
     nm, greedy and exhaustive (greedy never above the optimum); every
     composition re-proved against its fronts, recomposed identically
     by a fresh composer, round-tripped and written to ``build/soc/``,
     which the verify CLI and SOC001 pass; the analytical compose CLI
     in a subprocess equals the in-process composition; the trace holds
     one ``soc.compose`` span per call.  Then the lint (``[lint]``):
     its shared-memory constant is the card's, the registry gives no
     finding (every declared card recording is committed), this run's
     recordings pass with REG003 only for tile 256, which the run does
     not record, and the CLI exits 0.  Then the record/replay workflow
     (``[record]``), as a user runs it: ``python3 -m
     repro_torch.examples.wami_cuda --record --tile 128`` and
     ``python3 -m repro_torch.examples.fleet_cuda --record`` into a
     fresh directory, each in a subprocess whose printed launch counts
     must hold all nine kernels; each fresh recording replayed here must
     give the front and invocations its recorder printed, and its walls
     print beside the committed recording's (median and range of the
     ratios; not gated); then each committed card recording
     (``artifacts/measurements/wami_cuda_tile{64,128,256}.json``,
     ``fleet_cuda.json``) and the share-PLM drive over tiles 64 and 128
     (``repro_torch.examples.wami_plm``) replay on the card to the
     pinned numbers (``CARD_RECORDINGS``, ``CARD_PLM_LINES``) and to
     their replays on the CPU.  A measured
     WAMI drive through a durable cache is then killed after 40 flushed
     points and resumed in a new process (``[kill-resume]``: fewer
     timings, replays, the final cache's front), and the analytical
     drives check whole-grid pricing and the guided walk
     (``[pricing]``);
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
     its bound at the 3xTF32 rate, and SDPA under each backend), at head
     dim 512 (the wide body, f32 and bf16, beside SDPA's math backend)
     and at model width (a gemma2-9b local layer at each of
     GEMMA_BLOCKS, with ``flex_attention`` under ``torch.compile`` as its
     yardstick; a mamba2-780m layer at chunk 64 and at its own chunk
     256).  The warp's yardstick is ``grid_sample`` (bilinear, border
     padding, ``align_corners``) on a grid built outside the timed call;
     its max|d| against the plain version prints for information;
  6. lm-serve — the LM serving path (``[lm-serve]``: configs ->
     ``SyntheticLM`` -> ``build_model`` -> ``ServeEngine``), whose models
     compute attention and the SSD in plain PyTorch as the JAX package's
     do: every arch at ``.reduced()`` (float32, TF32 off) with the same
     weights on the card and on the CPU — prefill and next-step logits
     within max|d| / max|ref| <= 1e-4, greedy ``generate`` tokens (8,
     whisper with frames) equal (from a step whose top-2 logits lie
     within 1e-4 relative on the CPU, teacher-forced along the CPU's
     tokens); then gemma2-9b and zamba2-2.7b at full width in bfloat16,
     random weights from seed 0, each freed before the next: six
     ``SyntheticLM`` requests through ``ServeEngine(slots=4,
     prompt_len=128, max_new=16)`` (two bursts, the second padded),
     every request 16 tokens, the first burst equal to ``generate``'s,
     whose first token is a manual prefill's argmax; prefill(129)
     against prefill(128) + one decode step (gemma) or prefill(136)
     against prefill(128) + eight (zamba2's SSD chain), in bfloat16
     within 3e-2 relative (zamba2 1e-1: the JAX package's prefill and
     decode round differently in bfloat16) and again in float32 (the
     weights upcast) within 1e-3; layer 0 (zamba2: the shared block and
     the first Mamba layer) in float32, card against CPU, within 1e-4;
     parameter GB, init s, prefill ms, ms a decode step, tok/s and peak
     memory printed.  Last, flash attention and the SSD scan timed at
     the served shapes beside the models' own ``attention_core`` and
     ``_ssd_chunked`` on the same inputs (routed nowhere), max|d|
     printed against the kernels' tolerances (bf16 2e-2; SSD 1e-4 x
     max(1, max|ref|)): gemma2-9b prefill and its last decode step (one
     query over 143 keys, blocks (1, 13)), zamba2-2.7b attention (d 80)
     and SSD (H 80, P 64, N 64, chunk 256 clipped to 128);
  7. lm-train — the LM training path (``[lm-train]``: configs ->
     ``build_model`` -> ``init_opt`` -> ``make_train_step`` ->
     ``DataPipeline`` -> ``Watchdog`` -> ``AsyncCheckpointer``, through
     ``launch.train.run``), plain PyTorch and autograd as the JAX
     package trains through ``jax.grad`` of plain code: every arch at
     ``.reduced()`` (float32, TF32 off), card against CPU from the same
     weights — loss, grad norm and every gradient leaf of one step
     within 1e-4, and AdamW's float32 and 8-bit updates from the CPU's
     gradients within 1e-6 (parameters, moments, scales; int8 codes at
     most one step apart in at most 1e-3 of them); then qwen2-0.5b at
     full width and depth in bfloat16 through the launcher (40 steps of
     16 x 128, checkpoints every 20): the mean loss of the last 5 steps
     at least 0.05 below the first 5's, every loss and grad norm finite;
     the same run in a child process SIGKILLed once ``LATEST`` reads
     20, resumed by the launcher, its steps 21-40 within 1e-2 of the
     uninterrupted run's losses, the step-20 checkpoint restored onto
     the card bit for bit and written again by ``save_async`` into the
     same files (snapshot ms, write s and GB printed); the loop's ms a
     step with and without its per-step loss read, kernels a step, the
     device's idle share and the top kernels by device time
     (``torch.profiler``), and the models' layer split (one ``unbind``
     a stacked leaf) against indexing each layer, in turns; last
     zamba2-2.7b at full width, 6 steps of 4 x 512 with microbatches 2, remat full and
     8-bit moments: finite, its float32 state at least 3.9x the 8-bit
     state's bytes.  The kernels' counts are zeroed before the
     full-width drives and read after (none is on this path);
  8. lm-dryrun — the sharded dry run (``[lm-dryrun]``, in a child
     process, ``chip_smoke.py --lm-dryrun-child OUT``, since a process
     group belongs to the whole process; its files under
     ``build/lm_dryrun/``): (a) ``repro_torch.examples.autoshard``
     (the JAX package's ``examples/autoshard.py``) at the card's 80 GB —
     ``choose_train_knobs`` for every arch on
     train_4k over (data 16, model 16) through one ledger, equal to the
     reference's plans (``LM_DRYRUN_PLANS``), 60 priced; the elastic
     re-plan of gemma2-9b on ``ft.replan((2, 16, 16), ..., 500)``; the
     unchanged stage again with 0 new invocations; (b)
     ``launch.dryrun.run_cell`` over ``LM_DRYRUN_CELLS`` at full width
     and depth on a fake group of 256 or 512 ranks (rank 0's program
     traced by ``make_fx`` over fake tensors on the card): status,
     trace s, the memory triple, FLOPs and bytes a device, collective
     bytes by kind, the roofline on the H100 table, and the planned
     bytes beside argument + temp for the train cells; (c) the mapped
     rung of qwen2-0.5b x train_4k x pod (mb 1 dots) traces past the
     card's memory, so the ladder's rung that runs, mb 2 full
     (``LM_DRYRUN_RUNG``), is traced and run for real: rank 0's partition on the card with real
     tensors, one warm-up step and two timed, ``max_memory_allocated``
     beside the traced and the planned bytes, ms a step beside the
     roofline compute term (the fake group moves no data: the loss is
     not checked).  No kernel is on this path; the child's counts come
     back.

The line before the last lists every kernel as JSON; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, it exits 2 and prints no result.  ``--out`` also
writes every number of the run to a JSON file.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# an H100 SXM's published peaks, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12         # float32 outside the tensor cores
TILE, FRAME = 128, 512
# the tiles the WAMI drives run the kernels at: the plain drive's 128 and
# the share-PLM drive's tile axis
WAMI_TILES = (64, TILE)
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


# Odd frames of grayscale and steepest descent, which with the knob
# points of the 128 and 512 frames run every body of each
# (csrc/wami_common.cuh's Run4Body): one pixel a thread (30 x 64 at
# (4, 3); at (2, 5) too in grayscale), whole runs (30 x 64 at (1, 5);
# staged stores in steepest descent), scalar throughout (30 x 66, W % 4
# != 0, at (2, 15), above both one-pixel-a-thread limits), and runs
# between a scalar head and tail (32 x 72's 18- and 9-column tiles, off
# the 16-byte grid, at (4, 16) and (8, 32)).
ODD_FRAMES_RUN4 = [((30, 64), [(2, 5), (1, 5), (4, 3)]),
                   ((30, 66), [(11, 5), (2, 3), (1, 1), (2, 15)]),
                   ((32, 72), [(4, 16), (8, 32), (4, 8)])]


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
        # the warp's source coordinates at p, normalised for grid_sample
        # (align_corners: -1 and 1 are the first and last pixel centres)
        p = x["p"]
        yy, xx = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        sx = (1.0 + p[0]) * xx + p[1] * yy + p[2]
        sy = p[3] * xx + (1.0 + p[4]) * yy + p[5]
        x["grid"] = torch.stack((2.0 * sx / (W - 1) - 1.0,
                                 2.0 * sy / (H - 1) - 1.0), -1)[None]
        return x

    def grid_sample(x):
        """The warp as one library call: bilinear, border padding, on
        the grid built outside the call."""
        return torch.nn.functional.grid_sample(
            x["gray"][None, None], x["grid"], mode="bilinear",
            padding_mode="border", align_corners=True)[0, 0]

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
             args=("rgb",), knobs=knobs, tol=1e-5, exact=True,
             odd_frames=ODD_FRAMES_RUN4,
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
             knobs=sd_knobs, tol=1e-5, exact=True,
             odd_frames=ODD_FRAMES_RUN4, bytes_px=32, flops_px=4,
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
             args=("gray", "p"), knobs=sd_knobs, tol=1e-5, exact=True,
             # the DSE's p, whose source cells clamp at the border (on
             # the odd frames too)
             alt_args=[("gray", "p_dse")],
             # a thread a pixel up to 1,024 pixels a tile; above it whole
             # runs (30 x 64 at (1, 30)), scalar throughout (30 x 66,
             # W % 4 != 0, at (1, 30)) and runs between a scalar head and
             # tail (64 x 72's 18-column tiles at (4, 64))
             odd_frames=[((30, 64), [(2, 5), (1, 5), (4, 3), (1, 30)]),
                         ((30, 66), [(11, 5), (2, 3), (1, 1), (1, 30)]),
                         ((64, 72), [(4, 64), (8, 32), (4, 8)])],
             bytes_px=8, flops_px=22, bytes_fixed=6 * 4,
             library=grid_sample,
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
        for n in (*WAMI_TILES, FRAME):
            yield n, n, names, k["knobs"]
    for (H, W), knobs in k.get("odd_frames", []):
        for names in [k["args"]] + k.get("alt_args", []):
            yield H, W, names, knobs


# tolerance of a registered app's parity case, max|d| / max(1, max|ref|)
PARITY_CASE_TOL = {"wami_hessian": 1e-4, "flash_attention": 2e-5,
                   "ssd_scan": 1e-4}


def _parity_tiles(app):
    """The tiles an app's drives run its kernels at (the native tile and
    the share-PLM tile axis); None for an app whose kernels have no tile
    (its parity cases take their default size)."""
    return sorted({app.native_tile, *app.plm_tile_sizes_measured}
                  - {0}) or [None]


def phase_parity(dev, inputs, table):
    """Every kernel against its plain version on the card, then the
    parity cases every registered app declares (``App.parity_cases``,
    the list the lint checks); returns the largest absolute error per
    kernel."""
    import torch
    from repro_torch.core import list_apps
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
    for app in list_apps():
        for tile in _parity_tiles(app):
            cases = (app.parity_cases(device=dev) if tile is None
                     else app.parity_cases(tile, device=dev))
            for name, op, ref, args in cases:
                got, want = op(*args, ports=1, unrolls=8), ref(*args)
                torch.cuda.synchronize(dev)
                d = _check_outputs(
                    f"{name} ({app.name} parity case, tile {tile})", got,
                    want, PARITY_CASE_TOL.get(name, 1e-5))
                print(f"[parity] {app.name} parity case {name} at tile "
                      f"{tile or 'default'}: max|d| {d:.3g} at (1, 8)",
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


def phase_dse(dev, table, rec_dir):
    """The main path: record-mode COSMOS session + exhaustive baseline
    over one CudaOracle, recording into ``rec_dir``.  Launch counts are
    zeroed just before and read just after."""
    import torch
    from repro_torch.apps.wami import (wami_cuda_oracle, wami_cuda_session,
                                       wami_knob_spaces)
    from repro_torch.core import (MeasurementSet, MeasurementStore,
                                  OracleLedger, exhaustive_dse)
    path = os.path.join(rec_dir, f"wami_cuda_tile{TILE}.json")
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
            "front_points": _front_points(res),
            "mapped": len(res.mapped), "wall_s": wall, "walls": walls,
            "smem_budget": oracle.smem_budget}


def _front_points(res):
    """(theta, cost) of the mapped points on a result's front."""
    return [[p.perf, p.cost] for p in res.pareto()]


def _share_plm_drive(tag, app, dev, counters, plain, **opts):
    """One share-PLM drive of ``app`` on the card: a record-mode
    ``build_session(app, "cuda", share_plm=True, verify_plans=True)``
    with the launch counts zeroed just before and read just after, then
    a replay of the recordings, which must give the same front.  Every
    mapped point's planned cost must be at most its per-component sum
    (relative 1e-12: the two sums add the same areas in another order);
    every emitted plan was re-proved sound by the verifier."""
    import torch
    from repro_torch.core import MeasurementStore, build_session
    before = {}
    for t in opts.get("tiles") or app.default_tiles:
        path = app.measurement_path(t)
        before[t] = (len(MeasurementStore.load(path))
                     if os.path.exists(path) else 0)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    session = build_session(app, "cuda", share_plm=True, mode="record",
                            verify_plans=True, device=dev, **opts)
    res = session.run()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    session.ledger.tool.flush()
    stores = {store.tile: len(store)
              for store in session.ledger.tool.measurements.stores()}
    res2 = build_session(app, "cuda", share_plm=True, mode="replay",
                         verify_plans=True, device=dev, **opts).run()
    print(f"[share-plm] {tag}: record, tiles {sorted(stores)}, "
          f"{wall:.2f} s of host clock; invocations {res.invocations} "
          f"(total {res.total_invocations}; plain drive "
          f"{sum(plain['cosmos'].values())}); recorded points per tile "
          f"{stores} (before the drive: {before}); launches in the drive: "
          f"{launches}", flush=True)
    print(f"[share-plm] {tag} front, (theta, cost B): plain "
          + ", ".join(f"({t:.6g}, {c:.6g})" for t, c in plain["front_points"])
          + "; shared " + ", ".join(
              f"({p.perf:.6g}, {p.cost:.6g})" for p in res.pareto()),
          flush=True)
    for m in sorted(res.mapped, key=lambda m: m.theta_actual):
        print(f"[share-plm] {tag} point theta {m.theta_actual:.6g}: cost "
              f"{m.cost_actual:.6g} B (unshared {m.cost_unshared:.6g}); "
              f"groups {[list(g) for g in m.plm_groups]}", flush=True)
    dead = [n for n, c in launches.items() if c <= 0]
    _require(not dead, f"{tag}: kernels never launched on the share-PLM "
                       f"drive: {dead}")
    # the calibrated fallback was fitted from the native recording as it
    # stood; the replay refits from the recording as it stands now
    native = app.native_tile
    _require(not before.get(native) or stores[native] == before[native],
             f"{tag}: the drive added points to the native recording, so "
             f"its replay fits the calibrated fallback from another one")
    _require(res.mapped and all(
        math.isfinite(m.theta_actual) and m.theta_actual > 0
        and m.cost_unshared is not None
        and m.cost_actual <= m.cost_unshared * (1 + 1e-12)
        for m in res.mapped),
        f"{tag}: a mapped point's planned cost exceeds its "
        f"per-component sum")
    _require(repr(res2.mapped) == repr(res.mapped),
             f"{tag}: replaying the share-PLM recordings changed the front")
    print(f"[share-plm] {tag}: replay of the recordings reproduces the "
          f"front", flush=True)
    return session, res, {"launches": launches,
                          "invocations": res.invocations,
                 "wall_s": wall, "recorded_points": stores,
                 "front_points": _front_points(res),
                 "points": [[m.theta_actual, m.cost_actual,
                             m.cost_unshared, [list(g) for g in m.plm_groups]]
                            for m in res.mapped]}


def phase_share_plm(dev, table, rec_dir, dse, fleet_dse):
    """The memory side of COSMOS on the card: the share-PLM WAMI drive
    over tiles 64 and 128 (the tile-128 recording is phase 4's, so only
    new points are timed, and the calibrated fallback is fitted from the
    card's own tile-128 walls; tile 64 is recorded afresh), then the
    fleet's, recorded afresh.  The LK-loop group the TMG certifies must
    form on some WAMI point: each point's structural-only plan, which
    the planner weighs against the schedule-aware one and which depends
    only on the point's PLM requirements, must share banks within the
    LK loop alone and on some point must share them; the plan chosen
    may mix in a schedule-certified stage wherever that is cheaper, so
    which groups it forms moves with the live walls."""
    import dataclasses
    from repro_torch.apps.wami import wami_tmg
    from repro_torch.core import exclusive_pairs, get_app
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    wami = dataclasses.replace(
        get_app("wami"), measurement_path=lambda t: os.path.join(
            rec_dir, f"wami_cuda_tile{t}.json"))
    session, res, out_wami = _share_plm_drive(
        "wami", wami, dev, {k["name"]: k["counter"] for k in table}, dse,
        tiles=WAMI_TILES)
    certified = exclusive_pairs(wami_tmg())

    def in_loop(g):
        return all(frozenset((u, v)) in certified
                   for i, u in enumerate(g) for v in g[i + 1:])

    lk, chosen = set(), set()
    for m in res.mapped:
        reqs = [r for g in m.memory_plan.groups for r in g.requirements]
        base = session.memory_planner.plan(reqs)
        shared = [g.members for g in base.groups if len(g.members) > 1]
        _require(all(in_loop(g) for g in shared),
                 f"wami: a structural-only plan shares banks outside the "
                 f"LK loop: {shared}")
        _require(m.memory_plan.system_cost <= base.system_cost,
                 f"wami: the plan chosen at theta {m.theta_actual:.6g} "
                 f"costs more than the structural-only one")
        lk.update(shared)
        chosen.update(g for g in m.plm_groups
                      if any(frozenset((u, v)) in certified
                             for i, u in enumerate(g) for v in g[i + 1:]))
    _require(lk, "wami: no point shares the LK loop's certified banks")
    out_wami["lk_groups"] = [list(g) for g in sorted(lk)]
    print(f"[share-plm] wami: groups the one-token LK cycle certifies in "
          f"the structural-only plans: {sorted(lk)}; chosen groups holding "
          f"a certified pair: {sorted(chosen)}", flush=True)
    fleet = dataclasses.replace(
        get_app("fleet"), measurement_path=lambda t=0: os.path.join(
            rec_dir, "fleet_share_plm_cuda.json"))
    _, fleet_res, out_fleet = _share_plm_drive(
        "fleet", fleet, dev, {"flash_attention": flash_attention_kernel,
                              "ssd_scan": ssd_scan_kernel}, fleet_dse)
    return ({"wami": out_wami, "fleet": out_fleet},
            {"wami": res.pareto(), "fleet": fleet_res.pareto()})


# ----------------------------------------------------------------------
# the DSE service on the card
# ----------------------------------------------------------------------
# (tenant, app, backend, delta, share_plm, tiles), all submitted at once:
# t0-t3 the JAX package's acceptance run (its t2 on the pallas backend),
# t4 and t5 two tenants whose live kernel timings share one pool
SERVICE_TENANTS = (
    ("t0", "wami", "analytical", None, False, None),
    ("t1", "wami", "analytical", 0.5, False, None),
    ("t2", "wami-card", "cuda", None, True, WAMI_TILES),
    ("t3", "fleet", "cuda", None, False, None),
    ("t4", "wami", "cuda", None, False, None),
    ("t5", "wami", "cuda", 0.5, False, None),
)
# the pool of t4 and t5
POOL_D = ("wami", "cuda", False, ())
# the killed drive is stopped once its cache's newest step holds this
# many points
KILL_AFTER_ENTRIES = 40


class _PoolReplay:
    """A tool that answers from a pool's cache (keyed as the ledger keys
    a point) and takes facts and memory demands from the pool's own
    tool: an isolated session over it sees the prices the pool's tenants
    saw, with no kernel timed again."""

    def __init__(self, entries, tool):
        self.entries, self.tool = entries, tool

    def synthesize(self, component, *, unrolls, ports, max_states=None,
                   tile=0):
        key = (component, unrolls, ports, max_states, tile)
        try:
            return self.entries[key]
        except KeyError:
            raise KeyError(f"{key} is not in the pool's cache") from None

    def cdfg_facts(self, component, synth):
        return self.tool.cdfg_facts(component, synth)

    def plm_requirement(self, component, synth):
        return self.tool.plm_requirement(component, synth)


@contextlib.contextmanager
def _counting_timings():
    """Counts, per ``CudaOracle`` (by ``id``), the kernel timings it
    makes on the card while the block runs."""
    from repro_torch.core.cuda_oracle import CudaOracle
    counts, lock = collections.Counter(), threading.Lock()
    plain = CudaOracle._time_runner

    def counted(self, runner):
        with lock:
            counts[id(self)] += 1
        return plain(self, runner)

    CudaOracle._time_runner = counted
    try:
        yield counts
    finally:
        CudaOracle._time_runner = plain


def _kernel_points(cache):
    """The distinct kernel timings behind a pool's cached points: a
    point priced by a kernel carries its wall; points that differ only
    in their state cap share one timing."""
    return {(k[0], k[1], k[2], k[4]) for k, s in cache.entries().items()
            if "wall_s" in (s.detail or {})}


def _tenant_of(tracer):
    """span -> the tenant whose ``service.run`` span it descends from."""
    by_id = {s.span_id: s for s in tracer.spans()}

    def tenant(span):
        while span is not None:
            if span.name == "service.run":
                return span.attrs["tenant"]
            span = by_id.get(span.parent_id)
        return None
    return tenant


def phase_service(dev, table, rec_dir, dse):
    """The DSE service on the card: six tenants over four pools, three of
    them timing the kernels live.  Each tenant's front and invocations
    must equal an isolated session's over the same prices; pool D must
    time no point twice, at walls within 1.5x phase 4's; the Chrome
    trace must validate and reconcile with the ledgers."""
    import dataclasses

    import torch
    from repro_torch.core import (DSEQuery, Tracer, WallClock,
                                  build_query_session, get_app, registry,
                                  register_app)
    from repro_torch.core.cuda_oracle import CudaOracle
    from repro_torch.core.obs import validate_chrome
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    from repro_torch.serve import DSEService
    # the card's own recordings: phase 4's tile 128 (which fits the
    # share-PLM fallback) and the share-PLM phase's tile 64
    register_app(dataclasses.replace(
        get_app("wami"), name="wami-card",
        measurement_path=lambda t: os.path.join(
            rec_dir, f"wami_cuda_tile{t}.json")))
    counters = {k["name"]: k["counter"] for k in table}
    counters.update(flash_attention=flash_attention_kernel,
                    ssd_scan=ssd_scan_kernel)
    queries = [DSEQuery(app=a, backend=b, delta=d, share_plm=s, tiles=t,
                        tenant=n) for n, a, b, d, s, t in SERVICE_TENANTS]
    tracer = Tracer(WallClock())
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with _counting_timings() as timed:
        with DSEService(max_pending=8, workers=3, tracer=tracer) as svc:
            handles = {h.query.tenant: h
                       for h in svc.submit_all(queries, timeout=600)}
            results = {n: h.result(timeout=900) for n, h in handles.items()}
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            launches = {n: c.launches for n, c in counters.items()}
            stats = svc.stats()
            pools = dict(svc._pools)
    by_slug = {p.slug: p for p in pools.values()}

    # 1. each tenant's front and books equal an isolated session's
    for n, h in handles.items():
        q = h.query
        tool = None
        if q.backend != "analytical":
            pool = pools[q.pool_key]
            tool = _PoolReplay(pool.cache.entries(), pool.oracle.tool)
        iso = build_query_session(q, tool=tool)
        ref = iso.run()
        _require(repr(ref.planned) == repr(results[n].planned)
                 and repr(ref.mapped) == repr(results[n].mapped),
                 f"service: {n}'s front differs from an isolated session's")
        _require(dict(iso.ledger.invocations) == h.invocations(),
                 f"service: {n}'s invocations {h.invocations()} differ from "
                 f"an isolated session's {dict(iso.ledger.invocations)}")
        _require(all(math.isfinite(m.theta_actual) and m.theta_actual > 0
                     for m in ref.mapped), f"service: {n}'s front")
    # 2. four pools, and the pools paid less than the tenants' sum
    tenant_sum = sum(sum(h.invocations().values())
                     for h in handles.values())
    _require(len(pools) == 4, f"service: {sorted(by_slug)} pools, not 4")
    _require(stats["shared_invocations"] < tenant_sum,
             f"service: shared {stats['shared_invocations']} not below "
             f"the tenants' {tenant_sum}")
    # 3. no point timed twice: each of the three cuda pools (B, C, D)
    # timed each kernel point once, pool D's fresh points are t4's and
    # t5's distinct ones, and every kernel launched during the phase
    timings = {}
    for p in pools.values():
        if not isinstance(p.oracle.tool, CudaOracle):
            continue
        n_timed, points = timed[id(p.oracle.tool)], _kernel_points(p.cache)
        timings[p.slug] = {"timed": n_timed, "kernel_points": len(points)}
        _require(n_timed == len(points) > 0,
                 f"service: pool {p.slug} timed {n_timed} times for "
                 f"{len(points)} kernel points")
    _require(len(timings) == 3,
             f"service: {sorted(timings)} pools time on the card, not 3")
    d = pools[POOL_D]
    asked = {n: {(r.component, r.unrolls, r.ports, r.max_states, r.tile)
                 for r in handles[n].ledger.records} for n in ("t4", "t5")}
    d_out = d.oracle.outcome_counts()
    _require(d_out["fresh"] == len(asked["t4"] | asked["t5"]) == len(d.cache),
             f"service: pool D's fresh {d_out['fresh']} is not the "
             f"{len(asked['t4'] | asked['t5'])} distinct points t4 and t5 "
             f"asked for")
    tenant_of = _tenant_of(tracer)
    t5 = collections.Counter(s.attrs["outcome"]
                             for s in tracer.spans("shared.point")
                             if tenant_of(s) == "t5")
    dead = [n for n, c in launches.items() if c <= 0]
    _require(not dead, f"service: kernels never launched: {dead}")
    # 4. pool D's walls against phase 4's at the points both timed
    ratios = [
        (s.detail["wall_s"] / dse["walls"][k[0]][f"p{k[2]}:u{k[1]}"], k)
        for k, s in d.cache.entries().items()
        if "wall_s" in (s.detail or {})
        and f"p{k[2]}:u{k[1]}" in dse["walls"].get(k[0], {})]
    ratios.sort(key=lambda r: r[0])     # keys hold None: sort by ratio
    _require(ratios, "service: pool D timed no point phase 4 timed")
    worst, worst_key = ratios[-1]
    _require(worst <= 1.5,
             f"service: pool D's wall at {worst_key} is {worst:.3f}x "
             f"phase 4's (limit 1.5)")
    # 6. the trace: schema-valid, and its outcomes are the ledgers' sum
    trace_path = os.path.join(HERE, "build", "service.trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    doc = tracer.export_chrome(time_unit_us=1e6)
    with open(trace_path, "w") as f:
        json.dump(doc, f)
    errors = validate_chrome(doc)
    _require(not errors, f"service: trace violates the schema: "
                         f"{errors[:5]}")
    ledger_sum = collections.Counter()
    for h in handles.values():
        ledger_sum.update(h.outcome_counts())
    traced = tracer.outcome_counts()
    _require(traced == {o: n for o, n in ledger_sum.items() if n},
             f"service: trace outcomes {traced} != ledgers' {ledger_sum}")
    span_counts = dict(sorted(collections.Counter(
        s.name for s in tracer.spans()).items()))

    queued = {s.attrs["qid"]: s.end - s.start
              for s in tracer.spans("service.queued")}
    tenants = {n: {"wall_s": h.wall_s, "queue_wait_s": queued[h.qid],
                   "outcomes": h.outcome_counts(),
                   "invocations": sum(h.invocations().values()),
                   "pool": pools[h.query.pool_key].slug}
               for n, h in handles.items()}
    pool_rows = {p.slug: {"tenants": p.tenants,
                          **p.oracle.outcome_counts(),
                          **timings.get(p.slug, {})}
                 for p in pools.values()}
    print(f"[service] {len(handles)} tenants, {len(pools)} pools, "
          f"{wall:.2f} s of host clock; shared invocations "
          f"{stats['shared_invocations']} against the tenants' "
          f"{tenant_sum}", flush=True)
    for n, t in tenants.items():
        o = t["outcomes"]
        print(f"[service] tenant {n} ({t['pool']}): {t['wall_s']:.3f} s, "
              f"queue wait {t['queue_wait_s']:.3f} s, invocations "
              f"{t['invocations']}; fresh {o['fresh']}, cache_hit "
              f"{o['cache_hit']}, inflight_join {o['inflight_join']}, "
              f"replay {o['replay']}", flush=True)
    for slug, r in pool_rows.items():
        extra = (f"; kernel timings {r['timed']}" if "timed" in r else "")
        print(f"[service] pool {slug}: tenants {r['tenants']}; fresh "
              f"{r['fresh']}, cache_hit {r['cache_hit']}, inflight_join "
              f"{r['inflight_join']}, replay {r['replay']}{extra}",
              flush=True)
    print(f"[service] pool D: fresh {d_out['fresh']} = the distinct points "
          f"t4 and t5 asked for; t5 at the pool: cache_hit "
          f"{t5['cache_hit']}, inflight_join {t5['inflight_join']}, fresh "
          f"{t5['fresh']} (t5's points within t4's: "
          f"{asked['t5'] <= asked['t4']}); walls against phase 4's at "
          f"{len(ratios)} points: {ratios[0][0]:.3f}x..{worst:.3f}x "
          f"(worst at {worst_key})", flush=True)
    print(f"[service] launches in the phase: {launches}", flush=True)
    print(f"[service] trace {os.path.relpath(trace_path, HERE)}: "
          f"{len(doc['traceEvents'])} events, valid; outcomes {traced} "
          f"= the tenants' ledgers; spans {span_counts}", flush=True)
    print("[service] every tenant's front and invocations equal an "
          "isolated session's", flush=True)
    # the app over this run's recordings served this phase only: the
    # later phases walk the registry as the package fills it
    registry._APPS.pop("wami-card")
    return {"wall_s": wall, "tenants": tenants, "pools": pool_rows,
            "shared_invocations": stats["shared_invocations"],
            "tenant_invocations": tenant_sum, "launches": launches,
            "t5_at_pool": dict(t5),
            "t5_within_t4": asked["t5"] <= asked["t4"],
            "pool_d_wall_ratio": {"points": len(ratios), "min": ratios[0][0],
                                  "max": worst},
            "trace": {"events": len(doc["traceEvents"]),
                      "outcomes": traced, "spans": span_counts}}


def _cache_entries(root):
    """Points in the newest complete step of a cache directory (0 while
    there is none, or while the step read is pruned under the reader)."""
    from repro_torch.checkpoint import store
    step = store.latest_step(root)
    if step is None:
        return 0
    try:
        with open(os.path.join(root, f"step_{step:08d}",
                               "manifest.json")) as f:
            return len(json.load(f)["extra"]["entries"])
    except (OSError, ValueError, KeyError):
        return 0


def phase_kill_resume(dev):
    """A measured WAMI drive in a child process, through a durable cache
    flushed at every point, killed once ``KILL_AFTER_ENTRIES`` points are
    flushed; then the same drive in a new process over the same cache.
    The resumed run must time fewer points than the whole walk, replay
    the killed run's, and give the front a replay of the final cache
    gives."""
    import signal

    from repro_torch.checkpoint import store
    from repro_torch.core import PersistentOracleCache, build_session
    t0 = time.perf_counter()
    work = os.path.join(HERE, "build", "kill_resume")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    root = os.path.join(work, "cache")
    cmd = [sys.executable, os.path.abspath(__file__), "--kill-resume-child"]
    with open(os.path.join(work, "killed.log"), "w") as log:
        proc = subprocess.Popen(cmd + [root, os.path.join(work, "x.json")],
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            while proc.poll() is None and time.monotonic() < deadline:
                if _cache_entries(root) >= KILL_AFTER_ENTRIES:
                    proc.send_signal(signal.SIGKILL)
                    break
                time.sleep(0.005)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
    _require(proc.returncode == -signal.SIGKILL,
             f"kill-resume: the first drive ended with {proc.returncode} "
             f"before it was killed (log: {work}/killed.log)")
    steps = store.list_steps(root)
    killed_at = len(PersistentOracleCache(root))
    for step in steps:              # no torn step: every one restores
        store.restore(root, step, {"n_entries": 0})
    # a step the kill interrupted mid-write, as a crash leaves one
    torn = os.path.join(root, f"step_{steps[-1] + 1:08d}.tmp")
    os.makedirs(torn, exist_ok=True)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        f.write('{"step": ')
    out = os.path.join(work, "resumed.json")
    with open(os.path.join(work, "resumed.log"), "w") as log:
        rc = subprocess.run(cmd + [root, out], stdout=log,
                            stderr=subprocess.STDOUT, timeout=600).returncode
    _require(rc == 0, f"kill-resume: the resumed drive failed ({rc}; log: "
                      f"{work}/resumed.log)")
    with open(out) as f:
        resumed = json.load(f)
    final = PersistentOracleCache(root)
    walk_points = len(_kernel_points(final))
    with _counting_timings() as timed:
        replay = build_session("wami", "cuda", device=dev,
                               cache=PersistentOracleCache(root))
        res = replay.run()
    o = resumed["outcomes"]
    elapsed = time.perf_counter() - t0
    print(f"[kill-resume] {elapsed:.1f} s; killed after {killed_at} "
          f"flushed points (steps "
          f"{steps}); resumed: {resumed['timed']} kernel timings against "
          f"the walk's {walk_points}, fresh {o['fresh']}, replay "
          f"{o['replay']}, cache_hit {o['cache_hit']}, of "
          f"{resumed['total']} invocations; replay of the final cache: "
          f"fresh {replay.ledger.outcome_counts()['fresh']}, "
          f"{sum(timed.values())} timings", flush=True)
    _require(resumed["timed"] < walk_points and o["replay"] > 0
             and o["fresh"] < resumed["total"],
             f"kill-resume: the resumed drive re-paid the killed one's "
             f"points: {resumed}")
    _require(replay.ledger.outcome_counts()["fresh"] == 0
             and not sum(timed.values()),
             "kill-resume: the final cache does not hold the whole walk")
    _require(repr(res.planned) == resumed["planned"]
             and repr(res.mapped) == resumed["mapped"],
             "kill-resume: the resumed front differs from a replay of the "
             "final cache")
    print("[kill-resume] the resumed front equals a replay of the final "
          "cache; the leftover .tmp step was ignored", flush=True)
    return {"wall_s": elapsed, "killed_at": killed_at, "steps": steps,
            "timed": resumed["timed"], "walk_kernel_points": walk_points,
            "outcomes": o, "invocations": resumed["total"]}


def kill_resume_child(root, out, dev):
    """The drive ``phase_kill_resume`` runs in its child processes: the
    measured WAMI session through a cache at ``root`` flushed at every
    point; what it timed, its outcomes and its front go to ``out``."""
    from repro_torch.core import PersistentOracleCache, build_session
    with _counting_timings() as timed:
        session = build_session(
            "wami", "cuda", device=dev,
            cache=PersistentOracleCache(root, flush_every=1))
        res = session.run()
    with open(out, "w") as f:
        json.dump({"timed": sum(timed.values()),
                   "outcomes": session.ledger.outcome_counts(),
                   "total": session.ledger.total(),
                   "planned": repr(res.planned),
                   "mapped": repr(res.mapped)}, f)


def phase_pricing():
    """Whole-grid pricing and the guided walk on the analytical drives:
    WAMI's host time with and without ``batch_pricing`` (in turns:
    plain, grid, grid, plain) at an equal front, and the guided drive's
    invocations against the unguided one's for WAMI and for the fleet
    on the H100 chip table, with byte-identical fronts."""
    from repro_torch.core import build_session

    def drive(app, **kw):
        t0 = time.perf_counter()
        s = build_session(app, **kw)
        res = s.run()
        return time.perf_counter() - t0, s, res

    times = {"plain": [], "batch": []}
    fronts = set()
    for kind in ("plain", "batch", "batch", "plain"):
        dt, _, res = drive("wami", batch_pricing=kind == "batch")
        times[kind].append(dt)
        fronts.add((repr(res.planned), repr(res.mapped)))
    _require(len(fronts) == 1, "pricing: batch_pricing changed the front")
    guided = {}
    for app in ("wami", "fleet"):
        _, plain_s, plain = drive(app)
        _, guided_s, res = drive(app, guided=True)
        _require((repr(res.planned), repr(res.mapped))
                 == (repr(plain.planned), repr(plain.mapped)),
                 f"pricing: the guided {app} front differs")
        guided[app] = {"guided": guided_s.ledger.total(),
                       "unguided": plain_s.ledger.total()}
    print(f"[pricing] analytical WAMI drive, s of host clock: plain "
          f"{', '.join(f'{t:.3f}' for t in times['plain'])}, batch_pricing "
          f"{', '.join(f'{t:.3f}' for t in times['batch'])} (same front); "
          f"guided against unguided invocations: WAMI "
          f"{guided['wami']['guided']} vs {guided['wami']['unguided']}, "
          f"fleet (H100 chip table) {guided['fleet']['guided']} vs "
          f"{guided['fleet']['unguided']} (fronts byte-identical)",
          flush=True)
    return {"host_s": times, "invocations": guided}


# ----------------------------------------------------------------------
# the SoC composition layer and the lint on the card
# ----------------------------------------------------------------------
# each envelope of the card budgets is this multiple of the minimal
# configuration's charge (every app at its cheapest point, one replica),
# composed at these tech nodes
SOC_BUDGET_MULTIPLE = 4.0
SOC_TECH_NODES = (45, 16)
SOC_MIX = "wami=0.6,fleet=0.4"
# the lint's findings on the registry: none, every declared card
# recording committed
LINT_UNRECORDED = []


def _soc_json(comp):
    return json.dumps(comp.to_json(), sort_keys=True)


def _card_rates(rec_dir):
    """Each app's ``area_scale`` over fronts timed on the card: the
    default demand's rate (reference-node mm^2 per native unit of the
    analytical front) over the unit system's shared-memory bytes per
    native unit, fitted from this run's native recording (WAMI: phase 4's
    tile 128; the fleet: the share-PLM phase's)."""
    from repro_torch.apps.fleet import fleet_unit_system
    from repro_torch.apps.wami import wami_cuda_unit_system
    from repro_torch.core import MeasurementStore
    from repro_torch.core.soc import DEFAULT_DEMANDS
    units = {
        "wami": wami_cuda_unit_system(store=MeasurementStore.load(
            os.path.join(rec_dir, f"wami_cuda_tile{TILE}.json"))),
        "fleet": fleet_unit_system(store=MeasurementStore.load(
            os.path.join(rec_dir, "fleet_share_plm_cuda.json"))),
    }
    return {app: DEFAULT_DEMANDS[app]["area_scale"] / u.area_scale
            for app, u in units.items()}, units


def _card_budget(mix, fronts):
    """A custom budget at the reference node, as the compose CLI's
    ``--area/--power/--bw`` build one: each envelope
    ``SOC_BUDGET_MULTIPLE`` times the minimal configuration's charge."""
    from repro_torch.core.soc import SoCBudget
    from repro_torch.core.soc.compose import operating_points
    probe = SoCBudget("probe", area_mm2=1.0, power_w=1.0, bw_gbps=1.0)
    need = [0.0, 0.0, 0.0]
    for d in mix.demands:
        p = min(operating_points(fronts[d.app], d, probe),
                key=lambda p: (p.area_mm2, p.index))
        for i, charge in enumerate((p.area_mm2, p.power_w, p.bw_gbps)):
            need[i] += charge
    m = SOC_BUDGET_MULTIPLE
    return SoCBudget(f"card-{m:g}x-{mix.name}", area_mm2=m * need[0],
                     power_w=m * need[1], bw_gbps=m * need[2])


def _exhaustive_configs(budget, mix, fronts):
    """The configurations ``optimal_composition`` enumerates: per app,
    every (point, replicas) within the budget's caps, crossed over the
    apps (its own count, re-derived to be printed)."""
    from repro_torch.core.soc.compose import operating_points
    total = 1
    for d in mix.demands:
        n = 0
        for p in operating_points(fronts[d.app], d, budget):
            caps = [budget.area_mm2 / p.area_mm2,
                    budget.power_w / p.power_w if p.power_w > 0
                    else math.inf,
                    budget.bw_gbps / p.bw_gbps if p.bw_gbps > 0
                    else math.inf]
            n += int(min(caps) * (1 + 1e-12))
        total *= max(1, n)
    return total


class _SocRun:
    """The compositions of the ``[soc]`` phase: each is re-proved against
    its fronts, composed again by a fresh composer, round-tripped through
    JSON and written under ``out_dir``; ``calls``/``composed`` count the
    traced composers' ``compose()`` calls and their compositions."""

    def __init__(self, out_dir, tracer, metrics):
        self.out_dir, self.tracer, self.metrics = out_dir, tracer, metrics
        self.calls = self.composed = 0
        self.rows = []

    def compose(self, composer, method="greedy", *, tag):
        from repro_torch.core.soc import (BudgetInfeasibleError,
                                          SoCComposer, verify_composition)
        from repro_torch.core.soc.compose import Composition
        self.calls += 1
        t0 = time.perf_counter()
        try:
            comp = composer.compose(method)
        except BudgetInfeasibleError as e:
            if method != "greedy" or not tag.endswith("sys_medium"):
                raise
            row = {"tag": tag, "infeasible": e.budget_field,
                   "need": e.need, "limit": e.limit}
            print(f"[soc] {tag}: BudgetInfeasibleError on {e.budget_field} "
                  f"(the minimal configuration needs {e.need:.6g}, the "
                  f"preset allows {e.limit:.6g})", flush=True)
            self.rows.append(row)
            return None
        host_s = time.perf_counter() - t0
        self.composed += 1
        fronts = composer.fronts()
        violations = verify_composition(comp, fronts=fronts)
        _require(not violations, f"soc: {tag} {method}: {violations}")
        fresh = SoCComposer(comp.budget, comp.mix, fronts=fronts)
        _require(_soc_json(fresh.compose(method)) == _soc_json(comp),
                 f"soc: {tag} {method}: a fresh composer over the same "
                 f"fronts composed another chip")
        _require(_soc_json(Composition.from_json(comp.to_json()))
                 == _soc_json(comp),
                 f"soc: {tag} {method}: the JSON does not round-trip")
        path = os.path.join(self.out_dir,
                            f"{tag}-{method}.composition.json")
        with open(path, "w") as f:
            json.dump(comp.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        b = comp.budget
        row = {"tag": tag, "method": method, "tech_nm": b.tech_nm,
               "sustained_throughput": comp.sustained_throughput,
               "throughput_per_area": comp.throughput_per_area,
               "totals": [comp.area_mm2, comp.power_w, comp.bw_gbps],
               "envelopes": [b.area_mm2, b.power_w, b.bw_gbps],
               "allocations": [[a.app, a.point.index, a.replicas,
                                a.point.theta] for a in comp.allocations],
               "host_s": host_s}
        self.rows.append(row)
        print(f"[soc] {tag} {method} at {b.tech_nm} nm: sustained "
              f"{comp.sustained_throughput:.6g} req/s; "
              + ", ".join(f"{a.app} point {a.point.index} x {a.replicas} "
                          f"(theta {a.point.theta:.6g})"
                          for a in comp.allocations)
              + f"; area {comp.area_mm2:.6g}/{b.area_mm2:.6g} mm2, power "
              f"{comp.power_w:.6g}/{b.power_w:.6g} W, bw "
              f"{comp.bw_gbps:.6g}/{b.bw_gbps:.6g} GB/s; {host_s:.3f} s",
              flush=True)
        return comp

    def at_card_budgets(self, mix, fronts, tag):
        """Greedy and exhaustive at each of ``SOC_TECH_NODES`` under the
        card budget of ``mix``; greedy never beats the certified
        optimum."""
        from repro_torch.core.soc import SoCComposer
        from repro_torch.core.soc.compose import _MAX_CONFIGS
        base = _card_budget(mix, fronts)
        out = {}
        for tech in SOC_TECH_NODES:
            budget = base.at_tech(tech)
            configs = _exhaustive_configs(budget, mix, fronts)
            _require(configs <= _MAX_CONFIGS,
                     f"soc: {tag} at {tech} nm: {configs} configurations")
            comps = {m: self.compose(SoCComposer(
                budget, mix, fronts=fronts, tracer=self.tracer,
                metrics=self.metrics), m, tag=f"{tag}-{tech}nm")
                for m in ("greedy", "exhaustive")}
            g = comps["greedy"].sustained_throughput
            o = comps["exhaustive"].sustained_throughput
            _require(g <= o * (1 + 1e-12),
                     f"soc: {tag} at {tech} nm: greedy {g} above the "
                     f"exhaustive optimum {o}")
            gap = (o - g) / o
            out[tech] = {"configs": configs, "greedy": g, "exhaustive": o,
                         "gap": gap}
            print(f"[soc] {tag} at {tech} nm: the exhaustive packer "
                  f"enumerated {configs} configurations (guard "
                  f"{_MAX_CONFIGS}); greedy {g:.6g} against the optimum "
                  f"{o:.6g}: gap {gap:.4%}", flush=True)
        return out


def phase_soc(dev, table, rec_dir, plm_fronts):
    """The SoC composition layer on the card.  S1: each registered app
    alone, its front resolved by the composer on the ``cuda`` backend
    (``build_session(app, "cuda")`` in measure mode: every kernel of the
    app timed live, launches counted); S2: ``SOC_MIX`` over this run's
    card fronts (WAMI's share-PLM front of tiles 64 + 128, the fleet's
    S1 front); each priced through the app's unit system fitted from
    this run's recording, under ``sys_medium`` and under card budgets
    (``SOC_BUDGET_MULTIPLE`` x the minimal configuration) at
    ``SOC_TECH_NODES``, greedy and exhaustive.  S3: the analytical
    compose CLI in a subprocess equals the in-process composition.
    Every composition is re-proved, recomposed by a fresh composer and
    round-tripped; the verify CLI and SOC001 pass over what was
    written; the trace holds a ``soc.compose`` span per call."""
    import torch
    from repro_torch.core import (LogicalClock, MetricsRegistry, Tracer,
                                  list_apps)
    from repro_torch.core.analysis.lint import _lint_soc_artifacts
    from repro_torch.core.soc import SoCComposer, TrafficMix, get_budget
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    t_phase = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "soc")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rates, units = _card_rates(rec_dir)
    print("[soc] area rates over card fronts, reference-node mm^2 per "
          "shared-memory byte: "
          + ", ".join(f"{a} {r:.6g} (fitted {units[a].area_scale:.6g} B "
                      f"per native unit from {units[a].area_points} "
                      f"points)" for a, r in rates.items()), flush=True)
    tracer, metrics = Tracer(LogicalClock()), MetricsRegistry()
    run = _SocRun(out_dir, tracer, metrics)
    counters = {k["name"]: k["counter"] for k in table}
    counters.update(flash_attention=flash_attention_kernel,
                    ssd_scan=ssd_scan_kernel)

    # S1: each app alone; the first compose() resolves its front on the
    # card, under the sys_medium preset
    solo = {}
    s1_fronts = {}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    for app in list_apps():
        mix = TrafficMix.parse(
            f"{app.name}=1.0", name=f"{app.name}_solo_card",
            **{app.name: {"backend": "cuda", "share_plm": False,
                          "area_scale": rates[app.name]}})
        composer = SoCComposer(get_budget("sys_medium"), mix,
                               tracer=tracer, metrics=metrics)
        run.compose(composer, tag=f"{mix.name}-sys_medium")
        s1_fronts[app.name] = composer.fronts()[app.name]
        solo[app.name] = mix
    torch.cuda.synchronize(dev)
    s1_wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    print(f"[soc] S1: fronts resolved on the cuda backend in {s1_wall:.2f} "
          f"s of host clock: "
          + ", ".join(f"{a} {len(f)} points" for a, f in s1_fronts.items())
          + f"; launches {launches}", flush=True)
    dead = [n for n, c in launches.items() if c <= 0]
    _require(not dead, f"soc: kernels never launched resolving the "
                       f"fronts: {dead}")
    gaps = {}
    for app, mix in solo.items():
        gaps[mix.name] = run.at_card_budgets(
            mix, {app: s1_fronts[app]}, mix.name)

    # S2: the default mix over this run's card fronts
    mix = TrafficMix.parse(
        SOC_MIX, name="wami60_fleet40_card",
        wami={"backend": "cuda", "area_scale": rates["wami"]},
        fleet={"backend": "cuda", "area_scale": rates["fleet"]})
    fronts = {"wami": plm_fronts["wami"], "fleet": s1_fronts["fleet"]}
    _require(mix.demand("wami").share_plm, "soc: the mix's WAMI demand "
                                           "is not the share-PLM one")
    run.compose(SoCComposer(get_budget("sys_medium"), mix, fronts=fronts,
                            tracer=tracer, metrics=metrics),
                tag=f"{mix.name}-sys_medium")
    gaps[mix.name] = run.at_card_budgets(mix, fronts, mix.name)

    # S3: the analytical CLI on the card's host
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    cli_out = os.path.join(out_dir, "analytical.composition.json")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.soc.compose", "--mix",
         SOC_MIX, "--verify", "--out", cli_out], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    _require(cli.returncode == 0, f"soc: the compose CLI exited "
                                  f"{cli.returncode}: {cli.stderr[-2000:]}")
    analytical = SoCComposer(get_budget("sys_medium"),
                             TrafficMix.parse(SOC_MIX)).compose()
    with open(cli_out) as f:
        _require(json.dumps(json.load(f), sort_keys=True)
                 == json.dumps(json.loads(_soc_json(analytical)),
                               sort_keys=True),
                 "soc: the compose CLI's composition differs from the "
                 "in-process one")
    print(f"[soc] S3: python -m repro_torch.core.soc.compose --mix {SOC_MIX} "
          f"--verify: exit 0 in {cli_s:.1f} s, its JSON equals the "
          f"in-process analytical composition (sustained "
          f"{analytical.sustained_throughput:.6g} req/s, area "
          f"{analytical.area_mm2:.6g} mm2)", flush=True)

    # what was written re-proves from the files alone
    t0 = time.perf_counter()
    ver = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.soc.verify", out_dir],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    _require(ver.returncode == 0, f"soc: the verify CLI exited "
                                  f"{ver.returncode}: {ver.stdout[-2000:]}")
    n_files = len([n for n in os.listdir(out_dir)
                   if n.endswith(".composition.json")])
    findings = []
    _lint_soc_artifacts(findings, root=out_dir)
    _require(not findings, f"soc: SOC001 over {out_dir}: "
                           f"{[str(f) for f in findings]}")
    print(f"[soc] python -m repro_torch.core.soc.verify build/soc: exit 0 "
          f"over {n_files} compositions in {time.perf_counter() - t0:.1f} "
          f"s; SOC001 finds nothing", flush=True)

    # the trace: a soc.compose span per call, fronts and allocations
    # inside them, and the counters
    spans = tracer.spans()
    by_id = {s.span_id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    _require(names["soc.compose"] == run.calls,
             f"soc: {names['soc.compose']} soc.compose spans for "
             f"{run.calls} calls")
    _require(names["soc.front"] == len(s1_fronts),
             f"soc: {names['soc.front']} soc.front spans")
    _require(all(by_id[s.parent_id].name == "soc.compose"
                 for s in spans if s.name in ("soc.front", "soc.allocate")),
             "soc: a soc.front/soc.allocate span outside soc.compose")
    _require(names["soc.allocate"] >= 1,
             "soc: no greedy allocation was traced")
    _require(metrics.counter("soc.compositions").value == run.composed,
             f"soc: soc.compositions {metrics.counter('soc.compositions')}"
             f".value != {run.composed}")
    wall = time.perf_counter() - t_phase
    print(f"[soc] trace: {dict(sorted(names.items()))}; soc.compositions "
          f"{run.composed} of {run.calls} compose() calls; soc.moves "
          f"{metrics.counter('soc.moves').value}; phase {wall:.1f} s",
          flush=True)
    return {"launches": launches, "s1_wall_s": s1_wall,
            "rates": rates, "fronts": {a: [[p.perf, p.cost] for p in f]
                                       for a, f in s1_fronts.items()},
            "compositions": run.rows, "gaps": gaps,
            "analytical": json.loads(_soc_json(analytical)),
            "cli_s": cli_s, "spans": dict(names), "wall_s": wall}


def phase_lint(dev, rec_dir):
    """The static lint on the card's host: its shared-memory budget is
    the card's, the registry (every declared card recording committed)
    gives no finding, this run's recordings pass the schema (REG004)
    with no SPEC003 and one REG003 for each tile the run does not
    record, and the CLI exits 0 printing its ``lint ok`` line."""
    import dataclasses

    from repro_torch.core import get_app
    from repro_torch.core.analysis.lint import lint_all, lint_app
    from repro_torch.core.cuda_oracle import (H100_SMEM_OPTIN_BYTES,
                                              device_smem_budget)
    t0 = time.perf_counter()
    card = device_smem_budget(dev)
    _require(H100_SMEM_OPTIN_BYTES == card,
             f"lint: H100_SMEM_OPTIN_BYTES {H100_SMEM_OPTIN_BYTES} != the "
             f"card's {card}")
    findings = lint_all()
    keys = [(f.rule, f.app, f.subject) for f in findings]
    _require(keys == LINT_UNRECORDED, f"lint: {keys}")
    on_run = {
        "wami": dataclasses.replace(
            get_app("wami"), measurement_path=lambda t: os.path.join(
                rec_dir, f"wami_cuda_tile{t}.json")),
        "fleet": dataclasses.replace(
            get_app("fleet"), measurement_path=lambda t=0: os.path.join(
                rec_dir, "fleet_share_plm_cuda.json")),
    }
    run_findings = {}
    for name, app in on_run.items():
        unrecorded = [f"tile={t}" for t in app.recorded_tiles
                      if not os.path.exists(app.measurement_path(t))]
        got = lint_app(app)
        run_findings[name] = [str(f) for f in got]
        _require([(f.rule, f.subject) for f in got]
                 == [("REG003", s) for s in unrecorded],
                 f"lint: {name} on this run's recordings: "
                 f"{run_findings[name]}")
    _require(run_findings["fleet"] == []
             and [f.split(":")[0] for f in run_findings["wami"]]
             == ["REG003 wami/tile=256"],
             f"lint: this run's recordings: {run_findings}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.analysis.lint"], cwd=HERE,
        env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in (cli.stdout + cli.stderr).splitlines()
             if ln.startswith(("REG", "SPEC", "KNOB", "OBS", "SOC", "lint"))]
    want = ["lint ok: [fleet, wami] — registry, kernel specs, and knob "
            "spaces are statically clean"]
    _require(cli.returncode == 0 and lines == want,
             f"lint: the CLI exited {cli.returncode} printing {lines}")
    wall = time.perf_counter() - t0
    print(f"[lint] budget {H100_SMEM_OPTIN_BYTES} B = the card's "
          f"{card} B; the registry: {[' '.join(k) for k in keys]}; this "
          f"run's recordings: wami {run_findings['wami']}, fleet "
          f"{run_findings['fleet']} (no REG004, no SPEC003); python -m "
          f"repro_torch.core.analysis.lint exits 0: {lines[0]!r}; "
          f"{wall:.1f} s", flush=True)
    return {"smem_budget": card, "registry": [list(k) for k in keys],
            "this_run": run_findings, "cli_rc": cli.returncode,
            "wall_s": wall}


# ----------------------------------------------------------------------
# the record/replay workflow on the card
# ----------------------------------------------------------------------
# What each committed card recording replays to: invocations by
# component and by phase, mapped points, front size and the LP sweep's
# theta range (frames/s for WAMI, runs/s for the fleet; two places, as
# the recorder prints them), as the call that recorded them on an NVIDIA
# H100 80GB HBM3 at 700.00 W printed them;
# tests/test_torch_card_recordings.py pins the same.
_MATRIX_STAGES = {"matrix_sub": 11, "sd_update": 14, "matrix_mul": 7,
                  "matrix_add": 8, "matrix_resh": 6}
_WAMI_KERNEL_STAGES = ("debayer", "grayscale", "gradient", "steep_descent",
                "hessian", "warp")


def _wami_numbers(counts, change_det, characterize):
    return {"invocations": {**dict(zip(_WAMI_KERNEL_STAGES, counts)),
                            **_MATRIX_STAGES, "change_det": change_det},
            "by_phase": {"characterize": characterize, "map": 10},
            "mapped": 10, "front": 7, "theta": ["56.49", "336.98"]}


CARD_RECORDINGS = {
    "wami_cuda_tile64.json": _wami_numbers((10, 10, 10, 8, 11, 8), 8, 101),
    "wami_cuda_tile128.json": _wami_numbers((26, 10, 10, 8, 11, 8), 16,
                                            125),
    "wami_cuda_tile256.json": _wami_numbers((50, 26, 26, 16, 27, 8), 28,
                                            217),
    "fleet_cuda.json": {"invocations": {"flash_attention": 15,
                                        "ssd_scan": 6},
                        "by_phase": {"characterize": 18, "map": 3},
                        "mapped": 7, "front": 4,
                        "theta": ["30071.21", "136971.29"]},
}
# the ``[dse]`` and ``[front]`` lines of the share-PLM drive over the
# committed tiles 64 and 128 (``repro_torch.examples.wami_plm``), as its
# replay on the CPU prints them
_PLM_LK = ("change_det+hessian+sd_update;debayer+steep_descent;"
           "matrix_sub+warp")
CARD_PLM_LINES = [
    "[dse] 223 oracle invocations, 10 mapped points, theta in [56.5, "
    "343.4] fps",
    *(f"[dse]   {name:14s} tile axis [64, 128], {n} regions"
      for name, n in (("change_det", 8), ("debayer", 10), ("gradient", 10),
                      ("grayscale", 10), ("hessian", 10),
                      ("matrix_sub", 8), ("sd_update", 10),
                      ("steep_descent", 8), ("warp", 8))),
    "[front] theta_fps   shared_cost   naive_sum   saved   groups",
    "[front]     61.97        130809      188797   57988   change_det+"
    "debayer+sd_update+steep_descent;matrix_sub+warp;gradient+hessian",
    f"[front]     78.18        153388      190899   37511   {_PLM_LK}",
    f"[front]    115.40        151625      189138   37513   {_PLM_LK}",
    f"[front]    115.40        151625      189138   37513   {_PLM_LK}",
    f"[front]    164.65        152390      197378   44989   {_PLM_LK}",
    f"[front]    185.08        154534      199523   44989   {_PLM_LK}",
    f"[front]    230.44        246529      312233   65704   {_PLM_LK}",
    f"[front]    270.19        157977      214004   56026   {_PLM_LK}",
    f"[front]    337.40        154876      222731   67854   {_PLM_LK}",
    "[front]    343.40        208113      296447   88334   sd_update+"
    "steep_descent+warp;change_det+debayer+hessian;grayscale+matrix_sub",
    "[front] shared-PLM front dominates or equals the naive sum at every "
    "point",
]
RECORD_TIMEOUT = 600


def _record_cli(module, out_dir, *args):
    """``python3 -m repro_torch.examples.<module> --record`` in a
    subprocess, as a user runs it; its stdout lines."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{module}", "--record",
         *args, "--out-dir", out_dir], cwd=HERE, env=env,
        capture_output=True, text=True, timeout=RECORD_TIMEOUT)
    _require(proc.returncode == 0,
             f"[record] {module} --record exited {proc.returncode}: "
             f"{proc.stderr[-3000:]}")
    return proc.stdout.splitlines()


def _launches_of(lines, prefix):
    """The counts of a recorder's ``kernel launches: a=1, ...`` line."""
    tag = f"{prefix} kernel launches: "
    found = [ln[len(tag):] for ln in lines if ln.startswith(tag)]
    _require(len(found) == 1, f"[record] no launch line in {lines[-5:]}")
    return {k: int(v) for k, v in
            (kv.split("=") for kv in found[0].split(", "))}


def _drive_numbers(session, res):
    """A drive's numbers as the recorder prints them."""
    return {"invocations": dict(res.invocations),
            "by_phase": dict(sorted(
                session.ledger.records_by_phase().items())),
            "mapped": len(res.mapped), "front": len(res.pareto()),
            "theta": [f"{res.theta_min:.2f}", f"{res.theta_max:.2f}"]}


def _wall_ratios(fresh, committed):
    """Per stage over the points both recordings hold: (points, median,
    smallest and largest ratio of the fresh wall to the committed)."""
    ratios = {}
    for key, w in fresh.entries.items():
        old = committed.entries.get(key)
        if old:
            ratios.setdefault(key[0], []).append(w / old)
    return {comp: (len(rs), _median(rs), min(rs), max(rs))
            for comp, rs in sorted(ratios.items())}


def phase_record(dev, work):
    """The record/replay workflow as a user runs it: ``python3 -m
    repro_torch.examples.wami_cuda --record --tile 128`` and
    ``fleet_cuda --record`` into a fresh directory, each in a
    subprocess; each fresh recording replayed here on the card must give
    the front and invocations its recorder printed, and every kernel
    must have launched in the two record drives.  Then each committed
    recording (``artifacts/measurements/*cuda*.json``) and the share-PLM
    drive over the committed tiles 64 and 128 replay on the card to the
    pinned numbers (``CARD_RECORDINGS``, ``CARD_PLM_LINES``) and to their
    replays on the CPU, byte for byte; the fresh walls print beside the
    committed ones (not gated: host clocks vary up to 2x)."""
    from repro_torch.apps.fleet import default_measurement_path as fleet_path
    from repro_torch.apps.wami.cuda import default_measurement_path
    from repro_torch.core import MeasurementStore
    from repro_torch.examples import fleet_cuda, wami_cuda, wami_plm
    t0 = time.perf_counter()
    fresh_dir = os.path.join(work, "fresh")
    os.makedirs(fresh_dir)
    out = {"launches": {}, "fresh": {}, "committed": {}, "ratios": {}}
    drives = (
        ("wami", wami_cuda, ("--tile", str(TILE)),
         f"wami_cuda_tile{TILE}.json", default_measurement_path(TILE),
         dict(tile=TILE)),
        ("fleet", fleet_cuda, (), "fleet_cuda.json", fleet_path(), {}))
    for name, module, args, fname, committed, kw in drives:
        t1 = time.perf_counter()
        lines = _record_cli(module.__name__.rsplit(".", 1)[1], fresh_dir,
                            *args)
        record_s = time.perf_counter() - t1
        out["launches"].update(_launches_of(lines, module.PREFIX))
        path = os.path.join(fresh_dir, fname)
        session, res, oracle, _, _ = module.drive("replay", path=path,
                                                  device=dev, **kw)
        front = module.front_lines(res)
        printed = [ln for ln in lines if ln in front]
        _require(printed == front and all(
            ln in lines for ln in module.report(
                "replay", session, res, oracle, None, 0.0)
            if "invocations by" in ln),
            f"[record] {name}: the fresh recording does not replay to the "
            f"front and invocations its recorder printed")
        fresh = MeasurementStore.load(path)
        ratios = _wall_ratios(fresh, MeasurementStore.load(committed))
        out["ratios"][name] = ratios
        out["fresh"][name] = {"record_s": record_s, "points": len(fresh),
                              **_drive_numbers(session, res)}
        print(f"[record] {name}: recorded {len(fresh)} points in "
              f"{record_s:.1f} s (subprocess); {fresh.meta}; replays to "
              f"its own front ({len(res.pareto())} points) and "
              f"invocations", flush=True)
        for comp, (n, med, lo, hi) in ratios.items():
            print(f"[record] {name} {comp}: fresh / committed wall over "
                  f"{n} points: median {med:.3f}, range {lo:.3f}..{hi:.3f}",
                  flush=True)
    dead = [n for n, c in out["launches"].items() if c <= 0]
    _require(len(out["launches"]) == 9 and not dead,
             f"[record] kernels never launched in the record drives: "
             f"{out['launches']}")
    print(f"[record] launches in the record drives: {out['launches']}",
          flush=True)
    replays = [(f"wami_cuda_tile{t}.json", wami_cuda,
                default_measurement_path(t), dict(tile=t))
               for t in (64, 128, 256)]
    replays.append(("fleet_cuda.json", fleet_cuda, fleet_path(), {}))
    for fname, module, path, kw in replays:
        got = {}
        for where in (dev, "cpu"):
            session, res, _, _, _ = module.drive("replay", path=path,
                                                 device=where, **kw)
            got[str(where)] = (repr(res.mapped),
                               _drive_numbers(session, res))
        card, cpu = got[str(dev)], got["cpu"]
        _require(card == cpu, f"[record] {fname}: the card's replay "
                              f"differs from the CPU's")
        _require(card[1] == CARD_RECORDINGS.get(fname),
                 f"[record] {fname} replays to {card[1]}, not "
                 f"{CARD_RECORDINGS.get(fname)}")
        out["committed"][fname] = card[1]
        print(f"[record] committed {fname}: replays on the card as on the "
              f"CPU, to the pinned {card[1]}", flush=True)
    plm = {}
    for where in (dev, "cpu"):
        lines = wami_plm.run(where)
        plm[str(where)] = [ln for ln in lines if ln.startswith(("[dse]",
                                                                "[front]"))]
    _require(plm[str(dev)] == plm["cpu"] == CARD_PLM_LINES,
             f"[record] the share-PLM replay: {plm[str(dev)]}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[record] share-PLM drive over tiles 64 and 128: "
          f"{plm[str(dev)][0]}; {out['wall_s']:.1f} s", flush=True)
    return out


# Walls of the WAMI DSE's recording with an earlier kernel, read by that
# commit's chip_smoke.py (its --out JSON), in us per launch: change
# detection's scalar kernel of commit 8a11b55 (one pixel a thread, at
# most 256 threads a CTA), debayer's and gradient's of commit f6001f2,
# grayscale's and steepest descent's of commit ba3ac6d, and the warp's
# of commit 9bb0baf (the same design).
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
    "grayscale": ("the scalar design of commit ba3ac6d", {
        "p1:u1": 2.302, "p1:u2": 2.317, "p1:u4": 2.478, "p1:u8": 2.878,
        "p1:u16": 3.858, "p1:u32": 5.722, "p2:u2": 2.294, "p2:u4": 2.296,
        "p2:u8": 2.478, "p2:u16": 2.875, "p2:u32": 3.842, "p4:u4": 2.296,
        "p4:u8": 2.306, "p4:u16": 2.469, "p4:u32": 2.904, "p8:u8": 2.290,
        "p8:u16": 2.285, "p8:u32": 2.459, "p16:u16": 2.282, "p16:u32": 2.299}),
    "steep_descent": ("the scalar design of commit ba3ac6d", {
        "p1:u1": 2.296, "p1:u2": 2.790, "p1:u4": 3.285, "p1:u8": 4.203,
        "p1:u16": 5.688, "p2:u2": 2.288, "p2:u4": 2.824, "p2:u8": 3.248,
        "p2:u16": 4.219, "p4:u4": 2.485, "p4:u8": 2.829, "p4:u16": 3.277,
        "p8:u8": 2.611, "p8:u16": 2.818}),
    "warp": ("the scalar design of commit 9bb0baf", {
        "p1:u1": 2.626, "p1:u2": 2.486, "p1:u4": 2.851, "p1:u8": 3.422,
        "p1:u16": 4.536, "p2:u2": 2.667, "p2:u4": 2.494, "p2:u8": 2.850,
        "p2:u16": 3.418, "p4:u4": 2.656, "p4:u8": 2.483, "p4:u16": 2.837,
        "p8:u8": 2.670, "p8:u16": 2.675}),
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
            # the library call against the plain version, for information
            # (a yardstick, not a parity check)
            lib_err = (None if k["library"] is None else float(
                (k["library"](x).double() - k["ref"](*args).double())
                .abs().max()))
            nbytes = k["bytes_px"] * n * n + k.get("bytes_fixed", 0)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = k["flops_px"] * n * n / FP32_FLOPS_PER_S * 1e3
            call = _call_ms(dev, lambda: k["op"](*args, ports=ports,
                                                 unrolls=unrolls))
            row = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                   "library_max_abs_err": lib_err, "call_ms": call,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "bytes": nbytes, "flops": k["flops_px"] * n * n}
            out.setdefault(k["name"], {})[n] = row
            lib_s = ("-" if lib is None else
                     f"{lib:.5f} (max|d| {lib_err:.3g} against the plain "
                     f"version)")
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
# a head dim above 256 (no config of the repository has one): the wide
# body's timing row, causal, GQA 4:1, at 64 x 64 blocks
WIDE_LAYER = dict(B=1, S=1024, H=8, K=2, d=512, block_q=64, block_kv=64)
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

    # head dims above 256: the wide body, one launch per slice of at most
    # 256 of V's columns, at the slice's native width (257: 256 + 1, the
    # last at D 32; 320: D 64; 384: D 128; 512: two at D 256; 513, odd:
    # single-value stores), GQA, causal
    for d in (257, 320, 384, 512, 513):
        for dtype in BOTH:
            q, k, v = _flash_inputs(dev, 2, 128, 128, 4, 2, d, dtype, 14)
            flash(f"flash d {d} (4 on 2 heads, S 128) {dtype}", q, k, v,
                  block_q=64, block_kv=64)
    # ... with a window and soft-cap at 128-row blocks, decode, and
    # non-causal blocks off the 16-row grid
    for dtype in BOTH:
        q, k, v = _flash_inputs(dev, 1, 256, 256, 8, 2, 512, dtype, 15)
        flash(f"flash d 512 window 96 softcap 30 {dtype}", q, k, v,
              window=96, softcap=30.0, block_q=128, block_kv=128)
        q, k, v = _flash_inputs(dev, 2, 1, 256, 4, 2, 384, dtype, 16)
        flash(f"flash decode d 384 Skv 256 {dtype}", q, k, v, q_offset=255)
        q, k, v = _flash_inputs(dev, 1, 300, 300, 4, 4, 320, dtype, 17)
        flash(f"flash d 320 S 300 blocks 20 x 12 non-causal {dtype}", q, k,
              v, causal=False, block_q=20, block_kv=12)
    # against the rehearsal of its decomposition (flash_tiled_ref: float32
    # numerics, S over all d in 64-column 3xTF32 chunks)
    q, k, v = _flash_inputs(dev, 2, 128, 128, 4, 2, 512, torch.float32, 14)
    wide = _abs_err("flash d 512 against flash_tiled_ref",
                    mha(q, k, v, block_q=64, block_kv=64),
                    flash_tiled_ref(q, k, v, block_q=64, block_kv=64),
                    FLASH_TOL["float32"])
    print(f"[parity] flash f32 d 512 against flash_tiled_ref (the wide "
          f"body's decomposition): max|d| {wide:.3g}", flush=True)

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
            "front_points": _front_points(res),
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


def _sdpa_backends(dev, q, k, v, launches=TIME_LAUNCHES, reps=TIME_REPS):
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
            out[b.name] = _time_ms(dev, call, launches, reps)
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
    # head dim 512 (the wide body: two launches of 256 columns of V)
    # beside SDPA's math backend on the same inputs
    for dtype in (torch.float32, torch.bfloat16):
        row, qkv = flash_row(f"d {WIDE_LAYER['d']} {dtype}", dtype=dtype,
                             library=False, launches=5, reps=3,
                             **WIDE_LAYER)
        row["sdpa_backends_ms"] = _sdpa_backends(dev, *qkv, launches=5,
                                                 reps=3)
        row["library_ms"] = row["sdpa_backends_ms"]["MATH"]
        out["flash_attention"][
            f"d{WIDE_LAYER['d']} {str(dtype).split('.')[-1]}"] = row
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


# ----------------------------------------------------------------------
# the LM serving path: configs -> SyntheticLM -> build_model ->
# ServeEngine, as the JAX package's launch/serve.py drives it
# ----------------------------------------------------------------------
# card against the port on the CPU, float32, TF32 off: max|d| / max|ref|
LM_REDUCED_TOL = 1e-4
# a step whose top-2 logits (on the CPU) lie closer than this, relative
# to the row's max |logit|, is a near tie: from there the greedy tokens
# are compared by teacher forcing along the CPU's tokens
LM_TIE_GAP = 1e-4
# prefill(S+n) against prefill(S) + n decode steps at full width: in
# float32 (the same weights, upcast) to tests/test_models.py's SSD
# decode-chain 1e-3; in the served bfloat16 to 3e-2, but 1e-1 for the
# hybrid, whose prefill and decode round differently in bfloat16 in the
# JAX package too (its depthwise conv sums in bfloat16 in the prefill and
# in float32 in the step: ROADMAP Queue 3)
LM_CHAIN_F32_TOL = 1e-3
# one layer at full width in float32, card against the CPU
LM_LAYER_TOL = 1e-4
# the served models, at full width in their own dtype (bfloat16), with
# random weights from seed 0: (arch, decode steps of the chain check,
# its bfloat16 bound); the hybrid's chain decodes 8 steps
LM_SERVE_ARCHS = (("gemma2-9b", 1, 3e-2), ("zamba2-2.7b", 8, 1e-1))
LM_SERVE = dict(requests=6, slots=4, prompt_len=128, max_new=16)
LM_LAYER_TOKENS = 16
# the kernels at the served models' shapes (timed and compared only; the
# models run their own plain attention_core and _ssd_chunked)
LM_FLASH_ROWS = (
    dict(label="gemma2-9b prefill", B=4, Sq=128, Skv=128, H=16, K=8, d=256,
         window=4096, softcap=50.0, blocks=(64, 64)),
    # the last decode step of a 128-token prompt and 16 new tokens: one
    # query over 143 valid keys, at blocks that divide them (13 is off the
    # 16-row grid: the general body)
    dict(label="gemma2-9b decode", B=4, Sq=1, Skv=143, H=16, K=8, d=256,
         window=4096, softcap=50.0, blocks=(1, 13)),
    dict(label="zamba2-2.7b attention", B=4, Sq=128, Skv=128, H=32, K=32,
         d=80, window=0, softcap=0.0, blocks=(64, 64)),
)
LM_SSD_ROW = dict(label="zamba2-2.7b SSD", Bz=4, S=128, H=80, P=64, N=64,
                  chunk=256)


def _lm_batch(cfg, B, S, seed, dev):
    """Tokens (and a whisper's frames, qwen2-vl's M-RoPE positions) from
    seeded numpy, on ``dev``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def _rel(got, want):
    """max|d| / max|want| in float64, both on the host."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    _require(got.shape == want.shape, (got.shape, want.shape))
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def _greedy_agree(what, cpu_model, card_model, cpu_batch, card_batch,
                  cpu_toks, card_toks):
    """The card's greedy tokens against the CPU's: each row equal up to
    its first near-tie step, and from there, teacher-forced along the
    CPU's tokens, the card's argmax equal at every step that is not a
    near tie.  Returns the number of near-tie steps."""
    import torch
    B, n = cpu_toks.shape
    S = cpu_batch["tokens"].shape[1]
    lc, cc = cpu_model.prefill(cpu_batch, max_len=S + n)
    lg, cg = card_model.prefill(card_batch, max_len=S + n)
    first_tie = [n] * B
    ties = 0
    for t in range(n):
        top = torch.topk(lc, 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]) / lc.abs().amax(-1).clamp(min=1e-30)
        _require(torch.equal(lc.argmax(-1), cpu_toks[:, t]), what)
        got = lg.argmax(-1).cpu()
        for b in range(B):
            if gap[b] < LM_TIE_GAP:
                ties += 1
                first_tie[b] = min(first_tie[b], t)
            else:
                _require(int(got[b]) == int(cpu_toks[b, t]),
                         f"{what}: row {b} step {t} argmax {int(got[b])} "
                         f"!= {int(cpu_toks[b, t])}")
        if t + 1 < n:
            nxt = cpu_toks[:, t:t + 1]
            lc, cc = cpu_model.decode_step(nxt, cc)
            lg, cg = card_model.decode_step(nxt.to(lg.device), cg)
    for b in range(B):
        _require(torch.equal(card_toks[b, :first_tie[b]].cpu(),
                             cpu_toks[b, :first_tie[b]]),
                 f"{what}: row {b} tokens {card_toks[b].tolist()} != "
                 f"{cpu_toks[b].tolist()}")
    return ties


def _lm_reduced(dev):
    """Every arch at ``.reduced()`` (float32): the same weights on the
    card and on the CPU; prefill and next-step logits within
    LM_REDUCED_TOL, greedy tokens equal (whisper with frames)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.models import params_to_numpy
    from repro_torch.serve import generate
    cpu = torch.device("cpu")
    out = {}
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        ref = build_model(cfg, cpu, torch.Generator(cpu).manual_seed(0))
        model = params_from_numpy(build_model(cfg, dev),
                                  params_to_numpy(ref))
        cb = _lm_batch(cfg, 2, 12, 1, cpu)
        gb = {k: v.to(dev) for k, v in cb.items()}
        lc, cc = ref.prefill(cb, max_len=20)
        lg, cg = model.prefill(gb, max_len=20)
        prefill = _rel(lg, lc)
        nxt = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (2, 1)).astype(np.int32))
        lc, _ = ref.decode_step(nxt, cc)
        lg, _ = model.decode_step(nxt.to(dev), cg)
        decode = _rel(lg, lc)
        for name, r in (("prefill", prefill), ("decode", decode)):
            _require(r <= LM_REDUCED_TOL, f"[lm-serve] {arch} reduced "
                     f"{name} logits: rel {r:.3g} > {LM_REDUCED_TOL}")
        toks_c = generate(ref, cb, max_new=8)
        toks_g = generate(model, gb, max_new=8)
        ties = _greedy_agree(f"[lm-serve] {arch} reduced greedy", ref, model,
                             cb, gb, toks_c, toks_g)
        torch.cuda.synchronize(dev)
        out[arch] = {"prefill_rel": prefill, "decode_rel": decode,
                     "greedy_equal": bool(torch.equal(toks_c,
                                                      toks_g.cpu())),
                     "near_ties": ties}
        print(f"[lm-serve] {arch} reduced f32, card against CPU: prefill "
              f"rel {prefill:.3g}, decode rel {decode:.3g}, greedy tokens "
              f"{'equal' if out[arch]['greedy_equal'] else 'equal up to '}"
              f"{'' if out[arch]['greedy_equal'] else f'{ties} near ties'}",
              flush=True)
    return out


def _layer_check(model, dev, seed):
    """Layer 0 at full width in float32 on the card and on the CPU (TF32
    off): a decoder's block, or the hybrid's shared block followed by its
    first Mamba layer; returns max|d| / max|ref|."""
    import numpy as np
    import torch
    from repro_torch.models.blocks import layer_params, make_positions
    from repro_torch.models.ssm import mamba_sequence
    from repro_torch.models.blocks import apply_norm
    cfg = model.cfg
    x = np.random.default_rng(seed).standard_normal(
        (1, LM_LAYER_TOKENS, cfg.d_model)).astype(np.float32)

    def run(device):
        params = model.params()
        idx = (0,) if cfg.family != "hybrid" else (0, 0)
        lp = {k: v for k, v in params.items() if k.startswith("shared")}
        lp["layer"] = layer_params(params["layers"], *idx)

        def f32(t):
            if isinstance(t, dict):
                return {k: f32(v) for k, v in t.items()}
            return t.detach().to(device, torch.float32)
        lp = f32(lp)
        h = torch.from_numpy(x).to(device)
        pos = make_positions(1, LM_LAYER_TOKENS, device=device)
        if cfg.family == "hybrid":
            h, _ = model._shared_block(lp, h, pos)
            y, _ = mamba_sequence(lp["layer"]["mamba"], cfg, apply_norm(
                lp["layer"]["ln"], h, cfg.norm_kind))
            return h + y
        y, _, _ = model._block(lp["layer"], h, pos, model._windows(1)[0],
                               moe=False)
        return y

    with torch.no_grad():
        return _rel(run(dev), run(torch.device("cpu")))


def _step_profile(dev, fn, calls=3, top=None):
    """(kernels, device ms) per call of ``fn`` from a ``torch.profiler``
    trace of the card alone over ``calls`` calls; (0, 0.0) where the
    trace holds no device time.  With ``top``, also the ``top`` kernels
    by device time: ``[(name, ms a call, launches a call), ...]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(dev)
    rows = [e for e in prof.key_averages() if e.device_time_total > 0]
    out = (sum(e.count for e in rows) // calls,
           sum(e.device_time_total for e in rows) / calls / 1e3)
    if top is None:
        return out
    rows.sort(key=lambda e: -e.device_time_total)
    return out + ([(e.key[:90], e.device_time_total / calls / 1e3,
                    e.count // calls) for e in rows[:top]],)


def _chain_rel(model, full, S):
    """prefill(full)'s last logits against prefill(full[:, :S]) and one
    decode step per remaining token, max|d| / max|ref|."""
    import torch
    n = full.shape[1]
    want, _ = model.prefill({"tokens": full}, max_len=n)
    got, c = model.prefill({"tokens": full[:, :S]}, max_len=n)
    for t in range(S, n):
        got, c = model.decode_step(full[:, t:t + 1], c)
    _require(bool(torch.isfinite(got).all()), f"{model.cfg.name}: logits "
             "finite")
    return _rel(got.float(), want.float())


def _lm_full_width(dev, cfg, chain, chain_tol):
    """One served model at full width: built on the card from a seeded
    generator, six SyntheticLM requests through ServeEngine, and the
    checks and times of the [lm-serve] phase."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, generate
    n_req, slots = LM_SERVE["requests"], LM_SERVE["slots"]
    S, n_new = LM_SERVE["prompt_len"], LM_SERVE["max_new"]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, dev, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    _require(model.device.type == "cuda", f"{cfg.name} not on the card")
    param_gb = sum(p.numel() * p.element_size()
                   for p in model.parameters()) / 1e9
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    prompts = src.batch(step=0, shard=0, n_shards=1, batch=n_req,
                        seq=S + chain)["tokens"]

    eng = ServeEngine(model, slots=slots, prompt_len=S, max_new=n_new)
    for rid in range(n_req):
        eng.submit(rid, prompts[rid, :S])
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize(dev)
    serve_s = time.perf_counter() - t0
    _require(sorted(results) == list(range(n_req)), sorted(results))
    _require(all(len(v) == n_new and all(0 <= t < cfg.vocab for t in v)
                 for v in results.values()),
             f"{cfg.name}: every request gets {n_new} tokens in the vocab")
    toks = n_req * n_new

    batch = {"tokens": torch.from_numpy(prompts[:slots, :S]).to(dev)}
    gen = generate(model, batch, max_new=n_new)
    logits, _ = model.prefill(batch, max_len=S + n_new)
    _require(torch.equal(logits.argmax(-1), gen[:, 0]),
             f"{cfg.name}: generate's first token is the prefill's argmax")
    _require(all(results[r] == gen[r].tolist() for r in range(slots)),
             f"{cfg.name}: the engine's first burst is generate's tokens")
    prefill_ms = _wall_ms(dev, lambda: model.prefill(batch,
                                                     max_len=S + n_new),
                          reps=3)
    _, cache = model.prefill(batch, max_len=S + n_new)
    nxt = gen[:, :1]

    def decode_steps():
        c = dict(cache, len=S)
        for _ in range(n_new - 1):
            _, c = model.decode_step(nxt, c)
    decode_ms = _wall_ms(dev, decode_steps, reps=3) / (n_new - 1)
    step_kernels, step_device_ms = _step_profile(
        dev, lambda: model.decode_step(nxt, dict(cache, len=S)))

    # prefill(S + chain) against prefill(S) + chain decode steps
    full = torch.from_numpy(prompts[:slots, :S + chain]).to(dev)
    chain_rel = _chain_rel(model, full, S)
    _require(chain_rel <= chain_tol,
             f"{cfg.name}: prefill({S + chain}) against prefill({S}) + "
             f"{chain} decode steps: rel {chain_rel:.3g} > {chain_tol}")
    layer_rel = _layer_check(model, dev, seed=3)
    _require(layer_rel <= LM_LAYER_TOL,
             f"{cfg.name}: layer 0 in float32, card against CPU: rel "
             f"{layer_rel:.3g} > {LM_LAYER_TOL}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # the chain again in float32: the same weights, upcast exactly
    model32 = build_model(dataclasses.replace(
        cfg, dtype="float32", param_dtype="float32"), dev)
    with torch.no_grad():
        for name, p in model32.named_parameters():
            p.copy_(model.get_parameter(name))
    chain_f32 = _chain_rel(model32, full, S)
    del model32
    _require(chain_f32 <= LM_CHAIN_F32_TOL,
             f"{cfg.name} in float32: prefill({S + chain}) against "
             f"prefill({S}) + {chain} decode steps: rel {chain_f32:.3g} > "
             f"{LM_CHAIN_F32_TOL}")
    row = {"param_gb": param_gb, "init_s": init_s, "serve_s": serve_s,
           "tok_per_s": toks / serve_s, "requests": n_req, "slots": slots,
           "prompt_len": S, "max_new": n_new, "prefill_ms": prefill_ms,
           "decode_ms_per_step": decode_ms,
           "decode_step_kernels": step_kernels,
           "decode_step_device_ms": step_device_ms,
           "decode_idle_share": (1.0 - step_device_ms / decode_ms
                                 if step_kernels else None),
           "chain_steps": chain,
           "chain_rel": chain_rel, "chain_tol": chain_tol,
           "chain_f32_rel": chain_f32, "layer0_f32_rel": layer_rel,
           "peak_gb": peak_gb, "sample_rid0": results[0]}
    print(f"[lm-serve] {cfg.name} full width {cfg.dtype}: {param_gb:.2f} GB "
          f"of parameters, init {init_s:.3f} s; {n_req} requests x {n_new} "
          f"tokens over {slots} slots (prompt {S}) in {serve_s:.3f} s = "
          f"{toks / serve_s:.1f} tok/s; prefill ({slots} x {S}) "
          f"{prefill_ms:.2f} ms, decode {decode_ms:.2f} ms a step "
          + (f"({step_kernels} kernels, {step_device_ms:.2f} ms of device "
             f"time: idle {1.0 - step_device_ms / decode_ms:.1%}); "
             if step_kernels else "(no device time in the trace); ") +
          f"prefill({S + chain}) against prefill({S}) + {chain} decode "
          f"steps rel {chain_rel:.3g} (<= {chain_tol}), in float32 "
          f"{chain_f32:.3g} (<= {LM_CHAIN_F32_TOL}); layer 0 f32 card "
          f"against CPU rel {layer_rel:.3g} (<= {LM_LAYER_TOL}); peak "
          f"{peak_gb:.2f} GB allocated; rid 0: {results[0][:8]}",
          flush=True)
    del model, eng, cache
    return row


def _lm_kernel_times(dev):
    """flash attention and the SSD scan at the served models' shapes,
    timed beside the models' own plain attention_core and _ssd_chunked
    on the same inputs (routed nowhere); max|d| against them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import mha
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.models.blocks import attention_core
    from repro_torch.models.ssm import _ssd_chunked
    out = {"flash_attention": {}, "ssd_scan": {}}
    for r in LM_FLASH_ROWS:
        B, Sq, Skv, H, K, d = (r[k] for k in ("B", "Sq", "Skv", "H", "K",
                                              "d"))
        q, k, v = _flash_inputs(dev, B, Sq, Skv, H, K, d, torch.bfloat16, 21)
        off = Skv - Sq
        q_pos = (torch.arange(Sq, device=dev) + off)[None].expand(B, Sq)
        kv_pos = torch.arange(Skv, device=dev)[None].expand(B, Skv)
        kw = dict(causal=True, window=r["window"], softcap=r["softcap"])

        def kernel():
            return mha(q, k, v, q_offset=off, block_q=r["blocks"][0],
                       block_kv=r["blocks"][1], **kw)

        def plain():
            return attention_core(q, k, v, q_pos, kv_pos, causal=True,
                                  window=r["window"], attn_cap=r["softcap"])
        err = float((kernel().double() - plain().double()).abs().max())
        _require(bool(torch.isfinite(kernel()).all()), r["label"])
        lib = None
        if not r["softcap"] and not r["window"] and Sq == Skv:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = _time_ms(dev, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        nbytes, flops = _flash_work(B, Sq, Skv, H, K, d, 2, True,
                                    r["window"], off)
        bound, by = _bound(nbytes, flops, BF16_FLOPS_PER_S)
        out["flash_attention"][r["label"]] = {
            "ms": _time_ms(dev, kernel), "plain_ms": _time_ms(dev, plain),
            "library_ms": lib, "bound_ms": bound, "bound_by": by,
            "bytes": nbytes, "flops": flops, "max_abs_err": err,
            "tol": FLASH_TOL["bfloat16"],
            "within_tol": err < FLASH_TOL["bfloat16"],
            "blocks": list(r["blocks"]), "q_offset": off}
    r = LM_SSD_ROW
    args = _ssd_inputs(dev, r["Bz"], r["S"], r["H"], r["P"], r["N"], 22)
    got, want = ssd(*args, chunk=r["chunk"]), _ssd_chunked(*args,
                                                           r["chunk"])
    scale = max(1.0, max(float(w.abs().max()) for w in want))
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    _require(all(bool(torch.isfinite(g).all()) for g in got), r["label"])
    run = min(r["chunk"], r["S"])
    nbytes, flops = _ssd_work(r["Bz"], r["S"], r["H"], r["P"], r["N"], run)
    bound, by = _bound(nbytes, flops, FP32_FLOPS_PER_S)
    out["ssd_scan"][r["label"]] = {
        "ms": _time_ms(dev, lambda: ssd(*args, chunk=r["chunk"])),
        "plain_ms": _time_ms(dev, lambda: _ssd_chunked(*args, r["chunk"])),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "bytes": nbytes, "flops": flops, "max_abs_err": err,
        "tol": SSD_TOL * scale, "within_tol": err < SSD_TOL * scale,
        "chunk": r["chunk"], "run_chunk": run}
    for name, rows in out.items():
        for label, t in rows.items():
            lib = ("-" if t["library_ms"] is None
                   else f"{t['library_ms']:.5f}")
            print(f"[lm-serve] {name} at {label}: kernel {t['ms']:.5f} ms, "
                  f"model's plain {t['plain_ms']:.5f} ms, library {lib} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}); max|d| "
                  f"{t['max_abs_err']:.3g} against the model's plain "
                  f"({'within' if t['within_tol'] else 'BEYOND'} the "
                  f"kernel's tolerance {t['tol']:.3g})", flush=True)
    return out


def phase_lm_serve(dev):
    """The LM serving path (``[lm-serve]``): every arch reduced on the
    card against the CPU, the served models at full width, and the two
    kernels at their shapes.  Frees each model before the next."""
    import gc
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    out = {"reduced": _lm_reduced(dev)}
    for arch, chain, chain_tol in LM_SERVE_ARCHS:
        out[arch] = _lm_full_width(dev, get_config(arch), chain, chain_tol)
        gc.collect()
        torch.cuda.empty_cache()
    out["kernels"] = _lm_kernel_times(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"[lm-serve] {out['seconds']:.1f} s", flush=True)
    return out


# ----------------------------------------------------------------------
# the LM training path: configs -> build_model -> init_opt ->
# make_train_step -> SyntheticLM/DataPipeline -> Watchdog ->
# AsyncCheckpointer, latest_step, restore, as the JAX package's
# launch/train.py drives it
# ----------------------------------------------------------------------
# (a) every arch reduced, float32, TF32 off, card against CPU from the
# same weights: loss, grad norm and each gradient leaf (max|d| /
# max|ref| of the leaf) of one step; the update from the CPU's gradients
# in float32 within 1e-6 (the parameters and both moments).  The 8-bit
# update's parameters and scales are held to 1e-6 too, its int8 codes to
# at most one step apart in at most 1e-3 of them: a code is a rounding
# of 127 * m / max|m| of its row, and the two devices' sums of squares
# for the clip differ in the last bits, so a quotient that lies within
# that of a half step rounds the other way
LM_TRAIN_TOL = 1e-4
LM_TRAIN_UPDATE_TOL = 1e-6
LM_TRAIN_Q8_CODE_SHARE = 1e-3
LM_TRAIN_REDUCED_BATCH = (4, 16)
# (b) the launcher's own example at full width and depth (bf16), its
# defaults otherwise (f32 moments, remat none), crashed after its step-20
# checkpoint and resumed; held to test_system.py's loss drop
LM_TRAIN_ARCH = "qwen2-0.5b"
LM_TRAIN_RUN = dict(steps=40, batch=16, seq=128, ckpt_every=20)
LM_TRAIN_KILL_AT = 20
LM_TRAIN_LOSS_DROP = 0.05
LM_TRAIN_RESUME_TOL = 1e-2      # bf16; atomics in the embedding's backward
LM_TRAIN_TIMED_STEPS = 6
# the timed turns of the loop, in an order that balances drift
LM_TRAIN_TURNS = ("unbind", "no_read", "index", "index", "no_read", "unbind")
LM_TRAIN_TOP_KERNELS = 12       # kernels by device time printed a step
# (c) the three knobs (b) leaves off, at full width and depth
LM_TRAIN_Q8_ARCH = "zamba2-2.7b"
LM_TRAIN_Q8_RUN = dict(batch=4, seq=512, steps=6)
LM_TRAIN_Q8_KNOBS = dict(microbatches=2, remat="full",
                         quantized_moments=True)
LM_TRAIN_Q8_RATIO = 3.9         # tests/test_autotune_hlo.py's bar


def _lm_train_batch(cfg, B, S, seed, dev):
    """A training batch (tokens, targets, a 90% mask; a whisper's frames,
    qwen2-vl's M-RoPE positions) from seeded numpy, on ``dev``."""
    import numpy as np
    import torch
    batch = _lm_batch(cfg, B, S, seed, dev)
    rng = np.random.default_rng(seed + 1)
    batch["targets"] = torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    batch["mask"] = torch.from_numpy(
        (rng.random((B, S)) < 0.9).astype(np.float32)).to(dev)
    return batch


def _grads(model, batch):
    """(loss, {path: gradient}) of the train step's loss function."""
    import torch
    from repro_torch.train import make_loss_fn
    from repro_torch.utils import leaves_with_paths
    params = model.params()
    loss, _ = make_loss_fn(model, None)(params, batch)
    paths, leaves = zip(*leaves_with_paths(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(paths, grads))


def _worst_rel(want, got):
    """The largest max|d| / max|want| over the leaves of two trees of
    the same structure, and its path."""
    from repro_torch.utils import leaves_with_paths
    got = dict(leaves_with_paths(got))
    return max((_rel(got[p], w), p) for p, w in leaves_with_paths(want))


def _lm_train_reduced(dev):
    """(a): every arch at ``.reduced()`` (float32), the same weights on
    the card and on the CPU."""
    import torch
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    from repro_torch.optim import (AdamWConfig, apply_updates,
                                   apply_updates_q8, init_opt, init_opt_q8)
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.utils import tree_leaves, tree_map, unflatten_like
    cpu = torch.device("cpu")
    B, S = LM_TRAIN_REDUCED_BATCH
    opt_cfg = AdamWConfig(lr=1e-3)
    out = {}
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        ref = build_model(cfg, cpu, torch.Generator(cpu).manual_seed(0))
        init = params_to_numpy(ref)
        model = params_from_numpy(build_model(cfg, dev), init)
        cb = _lm_train_batch(cfg, B, S, 5, cpu)
        gb = {k: v.to(dev) for k, v in cb.items()}
        lc, gc = _grads(ref, cb)
        lg, gg = _grads(model, gb)
        row = {"loss_rel": _rel(lg, lc)}
        row["grad_rel"], row["grad_worst"] = max(
            (_rel(gg[p], gc[p]), p) for p in gc)
        # the update from the CPU's gradients on both devices
        for name, update, init_fn in (
                ("f32", apply_updates, init_opt),
                ("q8", apply_updates_q8, init_opt_q8)):
            states = []
            for m in (ref, model):
                params_from_numpy(m, init)
                params = m.params()
                grads = unflatten_like(params, iter(
                    gc[p].to(m.device) for p in gc))
                states.append(update(opt_cfg, params, grads,
                                     init_fn(params)))
            (pc, sc, mc), (pg, sg, mg) = states
            row[f"{name}_params_rel"], _ = _worst_rel(pc, pg)
            row[f"{name}_grad_norm_rel"] = _rel(mg["grad_norm"],
                                                mc["grad_norm"])
            if name == "f32":
                row["f32_moments_rel"] = max(_worst_rel(sc.mu, sg.mu)[0],
                                             _worst_rel(sc.nu, sg.nu)[0])
            else:
                row["q8_scales_rel"] = max(
                    _worst_rel(sc.mu_s, sg.mu_s)[0],
                    _worst_rel(sc.nu_s, sg.nu_s)[0])
                codes = differ = worst = 0
                for a_tree, b_tree in ((sc.mu_q, sg.mu_q),
                                       (sc.nu_q, sg.nu_q)):
                    d = tree_map(lambda a, b: (a.int() - b.cpu().int()).abs(),
                                 a_tree, b_tree)
                    for t in tree_leaves(d):
                        codes += t.numel()
                        differ += int((t > 0).sum())
                        worst = max(worst, int(t.max()))
                row["q8_codes"], row["q8_codes_differ"] = codes, differ
                row["q8_code_max_step"] = worst
        # one step of make_train_step on each device (default knobs:
        # remat full)
        steps = []
        for m, batch in ((ref, cb), (model, gb)):
            params_from_numpy(m, init)
            step = make_train_step(m, opt_cfg, TrainStepConfig())
            params = m.params()
            _, _, metrics = step(params, init_opt(params), batch)
            steps.append(metrics)
        row["step_loss_rel"] = _rel(steps[1]["loss"], steps[0]["loss"])
        row["step_grad_norm_rel"] = _rel(steps[1]["grad_norm"],
                                         steps[0]["grad_norm"])
        torch.cuda.synchronize(dev)
        for key in ("loss_rel", "grad_rel", "step_loss_rel",
                    "step_grad_norm_rel"):
            _require(row[key] <= LM_TRAIN_TOL,
                     f"[lm-train] {arch} reduced {key} {row[key]:.3g} > "
                     f"{LM_TRAIN_TOL} ({row['grad_worst']})")
        for key in ("f32_params_rel", "f32_moments_rel", "f32_grad_norm_rel",
                    "q8_params_rel", "q8_scales_rel", "q8_grad_norm_rel"):
            _require(row[key] <= LM_TRAIN_UPDATE_TOL,
                     f"[lm-train] {arch} reduced update {key} "
                     f"{row[key]:.3g} > {LM_TRAIN_UPDATE_TOL}")
        _require(row["q8_code_max_step"] <= 1 and row["q8_codes_differ"]
                 <= LM_TRAIN_Q8_CODE_SHARE * row["q8_codes"],
                 f"[lm-train] {arch} reduced q8 codes: {row}")
        out[arch] = row
        print(f"[lm-train] {arch} reduced f32, card against CPU: loss rel "
              f"{row['loss_rel']:.3g}, worst grad rel {row['grad_rel']:.3g} "
              f"({row['grad_worst']}); a make_train_step step: loss rel "
              f"{row['step_loss_rel']:.3g}, grad norm rel "
              f"{row['step_grad_norm_rel']:.3g}; the update from the CPU's "
              f"grads: f32 params {row['f32_params_rel']:.3g}, moments "
              f"{row['f32_moments_rel']:.3g}; q8 params "
              f"{row['q8_params_rel']:.3g}, scales "
              f"{row['q8_scales_rel']:.3g}, {row['q8_codes_differ']} of "
              f"{row['q8_codes']} int8 codes one step apart", flush=True)
    return out


@contextlib.contextmanager
def _recorded_steps(launcher):
    """Within the block, every step the launcher ``launcher`` builds
    notes the host clock as it is entered and keeps its grad norm (a
    device tensor: no sync).  Yields ``(entries, grad_norms)``."""
    entries, norms = [], []
    make = launcher.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def recorded(params, opt, batch):
            entries.append(time.perf_counter())
            params, opt, metrics = step(params, opt, batch)
            norms.append(metrics["grad_norm"])
            return params, opt, metrics
        return recorded
    launcher.make_train_step = recording
    try:
        yield entries, norms
    finally:
        launcher.make_train_step = make


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def _leaf_bits(t):
    """A host tensor's raw bits (its storage viewed as integers)."""
    import torch
    t = t.detach().cpu().contiguous()
    width = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(width[t.element_size()])


def _print_top(arch, top):
    for name, ms, n in top or ():
        print(f"[lm-train] {arch} a step: {ms:8.3f} ms in {n:5d} x {name}",
              flush=True)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _indexed_layers(tree):
    """The models' layer split before ``unstack_layers``: each layer's
    parameters indexed from the stacked leaves (``layer_params``), so
    autograd adds a zero-filled gradient of the whole leaf per layer."""
    from repro_torch.models.blocks import layer_params
    return [layer_params(tree, i) for i in range(_first_leaf(tree).shape[0])]


@contextlib.contextmanager
def _layer_split(split):
    """Within the block the models split their stacked layers with
    ``split`` in place of ``unstack_layers``."""
    from repro_torch.models import encdec, hybrid, ssm_lm, transformer
    mods = (encdec, hybrid, ssm_lm, transformer)
    kept = [m.unstack_layers for m in mods]
    for m in mods:
        m.unstack_layers = split
    try:
        yield
    finally:
        for m, f in zip(mods, kept):
            m.unstack_layers = f


def _lm_train_child(root):
    """The run ``_lm_train_full`` kills: the launcher into ``root``."""
    import torch
    from repro_torch.launch import train as launcher
    launcher.run(LM_TRAIN_ARCH, ckpt_dir=root, device=torch.device("cuda", 0),
                 **LM_TRAIN_RUN)


def _lm_train_full(dev):
    """(b): qwen2-0.5b at full width through ``launch.train.run``:
    uninterrupted, then crashed after its step-20 checkpoint and resumed;
    the checkpoint round trip; the loop's time, the host sync's cost and
    the device's idle share."""
    import gc
    import signal

    import numpy as np
    import torch
    from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                        restore)
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launcher
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.utils import tree_leaves
    cfg = get_config(LM_TRAIN_ARCH)
    steps, B, S = (LM_TRAIN_RUN[k] for k in ("steps", "batch", "seq"))
    work = os.path.join(HERE, "build", "lm_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    row = {"arch": LM_TRAIN_ARCH, **LM_TRAIN_RUN}

    # the uninterrupted run
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with _recorded_steps(launcher) as (entries, norms):
        params, losses = launcher.run(LM_TRAIN_ARCH, device=dev,
                                      **LM_TRAIN_RUN)
    row["run_s"] = time.perf_counter() - t0
    row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    row["param_gb"] = sum(p.numel() * p.element_size()
                          for p in tree_leaves(params)) / 1e9
    norms = torch.stack(norms).float().cpu()
    gaps = np.diff(entries)[1:]          # the first step warms up
    row["loop_ms_per_step"] = _median(gaps) * 1e3
    row["tok_per_s"] = B * S / _median(gaps)
    row["losses"], row["grad_norms"] = losses, norms.tolist()
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    row["loss_first5"], row["loss_last5"] = first, last
    _require(len(losses) == steps and all(map(math.isfinite, losses))
             and bool(torch.isfinite(norms).all()),
             f"[lm-train] {LM_TRAIN_ARCH}: a loss or grad norm is not "
             f"finite: {losses} {norms.tolist()}")
    _require(last < first - LM_TRAIN_LOSS_DROP,
             f"[lm-train] {LM_TRAIN_ARCH}: loss {first:.4f} -> {last:.4f}, "
             f"not down by {LM_TRAIN_LOSS_DROP}")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the same run in a child, SIGKILLed once LATEST reads 20
    root = os.path.join(work, "ckpt")
    cmd = [sys.executable, os.path.abspath(__file__), "--lm-train-child",
           root]
    t0 = time.perf_counter()
    with open(os.path.join(work, "killed.log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 600
            while proc.poll() is None and time.monotonic() < deadline:
                if latest_step(root) == LM_TRAIN_KILL_AT:
                    proc.send_signal(signal.SIGKILL)
                    break
                time.sleep(0.005)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
    row["child_s"] = time.perf_counter() - t0
    _require(proc.returncode == -signal.SIGKILL,
             f"[lm-train] the child run ended with {proc.returncode} before "
             f"it was killed (log: {work}/killed.log)")
    _require(latest_step(root) == LM_TRAIN_KILL_AT,
             f"[lm-train] LATEST reads {latest_step(root)} after the kill")

    # resumed in this process from the child's step-20 checkpoint
    t0 = time.perf_counter()
    params, resumed = launcher.run(LM_TRAIN_ARCH, ckpt_dir=root, device=dev,
                                   **LM_TRAIN_RUN)
    row["resume_s"] = time.perf_counter() - t0
    want = losses[LM_TRAIN_KILL_AT:]
    _require(len(resumed) == len(want),
             f"[lm-train] the resumed run took {len(resumed)} steps, not "
             f"{len(want)}")
    rels = [abs(a - b) / abs(b) for a, b in zip(resumed, want)]
    row["resumed_losses"] = resumed
    row["resume_loss_rel"] = max(rels)
    row["resume_bitwise_equal"] = resumed == want
    _require(row["resume_loss_rel"] <= LM_TRAIN_RESUME_TOL,
             f"[lm-train] resumed losses {resumed} against the "
             f"uninterrupted run's {want}: rel {max(rels):.3g} > "
             f"{LM_TRAIN_RESUME_TOL}")

    # the step-20 checkpoint as the launcher restores it, bit for bit,
    # and written again by save_async: the same files
    like = {"params": params, "opt": init_opt(params)}
    state, extra = restore(root, LM_TRAIN_KILL_AT, like)
    _require(extra == {"data_step": LM_TRAIN_KILL_AT}, extra)
    step_dir = os.path.join(root, f"step_{LM_TRAIN_KILL_AT:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    restored = dict(zip((m["path"] for m in manifest), tree_leaves(state)))
    for m in manifest:
        t = restored[m["path"]]
        _require(t.device.type == "cuda", m["path"])
        saved = np.load(os.path.join(step_dir, m["file"]))
        saved = torch.from_numpy(saved.view(f"i{saved.dtype.itemsize}"))
        _require(torch.equal(_leaf_bits(t), saved.reshape(t.shape)),
                 f"[lm-train] restored {m['path']} differs from the saved "
                 f"bits")
    again = os.path.join(work, "again")
    torch.cuda.synchronize(dev)
    ck = AsyncCheckpointer(again)
    t0 = time.perf_counter()
    ck.save_async(LM_TRAIN_KILL_AT, state, extra=extra)
    row["snapshot_ms"] = (time.perf_counter() - t0) * 1e3
    ck.wait()
    row["write_s"] = time.perf_counter() - t0 - row["snapshot_ms"] / 1e3
    row["ckpt_gb"] = 0.0
    for m in manifest:
        with open(os.path.join(step_dir, m["file"]), "rb") as f:
            a = f.read()
        with open(os.path.join(again, os.path.basename(step_dir),
                               m["file"]), "rb") as f:
            _require(f.read() == a, f"[lm-train] {m['file']} written "
                                    f"again differs")
        row["ckpt_gb"] += len(a) / 1e9
    row["leaves"] = len(manifest)
    del state, like, params
    gc.collect()
    torch.cuda.empty_cache()

    # the launcher's loop timed apart, in turns before any profiler
    # (LM_TRAIN_TURNS): "unbind", the step as the launcher runs it, its
    # loss read every step; "no_read", one sync at the end; "index", the
    # models' layers indexed from the stacked leaves (the layer split
    # before unstack_layers).  Host wall and process CPU ms a step.
    model = build_model(cfg, dev, torch.Generator(dev).manual_seed(0))
    params = model.params()
    opt = [init_opt(params)]
    step = make_train_step(model, AdamWConfig(), TrainStepConfig(
        remat="none", warmup_steps=max(1, steps // 20), total_steps=steps))
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                src.batch(step=i, shard=0, n_shards=1, batch=B,
                          seq=S).items()}
               for i in range(LM_TRAIN_TIMED_STEPS)]

    def one(i=0, read=True):
        _, opt[0], m = step(params, opt[0], batches[i % len(batches)])
        return float(m["loss"]) if read else m["loss"]

    from repro_torch.models.blocks import unstack_layers
    turns = {name: [] for name in LM_TRAIN_TURNS}
    for name in LM_TRAIN_TURNS:
        with _layer_split(_indexed_layers if name == "index"
                          else unstack_layers):
            one(0)                      # warm, after a switch of split
            torch.cuda.synchronize(dev)
            t0, c0 = time.perf_counter(), time.process_time()
            for i in range(LM_TRAIN_TIMED_STEPS):
                one(i, read=name != "no_read")
            torch.cuda.synchronize(dev)
            turns[name].append({
                "ms_per_step": (time.perf_counter() - t0) * 1e3
                / LM_TRAIN_TIMED_STEPS,
                "cpu_ms_per_step": (time.process_time() - c0) * 1e3
                / LM_TRAIN_TIMED_STEPS})
    row["turns"] = turns
    row["ms_per_step_read"] = _median(
        [t["ms_per_step"] for t in turns["unbind"]])
    row["ms_per_step_no_read"] = _median(
        [t["ms_per_step"] for t in turns["no_read"]])
    row["step_kernels"], row["step_device_ms"], row["top_kernels"] = (
        _step_profile(dev, one, top=LM_TRAIN_TOP_KERNELS))
    row["idle_share"] = (1.0 - row["step_device_ms"] / row["ms_per_step_read"]
                         if row["step_kernels"] else None)
    with _layer_split(_indexed_layers):
        row["index_kernels"], row["index_device_ms"] = _step_profile(dev, one)
    row["tflop_per_step"] = 6 * sum(p.numel() for p in tree_leaves(
        params)) * B * S / 1e12
    del model, params, opt, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    idle = ("no device time in the trace" if row["idle_share"] is None else
            f"{row['step_kernels']} kernels, {row['step_device_ms']:.2f} ms "
            f"of device time: idle {row['idle_share']:.1%}")
    print(f"[lm-train] {LM_TRAIN_ARCH} full width {cfg.dtype} "
          f"({row['param_gb']:.2f} GB of parameters): {steps} steps of "
          f"{B} x {S} in {row['run_s']:.2f} s, the launcher's loop "
          f"{row['loop_ms_per_step']:.2f} ms a step = "
          f"{row['tok_per_s']:.0f} tok/s, peak {row['peak_gb']:.2f} GB; "
          f"loss {first:.4f} -> {last:.4f} (first and last 5); timed apart "
          f"{row['ms_per_step_read']:.2f} ms a step with the per-step loss "
          f"read, {row['ms_per_step_no_read']:.2f} without; {idle}",
          flush=True)
    _print_top(LM_TRAIN_ARCH, row["top_kernels"])
    print(f"[lm-train] {LM_TRAIN_ARCH} in turns {LM_TRAIN_TURNS}, ms a "
          f"step (host wall / process CPU): " + "; ".join(
              f"{name} " + ", ".join(f"{t['ms_per_step']:.2f} / "
                                     f"{t['cpu_ms_per_step']:.2f}"
                                     for t in ts)
              for name, ts in turns.items()) +
          f"; the index split launches {row['index_kernels']} kernels, "
          f"{row['index_device_ms']:.2f} ms on the device", flush=True)
    print(f"[lm-train] {LM_TRAIN_ARCH} killed after LATEST read "
          f"{LM_TRAIN_KILL_AT} ({row['child_s']:.1f} s), resumed in "
          f"{row['resume_s']:.1f} s: steps {LM_TRAIN_KILL_AT + 1}-{steps} "
          f"losses within rel {row['resume_loss_rel']:.3g} of the "
          f"uninterrupted run's ("
          f"{'bitwise equal' if row['resume_bitwise_equal'] else 'not bitwise equal'}"
          f"); the restored tree equals the saved bits ({row['leaves']} "
          f"leaves); save_async: snapshot {row['snapshot_ms']:.1f} ms, "
          f"write {row['write_s']:.2f} s, {row['ckpt_gb']:.2f} GB, the "
          f"same files", flush=True)
    return row


def _lm_train_q8(dev):
    """(c): zamba2-2.7b at full width with microbatches, full remat and
    8-bit moments."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_opt_q8
    from repro_torch.train import TrainStepConfig, make_train_step
    from repro_torch.utils import tree_leaves
    cfg = get_config(LM_TRAIN_Q8_ARCH)
    B, S, n = (LM_TRAIN_Q8_RUN[k] for k in ("batch", "seq", "steps"))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev, torch.Generator(dev).manual_seed(0))
    params = model.params()
    opt = [init_opt_q8(params)]
    step = make_train_step(model, AdamWConfig(), TrainStepConfig(
        warmup_steps=1, total_steps=n, **LM_TRAIN_Q8_KNOBS))
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    losses, norms, walls = [], [], []
    for i in range(n):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in src.batch(
            step=i, shard=0, n_shards=1, batch=B, seq=S).items()}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, opt[0], m = step(params, opt[0], batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    kernels, device_ms, top = _step_profile(
        dev, lambda: step(params, opt[0], batch), calls=1,
        top=LM_TRAIN_TOP_KERNELS)
    numel = [p.numel() for p in tree_leaves(params)]
    f32_bytes = 2 * 4 * sum(numel) + 4
    q8_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(opt[0]))
    ms = _median(walls[1:]) * 1e3
    row = {"arch": LM_TRAIN_Q8_ARCH, **LM_TRAIN_Q8_RUN, **LM_TRAIN_Q8_KNOBS,
           "param_gb": sum(p.numel() * p.element_size()
                           for p in tree_leaves(params)) / 1e9,
           "losses": losses, "grad_norms": norms,
           "ms_per_step": ms, "tok_per_s": B * S / ms * 1e3,
           "step_kernels": kernels, "step_device_ms": device_ms,
           "top_kernels": top,
           "idle_share": 1.0 - device_ms / ms if kernels else None,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "f32_state_gb": f32_bytes / 1e9, "q8_state_gb": q8_bytes / 1e9,
           "state_ratio": f32_bytes / q8_bytes}
    del model, params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    _require(all(map(math.isfinite, losses + norms)),
             f"[lm-train] {LM_TRAIN_Q8_ARCH}: losses {losses}, grad norms "
             f"{norms}")
    _require(row["state_ratio"] >= LM_TRAIN_Q8_RATIO,
             f"[lm-train] {LM_TRAIN_Q8_ARCH}: f32 state / q8 state "
             f"{row['state_ratio']:.3f} < {LM_TRAIN_Q8_RATIO}")
    idle = ("no device time in the trace" if row["idle_share"] is None else
            f"{kernels} kernels, {device_ms:.1f} ms of device time: idle "
            f"{row['idle_share']:.1%}")
    print(f"[lm-train] {LM_TRAIN_Q8_ARCH} full width {cfg.dtype} "
          f"({row['param_gb']:.2f} GB of parameters), {n} steps of {B} x "
          f"{S}, microbatches 2, remat full, 8-bit moments: "
          f"{ms:.1f} ms a step = {row['tok_per_s']:.0f} tok/s, peak "
          f"{row['peak_gb']:.2f} GB; {idle}; losses "
          f"{[round(x, 4) for x in losses]}; state {row['q8_state_gb']:.2f} "
          f"GB q8 against {row['f32_state_gb']:.2f} GB f32 "
          f"({row['state_ratio']:.3f}x)", flush=True)
    _print_top(LM_TRAIN_Q8_ARCH, top)
    return row


def phase_lm_train(dev, table):
    """The LM training path (``[lm-train]``): every arch reduced on the
    card against the CPU; qwen2-0.5b through the launcher at full width,
    crashed and resumed; zamba2-2.7b at full width with the three knobs.
    The kernels' counts are zeroed before the full-width drives and read
    after: no kernel lies on this path."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    counters = {k["name"]: k["counter"] for k in table}
    counters.update(flash_attention=flash_attention_kernel,
                    ssd_scan=ssd_scan_kernel)
    t0 = time.perf_counter()
    out = {"reduced": _lm_train_reduced(dev)}
    for c in counters.values():
        c.launches = 0
    out[LM_TRAIN_ARCH] = _lm_train_full(dev)
    out[LM_TRAIN_Q8_ARCH] = _lm_train_q8(dev)
    out["launches"] = {n: c.launches for n, c in counters.items()}
    out["seconds"] = time.perf_counter() - t0
    print(f"[lm-train] {out['seconds']:.1f} s; kernel launches on the "
          f"training path: {out['launches']}", flush=True)
    return out


# ----------------------------------------------------------------------
# [lm-dryrun]: the knob walk, the sharded dry run, one rung on the card
# ----------------------------------------------------------------------
# the reference's knob walk at the card's 80 GB over (data 16, model 16)
# on train_4k: arch -> (microbatches, remat, accumulation, planned GB)
LM_DRYRUN_PLANS = {
    "gemma2-9b": (1, "full", "float32", 52.60),
    "kimi-k2-1t-a32b": (8, "full", "bfloat16", 66.91),
    "mamba2-780m": (1, "full", "float32", 28.30),
    "nemotron-4-15b": (2, "full", "float32", 40.06),
    "phi3.5-moe-42b-a6.6b": (1, "full", "bfloat16", 48.00),
    "qwen2-0.5b": (1, "dots", "float32", 29.00),
    "qwen2-vl-72b": (4, "full", "bfloat16", 70.80),
    "starcoder2-7b": (1, "full", "float32", 52.43),
    "whisper-large-v3": (1, "dots", "float32", 54.27),
    "zamba2-2.7b": (1, "full", "float32", 48.29),
}
LM_DRYRUN_PRICED = 60
LM_DRYRUN_SURVIVORS = 500        # the elastic event: 12 of 512 ranks lost
# (arch, shape, mesh, --auto), traced at full width and depth
LM_DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "pod", True),
                   ("qwen2-0.5b", "train_4k", "multipod", True),
                   ("gemma2-9b", "decode_32k", "pod", False),
                   ("zamba2-2.7b", "prefill_32k", "pod", False))
# the cell whose rung runs on the card, and the rung: the walk maps
# mb 1 dots, which traces at 896.6 GB a device (the float32 scores of 14
# heads the model axis cannot split, saved as products); mb 1 full
# peaked at 79.69 GB allocated in one run and ran out of memory in
# another (14 GiB score buffers, fragmented); mb 2 full is the next
# rung (my chip runs, PR 23; PERF.md §6)
LM_DRYRUN_CONFIRM = ("qwen2-0.5b", "train_4k", "pod")
LM_DRYRUN_RUNG = dict(microbatches=2, remat="full")
LM_DRYRUN_WARMUP, LM_DRYRUN_STEPS = 1, 2
LM_DRYRUN_TIMEOUT = 900


def _dryrun_counters():
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.ssd_scan import ssd_scan_kernel
    counters = {k["name"]: k["counter"] for k in kernel_table()[1]}
    counters.update(flash_attention=flash_attention_kernel,
                    ssd_scan=ssd_scan_kernel)
    return counters


def _autoshard_walk():
    """(a): ``repro_torch.examples.autoshard`` at the card's budget —
    every arch on train_4k over (data 16, model 16) through one shared
    ledger, the elastic re-plan of gemma2-9b, then the unchanged stage
    again — its plans held against the reference's."""
    from repro_torch.examples.autoshard import SURVIVORS, walk
    _require(SURVIVORS == LM_DRYRUN_SURVIVORS, SURVIVORS)
    out = walk(prefix="[lm-dryrun] ")
    plans, priced, again = out["plans"], out["priced"], out["unchanged_new"]
    _require(plans == {a: LM_DRYRUN_PLANS[a] for a in plans}
             and set(plans) == set(LM_DRYRUN_PLANS),
             f"[lm-dryrun] the walk's plans differ from the reference's: "
             f"{plans}")
    _require(priced == LM_DRYRUN_PRICED,
             f"[lm-dryrun] {priced} priced invocations, not "
             f"{LM_DRYRUN_PRICED}")
    _require(again == 0, f"[lm-dryrun] the unchanged re-plan priced {again}")
    return out


def _print_cell(rec):
    m, c, r = rec["memory"], rec["cost"], rec["roofline"]
    coll = rec["collectives"]
    kinds = ", ".join(f"{k} {coll['per_op'][k] / 1e9:.3f} GB x "
                      f"{coll['per_op_count'][k]}"
                      for k in sorted(coll["per_op"]))
    plan = ""
    if "planned_bytes" in rec:
        plan = (f"; planned {rec['planned_bytes'] / 1e9:.2f} GB beside "
                f"argument + temp "
                f"{(m['argument_bytes'] + m['temp_bytes']) / 1e9:.2f} GB "
                f"(mb {rec['microbatches']}, {rec['remat']})")
    print(f"[lm-dryrun] {rec['arch']} x {rec['shape']} x {rec['mesh']} "
          f"({rec['devices']} ranks): {rec['status']}, trace "
          f"{rec['lower_s']} s, analysis {rec['compile_s']} s; argument "
          f"{m['argument_bytes'] / 1e9:.3f} GB, output "
          f"{m['output_bytes'] / 1e9:.3f} GB, temp "
          f"{m['temp_bytes'] / 1e9:.3f} GB a device; "
          f"{c['flops_per_device']:.4g} FLOP and "
          f"{c['bytes_per_device']:.4g} B a device; collectives {kinds}; "
          f"roofline on the H100 table: compute {r['t_compute_s']:.4g} s, "
          f"memory {r['t_memory_s']:.4g} s, collective "
          f"{r['t_collective_s']:.4g} s, bound {r['bound']}{plan}",
          flush=True)


def _confirm_rung(dev, walk, records, rec_dir):
    """(c): a rung of ``LM_DRYRUN_CONFIRM``'s cell run for real — rank
    0's partition on the card, the trace's shardings with real tensors.
    The walk's mapped rung must trace past the card's memory for
    ``LM_DRYRUN_RUNG`` to stand in for it (the next rung down the ladder
    that runs: PERF.md §6); the stand-in is traced too."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.autotune import _LADDER, price_train_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    arch, shape_name, mesh_kind = LM_DRYRUN_CONFIRM
    cfg, shape = get_config(arch), get_shape(shape_name)
    mb, remat, accum, _ = walk["plans"][arch]
    mapped = dict(microbatches=mb, remat=remat)
    mesh_sizes = dryrun.MESH_SHAPES[mesh_kind]
    card = torch.cuda.get_device_properties(dev).total_memory
    rung = LM_DRYRUN_RUNG
    rows = []
    for r in (mapped, rung) if rung != mapped else (mapped,):
        rec = records[(arch, shape_name, mesh_kind)] if r == mapped else \
            dryrun.run_cell(arch, shape_name, mesh_kind, accum_dtype=accum,
                            out_dir=rec_dir, verbose=False, device=dev,
                            extra_tag=f"mb{r['microbatches']}_{r['remat']}",
                            **r)
        _require(rec["status"] == "ok",
                 f"[lm-dryrun] rung {r}: {rec.get('error')}")
        plan = price_train_step(cfg, shape, mesh_sizes, accum_dtype=accum,
                                **r)
        rows.append({"rung": r, "lower_s": rec["lower_s"],
                     "traced_bytes": rec["memory"]["argument_bytes"]
                     + rec["memory"]["temp_bytes"],
                     "planned_bytes": plan.est_bytes,
                     "t_compute_s": rec["roofline"]["t_compute_s"]})
        print(f"[lm-dryrun] rung mb {r['microbatches']} {r['remat']}: "
              f"traced argument + temp {rows[-1]['traced_bytes'] / 1e9:.2f} "
              f"GB against the card's {card / 1e9:.2f} GB (planned "
              f"{plan.est_bytes / 1e9:.2f} GB)", flush=True)
    if rung != mapped:
        _require(_LADDER.index(rung) > _LADDER.index(mapped)
                 and rows[0]["traced_bytes"] > card,
                 f"[lm-dryrun] the mapped rung {mapped} fits the card "
                 f"({rows[0]['traced_bytes'] / 1e9:.2f} GB traced): confirm "
                 f"it, not {rung}")
    chosen = rows[-1]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                device=dev)
    run = dryrun.run_partition(cfg, shape, mesh, accum_dtype=accum,
                               steps=LM_DRYRUN_STEPS, warmup=LM_DRYRUN_WARMUP,
                               **rung)
    ms = float(np.median(run["step_ms"]))
    row = {"rung": rung, "mapped": mapped, "rows": rows,
           "max_memory_allocated": run["max_memory_allocated"],
           "traced_bytes": chosen["traced_bytes"],
           "planned_bytes": chosen["planned_bytes"],
           "step_ms": run["step_ms"], "ms": ms,
           "t_compute_ms": chosen["t_compute_s"] * 1e3,
           "local_input_bytes": run["local_input_bytes"],
           "card_bytes": card}
    moved = ("" if rung == mapped else
             f" (the mapped rung mb {mb} {remat} traces past the card)")
    print(f"[lm-dryrun] confirmed {arch} x {shape_name} x {mesh_kind} at mb "
          f"{rung['microbatches']} {rung['remat']}{moved}: rank 0's "
          f"partition on the card, max_memory_allocated "
          f"{run['max_memory_allocated'] / 1e9:.2f} GB beside traced "
          f"argument + temp {chosen['traced_bytes'] / 1e9:.2f} GB and "
          f"planned {chosen['planned_bytes'] / 1e9:.2f} GB (measured / "
          f"planned {run['max_memory_allocated'] / chosen['planned_bytes']:.3f}"
          f"); {ms:.1f} ms a step (steps "
          f"{[round(t, 1) for t in run['step_ms']]}) beside the roofline "
          f"compute term {row['t_compute_ms']:.1f} ms. The fake group's "
          f"collectives move no data, so the loss of this run is not a "
          f"number to check; its footprint and local kernels are real.",
          flush=True)
    return row


def lm_dryrun_child(out_path):
    """The ``[lm-dryrun]`` phase's work, in a process of its own (a
    process group belongs to the whole process): (a) the knob walk,
    (b) the dry-run cells, (c) the confirmed rung; its numbers to
    ``out_path``."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import release_mesh
    dev = torch.device("cuda", 0)
    counters = _dryrun_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = {"walk": _autoshard_walk()}
    rec_dir = os.path.join(os.path.dirname(out_path), "records")
    records = {}
    for arch, shape, mesh_kind, auto in LM_DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, mesh_kind, auto=auto,
                              out_dir=rec_dir, verbose=False, device=dev)
        _require(rec["status"] == "ok",
                 f"[lm-dryrun] {arch} x {shape} x {mesh_kind}: "
                 f"{rec.get('error')}\n{rec.get('traceback')}")
        _print_cell(rec)
        records[(arch, shape, mesh_kind)] = rec
    out["cells"] = list(records.values())
    out["confirm"] = _confirm_rung(dev, out["walk"], records, rec_dir)
    release_mesh()
    out["launches"] = {n: c.launches for n, c in counters.items()}
    out["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)


def phase_lm_dryrun():
    """The sharded dry run (``[lm-dryrun]``) in a child process; its
    lines print here, and every kernel's count from its run (none is on
    this path) comes back."""
    work = os.path.join(HERE, "build", "lm_dryrun")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out_path = os.path.join(work, "out.json")
    cmd = [sys.executable, os.path.abspath(__file__), "--lm-dryrun-child",
           out_path]
    t0 = time.perf_counter()
    with open(os.path.join(work, "child.log"), "w") as log:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=LM_DRYRUN_TIMEOUT)
        log.write(proc.stdout)
    for line in proc.stdout.splitlines():
        if line.startswith("[lm-dryrun]"):
            print(line, flush=True)
    _require(proc.returncode == 0,
             f"[lm-dryrun] the child exited {proc.returncode}: "
             f"{proc.stdout[-3000:]}")
    with open(out_path) as f:
        out = json.load(f)
    _require(all(r["status"] == "ok" for r in out["cells"])
             and len(out["cells"]) == len(LM_DRYRUN_CELLS),
             "[lm-dryrun] a traced cell is not ok")
    _require(not any(out["launches"].values()),
             f"[lm-dryrun] kernels launched on the dry-run path: "
             f"{out['launches']}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"[lm-dryrun] {out['phase_s']:.1f} s (the child's work "
          f"{out['seconds']:.1f} s); kernel launches on the dry-run path: "
          f"{out['launches']}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    ap.add_argument("--kill-resume-child", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--lm-train-child", metavar="ROOT",
                    help=argparse.SUPPRESS)
    ap.add_argument("--lm-dryrun-child", metavar="OUT",
                    help=argparse.SUPPRESS)
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
    if args.kill_resume_child:
        kill_resume_child(*args.kill_resume_child, torch.device("cuda", 0))
        return 0
    from repro_torch.kernels.build import build_all

    # float32 products in full float32, as the plain versions' reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.lm_train_child:
        _lm_train_child(args.lm_train_child)
        return 0
    if args.lm_dryrun_child:
        lm_dryrun_child(args.lm_dryrun_child)
        return 0
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
    with tempfile.TemporaryDirectory() as rec_dir:
        dse = phase_dse(dev, table, rec_dir)
        fleet_dse = phase_fleet_dse(dev)
        share_plm, plm_fronts = phase_share_plm(dev, table, rec_dir, dse,
                                                fleet_dse)
        service = phase_service(dev, table, rec_dir, dse)
        soc = phase_soc(dev, table, rec_dir, plm_fronts)
        lint = phase_lint(dev, rec_dir)
        record = phase_record(dev, rec_dir)
    kill_resume = phase_kill_resume(dev)
    pricing = phase_pricing()
    times = phase_times(dev, inputs, table)
    fleet_times = phase_fleet_times(dev)
    lm_serve = phase_lm_serve(dev)
    lm_train = phase_lm_train(dev, table)
    lm_dryrun = phase_lm_dryrun()

    kernels = []
    for k in table:
        t = times[k["name"]][TILE]
        kernels.append({
            "name": k["name"], "route": "cuda", "source": k["source"],
            "replaces": k["replaces"],
            "launches": dse["launches"][k["name"]],
            "record_launches": record["launches"][k["name"]],
            "share_plm_launches": share_plm["wami"]["launches"][k["name"]],
            "service_launches": service["launches"][k["name"]],
            "soc_launches": soc["launches"][k["name"]],
            "lm_train_launches": lm_train["launches"][k["name"]],
            "lm_dryrun_launches": lm_dryrun["launches"][k["name"]],
            "max_abs_err": errs[k["name"]],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": [TILE, TILE], "knobs": {"ports": 1, "unrolls": 8},
            "call_ms": t["call_ms"],
            "library_max_abs_err": t["library_max_abs_err"],
            "frame512": {key: times[k["name"]][FRAME][key] for key in
                         ("ms", "call_ms", "plain_ms", "bound_ms",
                          "library_ms", "library_max_abs_err")},
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
            "record_launches": record["launches"][k["name"]],
            "share_plm_launches": share_plm["fleet"]["launches"][k["name"]],
            "service_launches": service["launches"][k["name"]],
            "soc_launches": soc["launches"][k["name"]],
            "lm_train_launches": lm_train["launches"][k["name"]],
            "lm_dryrun_launches": lm_dryrun["launches"][k["name"]],
            "max_abs_err": errs[k["name"]],
            **{key: t[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")},
            "shape": "fleet DSE", "knobs": ({"ports": 2, "unrolls": 8}
                                            if k["name"] == "flash_attention"
                                            else {"ports": 1, "unrolls": 8}),
        }
        if "bound_3xtf32_ms" in t:
            entry["bound_3xtf32_ms"] = t["bound_3xtf32_ms"]
        # at the served models' shapes, beside the models' plain versions
        entry["lm_serve"] = {
            label: {key: r[key] for key in keep + ("within_tol",)
                    if key in r}
            for label, r in lm_serve["kernels"][k["name"]].items()}
        for where, r in rows.items():
            if where.startswith(("model", f"d{WIDE_LAYER['d']}")):
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
                       "fleet_dse": fleet_dse, "share_plm": share_plm,
                       "service": service, "soc": soc, "lint": lint,
                       "record": record,
                       "kill_resume": kill_resume,
                       "pricing": pricing, "times": times,
                       "fleet_times": fleet_times, "lm_serve": lm_serve,
                       "lm_train": lm_train, "lm_dryrun": lm_dryrun},
                      f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
