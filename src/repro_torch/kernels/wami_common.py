"""Shared geometry of the COSMOS-knob WAMI kernels.

Every WAMI stage kernel maps the paper's two knobs onto the same launch
geometry:

  * ``ports``   -> number of column banks: the W axis splits into
    ``ports`` banks of ``W / ports`` columns, the grid's second axis
    (the multi-bank PLM Mnemosyne would generate);
  * ``unrolls`` -> rows per CTA: loop-body replication, trading the
    block's footprint for fewer CTAs.

The grid is ``(H / unrolls, ports)``; CTA ``(i, j)`` covers rows
``[i * unrolls, (i + 1) * unrolls)`` of column bank ``j``.  This module
holds the knob -> geometry translation, the footprint/grid cost
models, parameterized by the number of input/output blocks a kernel
touches per grid cell, and :func:`run4_geometry`, the threads of the
kernels that take a run of 4 pixels a thread (debayer, gradient, change
detection).
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["knob_blocks", "launch_grid", "vmem_bytes_model",
           "grid_steps_model", "run4_geometry"]


def knob_blocks(H: int, W: int, *, ports: int, unrolls: int
                ) -> Tuple[int, int]:
    """(block_h, block_w) for a knob pair.  Raises ``ValueError`` unless
    the grid divides the frame (the oracle reports non-divisible knob
    points as infeasible before it ever launches one)."""
    if ports < 1 or unrolls < 1 or W % ports or H % unrolls:
        raise ValueError(f"knobs (ports={ports}, unrolls={unrolls}) do not "
                         f"divide the ({H}, {W}) frame")
    return unrolls, W // ports


def launch_grid(H: int, W: int, *, ports: int, unrolls: int
                ) -> Tuple[int, int]:
    """The CUDA grid ``(H / unrolls, ports)`` of a knob pair."""
    bh, _ = knob_blocks(H, W, ports=ports, unrolls=unrolls)
    return H // bh, ports


def vmem_bytes_model(H: int, W: int, *, ports: int, unrolls: int,
                     n_in: int, n_out: int, dtype_bytes: int = 4) -> int:
    """Working set per grid cell: ``n_in`` input + ``n_out`` output
    blocks of (unrolls, W/ports) words each."""
    return (n_in + n_out) * unrolls * (W // ports) * dtype_bytes


def grid_steps_model(H: int, W: int, *, ports: int, unrolls: int) -> int:
    """Grid cells one core would walk in sequence (latency model input)."""
    return (H // unrolls) * ports


def run4_geometry(H: int, W: int, *, ports: int, unrolls: int
                  ) -> Tuple[int, int]:
    """(threads per CTA, passes of the widest CTA) of a run-of-4 launch
    on 16-byte aligned tensors, the formula of ``run4_threads`` in
    ``csrc/wami_common.cuh``: a tile row splits into scalar pixels up to
    its first 16-byte-aligned run of 4, whole runs, and a scalar tail
    (every pixel scalar when W % 4 != 0); a CTA takes one thread per
    item, rounded up to a warp, at most 1,024."""
    bh, bw = knob_blocks(H, W, ports=ports, unrolls=unrolls)
    vec = W % 4 == 0
    items = 0
    for j in range(min(ports, 4)):       # tile columns j * bw, mod 4
        head = min(bw, (4 - j * bw % 4) % 4) if vec else bw
        runs = (bw - head) // 4
        items = max(items, bh * (bw - 3 * runs))   # runs + scalars
    threads = min(1024, -(-items // 32) * 32)
    return threads, -(-items // threads)
