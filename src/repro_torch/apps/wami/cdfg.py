"""CDFG facts of the WAMI components, as a frozen table.

The paper infers the lambda-constraint inputs (gamma_r, gamma_w, eta) "by
traversing the control data flow graph (CDFG) created by the HLS tool for
scheduling the lower-right point" (Section 5).  Each WAMI component's
per-iteration scalar body is such a CDFG; walking it gives

  * ``reads_per_input`` — window elements read per iteration, per input
    array (gamma_r is the largest);
  * ``writes`` — output elements per iteration (gamma_w);
  * ``arith_ops`` / ``dep_depth`` — arithmetic operation count and
    critical dependence-chain depth (the scheduler inputs);
  * ``live_values`` — values alive across states (register cost).

This package does not walk a graph: :data:`WAMI_KERNEL_FACTS` holds the
facts of the 12 components as the JAX package's jaxpr walk
(``repro.apps.wami.cdfg.analyze_kernel``) gives them under jax 0.9 —
including its ``hessian`` and ``change_det`` entries, whose ``jit`` and
``iota`` equations that walk prices as arithmetic.  The analytical fronts
of the two packages are therefore held against each other exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = ["KernelFacts", "WAMI_KERNEL_FACTS"]


@dataclass(frozen=True)
class KernelFacts:
    reads_per_input: Tuple[int, ...]   # window elements read per iteration
    writes: int                        # output elements per iteration
    arith_ops: int
    dep_depth: int
    live_values: int


WAMI_KERNEL_FACTS: Dict[str, KernelFacts] = {
    "debayer": KernelFacts((16,), 12, 48, 4, 32),
    "grayscale": KernelFacts((3,), 1, 5, 3, 8),
    "gradient": KernelFacts((5,), 2, 4, 2, 11),
    "steep_descent": KernelFacts((2, 2), 6, 4, 1, 14),
    "hessian": KernelFacts((6, 21), 21, 582, 14, 31),
    "sd_update": KernelFacts((6, 1, 6), 6, 12, 2, 4),
    "matrix_sub": KernelFacts((1, 1), 1, 1, 1, 4),
    "matrix_add": KernelFacts((1, 1), 1, 1, 1, 4),
    "matrix_mul": KernelFacts((6, 6), 1, 12, 4, 4),
    "matrix_resh": KernelFacts((1,), 1, 1, 1, 4),
    "warp": KernelFacts((4, 2), 1, 12, 5, 11),
    "change_det": KernelFacts((1, 9), 10, 75, 14, 24),
}
