"""Knob spaces, design-space regions, and the synthesis-tool protocol.

The paper's two knobs are the number of PLM ports (powers of two, Section
5) and the number of loop unrolls.  Regions group points with the same
port count and are bounded by an upper-left (lambda_min, alpha_max) and a
lower-right (lambda_max, alpha_min) corner (Algorithm 1).

``SynthesisTool`` is the expensive oracle being coordinated: the simulated
HLS scheduler (core.hlsim) and the measured CUDA kernels
(core.cuda_oracle).  Invocation accounting — the paper's efficiency
metric (Fig. 11) — lives in :mod:`repro_torch.core.oracle`
(``OracleLedger``) so both backends are measured identically.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple

__all__ = [
    "KnobSpace",
    "Synthesis",
    "CDFGFacts",
    "Region",
    "SynthesisTool",
    "powers_of_two",
]


def powers_of_two(lo: int, hi: int) -> List[int]:
    out, p = [], 1
    while p < lo:
        p *= 2
    while p <= hi:
        out.append(p)
        p *= 2
    return out


@dataclass(frozen=True)
class KnobSpace:
    """Designer-provided exploration bounds (Algorithm 1 inputs).

    ``tile_sizes`` is the optional third knob axis: the PLM tile edge the
    component processes per execution.  Empty (the default) keeps the
    component at its native tile — the paper's two-knob space — and the
    sentinel tile value 0 is used everywhere to mean "native tile".  A
    non-empty tuple makes characterization walk Algorithm 1 once per
    tile, trading PLM *capacity* against PLM *port count* (docs/memory.md).
    """

    clock_ns: float            # target clock period (ns)
    max_ports: int             # PLM ports, explored over powers of two
    max_unrolls: int           # loop unrolling upper bound
    min_ports: int = 1
    tile_sizes: Tuple[int, ...] = ()   # PLM tile edges; () = native only

    def ports(self) -> List[int]:
        return powers_of_two(self.min_ports, self.max_ports)

    def tiles(self) -> List[int]:
        """Tile axis values; [0] (native tile) when the axis is unused."""
        return list(self.tile_sizes) if self.tile_sizes else [0]

    def __post_init__(self):
        if self.max_ports < self.min_ports:
            raise ValueError("max_ports < min_ports")
        if self.max_unrolls < 1:
            raise ValueError("max_unrolls < 1")
        if any(t <= 0 for t in self.tile_sizes):
            raise ValueError("tile_sizes must be positive")


@dataclass(frozen=True)
class CDFGFacts:
    """Eq. (1) inputs, inferred from the CDFG of the lower-right synthesis.

    gamma_r: max reads of the same array per loop iteration.
    gamma_w: max writes of the same array per loop iteration.
    eta:     states needed by non-memory ops (dependence-depth residue).
    trip:    loop trip count of the dominant loop (for latency models).
    has_plm_access: Eq. (1) is inapplicable to loops without PLM accesses
                    (Section 5) — the fallback neighbourhood search is
                    used instead.
    """

    gamma_r: int
    gamma_w: int
    eta: int
    trip: int
    has_plm_access: bool = True

    def h(self, unrolls: int, ports: int) -> int:
        """Eq. (1): upper bound on states per unrolled loop iteration."""
        return (
            math.ceil(self.gamma_r * unrolls / ports)
            + math.ceil(self.gamma_w / ports)
            + self.eta
        )


@dataclass(frozen=True)
class Synthesis:
    """Result of one tool invocation: a characterized implementation."""

    lam: float                  # effective latency (seconds)
    area: float                 # cost alpha (mm^2 or bytes/device)
    ports: int
    unrolls: int
    states_per_iter: int = 0    # scheduler states per loop iteration
    feasible: bool = True       # False when the lambda-constraint failed
    detail: Dict[str, float] = field(default_factory=dict)
    tile: int = 0               # PLM tile edge; 0 = the component's native


@dataclass
class Region:
    """A design-space region (fixed port count and tile) found by
    Algorithm 1.  ``tile`` is 0 when the tile axis is unused."""

    ports: int
    lam_max: float              # lower-right corner: slowest, smallest
    area_min: float
    lam_min: float              # upper-left corner: fastest, largest
    area_max: float
    mu_min: int                 # unrolls at lam_max (== ports, line 3)
    mu_max: int                 # unrolls at lam_min (lambda-constraint sat)
    facts: Optional[CDFGFacts] = None
    tile: int = 0               # PLM tile edge of every point in the region

    def contains_lambda(self, lam: float) -> bool:
        return self.lam_min - 1e-12 <= lam <= self.lam_max + 1e-12

    @property
    def lam_span(self) -> float:
        return self.lam_max / self.lam_min if self.lam_min > 0 else float("inf")

    @property
    def area_span(self) -> float:
        return self.area_max / self.area_min if self.area_min > 0 else float("inf")


class SynthesisTool(Protocol):
    """The expensive oracle COSMOS coordinates (HLS tool + memory generator).

    ``synthesize`` runs datapath synthesis for (unrolls, ports, clock) and
    memory generation for ``ports``; it returns latency+area *including*
    the PLM (Algorithm 1 lines 9-10).  ``max_states`` (optional) imposes
    the lambda-constraint: synthesis FAILS (feasible=False) if the
    scheduler cannot fit an iteration within that many states.
    ``cdfg_facts`` exposes the Eq. (1) inputs extracted from the CDFG of a
    completed synthesis.

    Backends that support the tile knob accept an extra ``tile=<edge>``
    keyword; the engine only passes it when a knob space declares a tile
    axis, so two-knob backends (and pre-tile user tools) keep working
    unchanged.
    """

    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None) -> Synthesis: ...

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts: ...

