"""Simulated HLS tool: a resource-constrained list scheduler + area model.

The paper drives Cadence C-to-Silicon against an industrial 32nm ASIC
library — neither is available here (DESIGN.md Section 2), so this module
is the synthesis *oracle* that COSMOS coordinates.  It is not a stub: it
schedules the component's loop body (the facts of ``apps.wami.cdfg``)
under port/unroll constraints, reproducing the three
phenomena the paper's methodology exists to handle:

  1. memory dominates — the PLM (from ``core.memgen``) contributes most
     of the area, and the port count moves both latency and area by
     integer factors (Section 3.1);
  2. HLS heuristics are noisy — a deterministic, hash-seeded perturbation
     inserts extra states for controller/resource pressure, growing with
     the unroll factor (Section 3.2, ref [24]), so some syntheses are
     Pareto-dominated and some violate the lambda-constraint;
  3. diminishing returns — load/store phases and dependence depth give
     lambda(u) an Amdahl-shaped profile within a region, which is the
     assumption behind the mapping function phi (Section 6.2).

Everything is deterministic: same knobs => same (lambda, alpha).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional

from .knobs import CDFGFacts, Synthesis
from .memgen import MemGen, PLMSpec
from .oracle import OracleBatchMixin
from .plm.spec import PLMRequirement

__all__ = ["LoopNest", "ComponentSpec", "HLSTool"]


def _hash01(*key) -> float:
    """Deterministic uniform [0,1) from a knob tuple (heuristic 'noise')."""
    h = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


@dataclass(frozen=True)
class LoopNest:
    """The dominant loop of a component, as seen by the scheduler.

    Built from the component's CDFG facts (``apps.wami.cdfg``), or
    written by hand in unit tests.  All counts are per ORIGINAL (un-unrolled)
    iteration.
    """

    trip: int                  # iterations of the dominant loop
    gamma_r: int               # max reads of the same PLM array / iter
    gamma_w: int               # max writes of the same PLM array / iter
    arith_ops: int             # arithmetic ops per iteration
    dep_depth: int             # critical dependence-chain depth (states)
    live_values: int           # values alive across states (register cost)
    has_plm_access: bool = True


@dataclass(frozen=True)
class ComponentSpec:
    """A synthesizable component (SystemC module analogue)."""

    name: str
    loop: LoopNest
    words_in: int              # data loaded into the PLM per execution
    words_out: int             # data stored back per execution
    word_bits: int = 32
    plm_words: int = 0         # PLM capacity; defaults to in+out
    outer_repeats: int = 1     # executions of the loop per accelerator run
    base_tile: int = 0         # native PLM tile edge; 0 = tile-invariant

    def plm_size(self) -> int:
        return self.plm_words or (self.words_in + self.words_out)

    def retile(self, tile: int) -> "ComponentSpec":
        """Rescale the spec to a different PLM tile edge.

        Generic quadratic model: trip / words / PLM capacity scale with
        the tile area, outer repeats inversely (the frame is fixed).  A
        component with ``base_tile == 0`` is tile-invariant and returns
        itself — the tile knob is a no-op for it.  Backends with exact
        per-tile component tables (apps/wami) bypass this via the
        ``HLSTool(retile=...)`` factory instead.
        """
        if not tile or not self.base_tile or tile == self.base_tile:
            return self
        s = (tile / self.base_tile) ** 2
        loop = replace(self.loop, trip=max(1, round(self.loop.trip * s)))
        return replace(
            self, loop=loop,
            words_in=max(1, round(self.words_in * s)),
            words_out=max(1, round(self.words_out * s)),
            plm_words=round(self.plm_words * s) if self.plm_words else 0,
            outer_repeats=max(1, round(self.outer_repeats / s)),
            base_tile=tile)


# 32nm-flavoured area constants (mm^2).  Absolute values are calibrated so
# the WAMI components land in the paper's 0.01-1 mm^2 range; COSMOS's
# claims are about *ratios* (spans, invocation counts), which do not
# depend on the absolute calibration.
_AREA_PER_FU = 4.0e-4          # one arithmetic functional unit (~adder/mul mix)
_AREA_PER_REG = 1.2e-5         # one live 32-bit register
_AREA_CTRL_STATE = 1.0e-5      # controller area per FSM state
_FU_SHARING_EXP = 0.90         # resource sharing: area ~ (ops*u)^0.90
_DMA_WORDS_PER_CYCLE = 8       # 256-bit TLM channel / 32-bit words


class HLSTool(OracleBatchMixin):
    """SynthesisTool backend with the paper's HLS economics.

    Adapts directly to the batched ``Oracle`` protocol via
    :class:`~repro_torch.core.oracle.OracleBatchMixin` (every synthesis is
    pure, so independent knob points fan out over a thread pool).
    ``noise`` scales the heuristic perturbation (0 disables it — useful in
    unit tests of the mapping function's exactness).
    """

    def __init__(self, components: Dict[str, ComponentSpec], *,
                 memgen: Optional[MemGen] = None, noise: float = 1.0,
                 seed: str = "cosmos",
                 retile: Optional[Callable[[int], Dict[str, ComponentSpec]]]
                 = None):
        self.components = dict(components)
        self.memgen = memgen or MemGen()
        self.noise = float(noise)
        self.seed = seed
        # exact per-tile component tables (one call per tile, memoized);
        # absent, ComponentSpec.retile's quadratic model is used
        self._retile = retile
        self._tile_specs: Dict[int, Dict[str, ComponentSpec]] = {}

    def _spec_at(self, component: str, tile: int) -> ComponentSpec:
        base = self.components[component]
        if not tile or tile == base.base_tile:
            return base
        if self._retile is not None:
            specs = self._tile_specs.get(tile)
            if specs is None:
                # benign race: retile factories are pure, setdefault keeps one
                specs = self._tile_specs.setdefault(tile,
                                                    dict(self._retile(tile)))
            if component in specs:
                return specs[component]
        return base.retile(tile)

    def grid_inputs(self, component: str, tile: int
                    ) -> "tuple[ComponentSpec, int]":
        """``(spec, tile_key)`` the scheduler prices at this tile.

        ``tile_key`` is 0 when retiling left the spec unchanged — the
        noise hash must then match the two-knob key exactly (see
        ``_states_per_iter``).
        """
        base = self.components[component]
        spec = self._spec_at(component, tile)
        return spec, (0 if spec == base else tile)

    # ------------------------------------------------------------------
    # Scheduling model
    # ------------------------------------------------------------------
    def _states_per_iter(self, spec: ComponentSpec, unrolls: int, ports: int,
                         tile_key: int = 0) -> int:
        """States the scheduler needs for one unrolled loop iteration."""
        ln = spec.loop
        # Memory states: reads from the same array are serialized over the
        # read ports (stencil reads hit scattered addresses and cannot
        # coalesce).  Unrolled writes are unit-stride across interleaved
        # banks, so the write-combining path issues them in
        # ceil(gamma_w/ports) states regardless of the unroll factor —
        # this is why Eq. (1) does not scale gamma_w by the unrolls.
        rd = math.ceil(ln.gamma_r * unrolls / ports) if ln.gamma_r else 0
        wr = math.ceil(ln.gamma_w / ports) if ln.gamma_w else 0
        mem = rd + wr
        # Compute states: the dependence chain overlaps with memory states
        # except for its residue.
        comp = max(1, ln.dep_depth - max(0, mem - 1))
        states = max(1, mem + comp - 1)
        # Heuristic perturbation (Section 3.2, ref [24]): controller and
        # muxing pressure grows with the unrolled body; the scheduler
        # occasionally inserts extra states (which is what makes some
        # syntheses violate the lambda-constraint and some points
        # Pareto-dominated, as in Fig. 4's 7u/8u/9u).
        if self.noise > 0:
            # hash key grows the tile only when it changes the spec, so a
            # native-tile request reproduces the two-knob results exactly
            key = ((self.seed, spec.name, unrolls, ports, tile_key)
                   if tile_key else (self.seed, spec.name, unrolls, ports))
            r = _hash01(*key)
            p_extra = self.noise * (0.08 + 0.012 * unrolls)
            if r < p_extra:
                states += 1 + int(r * 7919) % max(1, unrolls // 4 + 1)
        return states

    def _latency_s(self, spec: ComponentSpec, unrolls: int, ports: int,
                   states: int, clock_ns: float) -> float:
        ln = spec.loop
        groups = math.ceil(ln.trip / unrolls)
        # load/compute/store phases (Fig. 3); load+store via the fixed
        # 256-bit channel, independent of the knobs (Amdahl's serial part).
        cyc_load = math.ceil(spec.words_in / _DMA_WORDS_PER_CYCLE)
        cyc_store = math.ceil(spec.words_out / _DMA_WORDS_PER_CYCLE)
        cyc_compute = groups * states + ln.dep_depth  # + drain
        cycles = (cyc_load + cyc_compute + cyc_store + 12) * spec.outer_repeats
        return cycles * clock_ns * 1e-9

    def _datapath_area(self, spec: ComponentSpec, unrolls: int, states: int) -> float:
        ln = spec.loop
        fus = (ln.arith_ops * unrolls) ** _FU_SHARING_EXP
        regs = ln.live_values * unrolls
        ctrl = states * math.log2(states + 1.0)
        return _AREA_PER_FU * fus + _AREA_PER_REG * regs + _AREA_CTRL_STATE * ctrl

    # ------------------------------------------------------------------
    # SynthesisTool protocol
    # ------------------------------------------------------------------
    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   clock_ns: float = 1.0, tile: int = 0) -> Synthesis:
        spec, tile_key = self.grid_inputs(component, tile)
        states = self._states_per_iter(spec, unrolls, ports, tile_key)
        if max_states is not None and states > max_states:
            # lambda-constraint violated: the synthesis fails and the
            # point is discarded (Algorithm 1 lines 5-7).
            return Synthesis(lam=float("inf"), area=float("inf"), ports=ports,
                             unrolls=unrolls, states_per_iter=states,
                             feasible=False, tile=tile)
        lam = self._latency_s(spec, unrolls, ports, states, clock_ns)
        area = self._datapath_area(spec, unrolls, states)
        plm = self.memgen.generate(PLMSpec(
            words=spec.plm_size(), word_bits=spec.word_bits, ports=ports))
        return Synthesis(lam=lam, area=area + plm.area, ports=ports,
                         unrolls=unrolls, states_per_iter=states,
                         feasible=True,
                         detail={"area_logic": area, "area_plm": plm.area,
                                 "banks": float(plm.banks),
                                 "plm_words": float(spec.plm_size()),
                                 "word_bits": float(spec.word_bits)},
                         tile=tile)

    def plm_requirement(self, component: str, synth: Synthesis
                        ) -> PLMRequirement:
        """What the synthesized point demands of the memory subsystem —
        the input of the system-level PLM planner (core.plm.planner)."""
        spec = self._spec_at(component, synth.tile)
        area_plm = synth.detail.get("area_plm")
        if area_plm is None:
            area_plm = self.memgen.generate(PLMSpec(
                words=spec.plm_size(), word_bits=spec.word_bits,
                ports=synth.ports)).area
        logic = synth.detail.get("area_logic", synth.area - area_plm)
        return PLMRequirement(component=component, capacity=spec.plm_size(),
                              word_bits=spec.word_bits, ports=synth.ports,
                              area_plm=float(area_plm),
                              area_logic=float(logic), unit="mm2")

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        """Eq. (1) inputs 'inferred by traversing the CDFG created by the
        HLS tool for scheduling the lower-right point' (Section 5)."""
        ln = self._spec_at(component, synth.tile).loop
        # eta: states not attributable to PLM accesses, observed on the
        # synthesized lower-right point.
        mem_states = (math.ceil(ln.gamma_r * synth.unrolls / synth.ports)
                      + math.ceil(ln.gamma_w / synth.ports))
        eta = max(1, synth.states_per_iter - mem_states)
        return CDFGFacts(gamma_r=ln.gamma_r, gamma_w=ln.gamma_w, eta=eta,
                         trip=ln.trip, has_plm_access=ln.has_plm_access)
