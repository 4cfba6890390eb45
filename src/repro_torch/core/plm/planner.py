"""The system-level PLM planner: greedy shared-bank grouping.

Given one mapped implementation per component (a Fig. 10 design point),
the planner replaces the paper's naive memory cost — every component
pays for a private PLM — with a planned memory subsystem: components
certified mutually exclusive by the TMG (:mod:`.compat`) are greedily
packed onto shared multi-bank PLMs, and a group is only formed when the
shared architecture is genuinely cheaper than the private copies it
replaces.  That guard makes the planned system cost *pointwise* no
worse than the per-component sum, so the shared-PLM system front
dominates or equals the naive front by construction; the interesting
question is by how much.

Everything is deterministic: requirements are processed in a fixed
order (descending private PLM area, then name) and groups are scanned
in creation order, so identical inputs produce identical plans.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..knobs import Synthesis
from ..memgen import MemGen, PLMSpec
from ..tmg import TMG
from .compat import CompatSource, MemoryCompatGraph
from .spec import (MemoryGroup, MemoryPlan, PLMRequirement,
                   requirement_from_synthesis)

__all__ = ["PLMPlanner", "shared_area"]

# arbitration cost per extra client of a byte-unit (shared-memory) bank:
# descriptors + barriers for the second stream into the same tile
_BYTES_ARB_PER_CLIENT = 4096


def shared_area(reqs: Sequence[PLMRequirement],
                memgen: MemGen) -> Tuple[float, int, int, int, int]:
    """Area of one PLM serving ``reqs`` exclusively, in their unit.

    Returns (area, capacity, word_bits, ports, banks).  ``"mm2"``
    requirements go through :meth:`MemGen.generate_shared`;
    ``"bytes"`` (shared-memory) requirements take the envelope footprint
    plus a fixed arbitration overhead per extra client.
    """
    unit = reqs[0].unit
    if any(r.unit != unit for r in reqs):
        raise ValueError("mixed units in one shared group")
    if unit == "bytes":
        area = (max(float(r.area_plm) for r in reqs)
                + _BYTES_ARB_PER_CLIENT * (len(reqs) - 1))
        cap = max(r.capacity for r in reqs)
        return (area, cap, max(r.word_bits for r in reqs),
                max(r.ports for r in reqs), 0)
    plm = memgen.generate_shared([
        PLMSpec(words=r.capacity, word_bits=r.word_bits, ports=r.ports)
        for r in reqs])
    return (plm.area, max(r.capacity for r in reqs), plm.word_bits,
            plm.ports, plm.banks)


class PLMPlanner:
    """Plans the shared memory subsystem for mapped design points.

    ``tmg`` supplies the compatibility certificate (built once);
    ``exclude`` names transitions that have no PLM to share (software
    components such as WAMI's Matrix-Inv).  The planner is stateless
    across calls — every mapped point is planned independently, because
    the mapped port counts (and hence the shared envelopes) differ per
    point.
    """

    def __init__(self, tmg: TMG, *, memgen: Optional[MemGen] = None,
                 exclude: Sequence[str] = ()):
        self.tmg = tmg
        self.compat = MemoryCompatGraph.for_tmg(tmg)   # built once per TMG
        self.memgen = memgen or MemGen()
        self.exclude = frozenset(exclude)

    # ------------------------------------------------------------------
    def requirements(self, tool, syntheses: Dict[str, Synthesis]
                     ) -> List[PLMRequirement]:
        """Extract one requirement per component via the backend's
        ``plm_requirement`` (falling back to the generic detail-based
        extraction), skipping excluded components."""
        out: List[PLMRequirement] = []
        fn = getattr(tool, "plm_requirement", None)
        for name in sorted(syntheses):
            synth = syntheses[name]
            if name in self.exclude:
                # excluded = nothing to SHARE, not free: the component's
                # whole area stays in the plan as unsplittable logic, so
                # the planned cost never silently drops a component
                out.append(PLMRequirement(
                    component=name, capacity=0, word_bits=0,
                    ports=synth.ports, area_plm=0.0,
                    area_logic=float(synth.area), tile=synth.tile))
                continue
            req = fn(name, synth) if fn is not None else None
            if req is None:
                req = requirement_from_synthesis(name, synth)
            out.append(req)
        return out

    def plan(self, requirements: Sequence[PLMRequirement],
             compat: Optional[CompatSource] = None) -> MemoryPlan:
        """Greedy grouping with a strict benefit guard.

        Requirements are seeded largest-first; each one joins the first
        existing group whose members it may all share with (same unit,
        pairwise non-concurrent) *and* whose merged shared area does not
        exceed the group's current area plus the requirement's private
        PLM — otherwise it opens its own group.  Capacity-0
        requirements are unsplittable and always stay alone.

        ``compat`` overrides the planner's structural certificate source
        (e.g. a two-tier :class:`CompatSource` carrying
        schedule-conditional pairs); the plan records the source's tag.
        """
        source = compat if compat is not None else self.compat
        tag = getattr(source, "tag", None)
        order = sorted(requirements,
                       key=lambda r: (-r.area_plm, r.component))
        groups: List[List[PLMRequirement]] = []

        def price(g: List[PLMRequirement]) -> float:
            # a group's PLAN price: singletons keep their exact private
            # area (see the override below) — the guard must compare
            # against the same number the final plan charges, or a
            # backend whose area_plm undercuts the shared model could
            # merge into a group dearer than the private copies
            if len(g) == 1:
                return g[0].area_plm
            return shared_area(g, self.memgen)[0]

        for req in order:
            placed = False
            if req.capacity > 0:
                for g in groups:
                    if g[0].unit != req.unit or g[0].capacity <= 0:
                        continue
                    if not source.cliques_containing(
                            tuple(m.component for m in g), req.component):
                        continue
                    if price(g + [req]) <= price(g) + req.area_plm:
                        g.append(req)
                        placed = True
                        break
            if not placed:
                groups.append([req])

        out: List[MemoryGroup] = []
        logic = 0.0
        for g in groups:
            area, cap, bits, ports, banks = shared_area(g, self.memgen)
            private = sum(r.area_plm for r in g)
            if len(g) == 1:
                # a singleton keeps its exact private PLM price — the
                # shared model must not re-price what is not shared
                area, banks = private, 0
            out.append(MemoryGroup(
                members=tuple(sorted(r.component for r in g)),
                capacity=cap, word_bits=bits, ports=ports,
                area=area, area_private=private, unit=g[0].unit,
                banks=banks,
                requirements=tuple(sorted(
                    g, key=lambda r: r.component))))
            logic += sum(r.area_logic for r in g)
        return MemoryPlan(groups=tuple(out),
                          area_memory=sum(gr.area for gr in out),
                          area_logic=logic, compat_tag=tag)

    # ------------------------------------------------------------------
    def plan_point(self, tool, syntheses: Dict[str, Synthesis],
                   schedule=None, tracer=None) -> MemoryPlan:
        """requirements + plan in one call (what the session's map phase
        invokes per design point).

        ``schedule`` (a :class:`~repro_torch.core.planning.Schedule`)
        opens the second certificate tier: busy-interval analysis of the
        LP solution certifies pairs beyond the structural one-token
        cycles (:mod:`repro_torch.core.analysis.intervals`).  Both the
        structural-only and the two-tier plan are computed and the
        cheaper one wins (ties go structural), so the schedule-aware
        front is *pointwise* no worse than the structural-only front —
        the same dominance argument the benefit guard makes against the
        private sum.

        ``tracer`` records a ``plm.plan_point`` span tagged with which
        plan won (``plan="structural"|"two_tier"``), the certificate tier
        in play, and the chosen plan's cost/compat tag.
        """
        from ..obs import NULL_TRACER
        tr = tracer if tracer is not None else NULL_TRACER
        with tr.span("plm.plan_point", components=len(syntheses)) as sp:
            reqs = self.requirements(tool, syntheses)
            base = self.plan(reqs)
            if schedule is None:
                sp.set("tier", "structural")
                sp.set("plan", "structural")
                sp.set("cost", base.system_cost)
                sp.set("tag", getattr(base, "compat_tag", None))
                return base
            from ..analysis.intervals import compat_source_for
            sched_plan = self.plan(reqs,
                                   compat_source_for(self.tmg, schedule))
            sp.set("tier", "two_tier")
            if sched_plan.system_cost < base.system_cost:
                sp.set("plan", "two_tier")
                sp.set("cost", sched_plan.system_cost)
                sp.set("tag", getattr(sched_plan, "compat_tag", None))
                return sched_plan
            sp.set("plan", "structural")
            sp.set("cost", base.system_cost)
            sp.set("tag", getattr(base, "compat_tag", None))
            return base
