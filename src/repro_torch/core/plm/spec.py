"""PLM planning vocabulary: requirements, groups, and system memory plans.

The paper's system cost is the sum of per-component areas, each of which
*includes* a private PLM (hlsim folds Mnemosyne's area into every
synthesis).  The PLM planner breaks that sum apart: every mapped
component states what it *requires* of the memory subsystem
(:class:`PLMRequirement`), the planner groups requirements that may
share physical banks (:mod:`repro_torch.core.plm.compat` certifies the
non-concurrency), and the resulting :class:`MemoryPlan` prices the
memory subsystem once — shared banks instead of private copies — while
datapath (logic) areas stay per-component.

Capacities and areas are unit-tagged (``"mm2"`` for the analytical
backends, ``"bytes"`` for the measured shared-memory backend);
requirements only ever share within one unit, and
:mod:`repro_torch.core.plm.units` is the exchange rate that brings a
mixed system onto a single unit first.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional, Tuple

from ..knobs import Synthesis

__all__ = ["PLMRequirement", "MemoryGroup", "MemoryPlan",
           "requirement_from_synthesis",
           "memory_plan_to_json", "memory_plan_from_json"]


@dataclass(frozen=True)
class PLMRequirement:
    """One mapped component's demand on the memory subsystem.

    ``capacity`` is in words (unit ``"mm2"``) or bytes (unit
    ``"bytes"``); ``area_plm`` is the area of the *private* PLM the
    paper's per-component sum would charge for it, and ``area_logic``
    the datapath remainder.  ``capacity == 0`` marks a requirement whose
    memory cannot be split from its logic — the planner keeps it alone.
    """

    component: str
    capacity: int
    word_bits: int
    ports: int
    area_plm: float
    area_logic: float
    unit: str = "mm2"
    tile: int = 0


@dataclass(frozen=True)
class MemoryGroup:
    """One physical multi-bank PLM serving ``members`` in time-multiplex.

    ``area`` is the shared PLM's area; ``area_private`` what the same
    members would cost as private copies (the per-component sum).  The
    planner only forms groups with ``area <= area_private``, so
    ``saved`` is never negative.  ``requirements`` keeps the member
    requirements the group was formed from, so the independent race
    detector (:mod:`repro_torch.core.analysis.verify`) can re-derive the
    shared envelope without trusting the planner.
    """

    members: Tuple[str, ...]
    capacity: int
    word_bits: int
    ports: int
    area: float
    area_private: float
    unit: str = "mm2"
    banks: int = 0
    requirements: Tuple["PLMRequirement", ...] = ()

    @property
    def saved(self) -> float:
        return self.area_private - self.area


@dataclass(frozen=True)
class MemoryPlan:
    """The planned system memory subsystem for one mapped design point.

    ``compat_tag`` records which certificate tier formed the plan's
    groups: ``None`` for structural-only compatibility, otherwise the
    :meth:`~repro_torch.core.planning.Schedule.tag` of the schedule whose
    conditional certificates the planner consumed — the plan's sharing
    is only sound while the system runs that schedule.
    """

    groups: Tuple[MemoryGroup, ...]
    area_memory: float            # sum of group areas (shared banks)
    area_logic: float             # sum of per-component datapath areas
    compat_tag: Optional[str] = None

    @property
    def system_cost(self) -> float:
        return self.area_memory + self.area_logic

    @property
    def area_private(self) -> float:
        """The paper's naive cost: every component pays for its own PLM."""
        return self.area_logic + sum(g.area_private for g in self.groups)

    @property
    def saved(self) -> float:
        return sum(g.saved for g in self.groups)

    def group_of(self, component: str) -> Optional[MemoryGroup]:
        for g in self.groups:
            if component in g.members:
                return g
        return None


def memory_plan_to_json(plan: MemoryPlan) -> Dict[str, Any]:
    """The plan as a plain dict — what benchmark artifacts commit so the
    independent verifier (:mod:`repro_torch.core.analysis.verify`) can
    re-prove an emitted plan without re-running the planner."""
    return {
        "compat_tag": plan.compat_tag,
        "area_memory": plan.area_memory,
        "area_logic": plan.area_logic,
        "groups": [
            {"members": list(g.members), "capacity": g.capacity,
             "word_bits": g.word_bits, "ports": g.ports, "area": g.area,
             "area_private": g.area_private, "unit": g.unit,
             "banks": g.banks,
             "requirements": [asdict(r) for r in g.requirements]}
            for g in plan.groups],
    }


def memory_plan_from_json(d: Dict[str, Any]) -> MemoryPlan:
    groups = tuple(
        MemoryGroup(
            members=tuple(g["members"]), capacity=int(g["capacity"]),
            word_bits=int(g["word_bits"]), ports=int(g["ports"]),
            area=float(g["area"]), area_private=float(g["area_private"]),
            unit=g["unit"], banks=int(g.get("banks", 0)),
            requirements=tuple(PLMRequirement(**r)
                               for r in g.get("requirements", ())))
        for g in d["groups"])
    return MemoryPlan(groups=groups,
                      area_memory=float(d["area_memory"]),
                      area_logic=float(d["area_logic"]),
                      compat_tag=d.get("compat_tag"))


def requirement_from_synthesis(component: str, synth: Synthesis, *,
                               unit: str = "mm2") -> PLMRequirement:
    """Generic extraction for backends without a ``plm_requirement``
    method: reads the conventional ``detail`` keys when present, and
    otherwise returns an unsplittable (capacity 0) requirement so the
    plan degrades to the naive per-component sum instead of guessing."""
    detail = synth.detail or {}
    area_plm = detail.get("area_plm")
    if area_plm is None:
        return PLMRequirement(component=component, capacity=0,
                              word_bits=0, ports=synth.ports,
                              area_plm=0.0, area_logic=float(synth.area),
                              unit=unit, tile=synth.tile)
    logic = detail.get("area_logic", synth.area - area_plm)
    return PLMRequirement(
        component=component,
        capacity=int(detail.get("plm_words", 0)),
        word_bits=int(detail.get("word_bits", 32)),
        ports=synth.ports,
        area_plm=float(area_plm), area_logic=float(logic),
        unit=unit, tile=synth.tile)
