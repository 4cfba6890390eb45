"""Exhaustive optimal shared-bank packing (small graphs only).

The greedy planner (:mod:`repro_torch.core.plm.planner`) is a heuristic;
this
module computes the *certified optimum* by enumerating every set
partition of the requirements and pricing each feasible one with the
very same cost model (``shared_area`` for multi-member blocks, the
exact private PLM price for singletons).  Bell(8) = 4140 partitions, so
this is cheap up to the ``max_components`` guard and exponential past
it — it exists as an oracle for the greedy planner's optimality gate,
not as a production planner.

A partition block is feasible exactly under the planner's own rules:
one unit per block, every pair certified non-concurrent by the supplied
:class:`~repro_torch.core.plm.compat.CompatSource`, and no unsplittable
(capacity-0) requirement in a multi-member block.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from ..memgen import MemGen
from ..plm.compat import CompatSource
from ..plm.spec import MemoryGroup, MemoryPlan, PLMRequirement
from ..plm.planner import shared_area

__all__ = ["optimal_plan", "partitions"]

_MAX_COMPONENTS = 8


def partitions(items: Sequence) -> Iterator[List[List]]:
    """All set partitions of ``items`` (each element joins an existing
    block or opens a new one — canonical order, no duplicates)."""
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[first] + part[i]] + part[i + 1:]
        yield [[first]] + part


def _block_feasible(block: Sequence[PLMRequirement],
                    source: CompatSource) -> bool:
    if len(block) == 1:
        return True
    if len({r.unit for r in block}) > 1:
        return False
    if any(r.capacity <= 0 for r in block):
        return False
    for i, u in enumerate(block):
        for v in block[i + 1:]:
            if not source.may_share(u.component, v.component):
                return False
    return True


def _price(block: Sequence[PLMRequirement], memgen: MemGen) -> float:
    # mirror the planner: singletons keep their exact private price
    if len(block) == 1:
        return block[0].area_plm
    return shared_area(sorted(block, key=lambda r: r.component),
                       memgen)[0]


def optimal_plan(requirements: Sequence[PLMRequirement],
                 source: CompatSource, *,
                 memgen: Optional[MemGen] = None,
                 max_components: int = _MAX_COMPONENTS) -> MemoryPlan:
    """The cheapest feasible plan, by exhaustive partition search.

    Deterministic: ties between equal-cost partitions resolve to the
    one with more groups (least sharing), then lexicographically by the
    sorted group members — so the structural optimum is stable across
    runs and the gate test can pin exact numbers.
    """
    if len(requirements) > max_components:
        raise ValueError(
            f"exhaustive packing is exponential: {len(requirements)} "
            f"components > max_components={max_components}")
    memgen = memgen or MemGen()
    reqs = sorted(requirements, key=lambda r: r.component)

    best: Optional[Tuple[float, int, Tuple[Tuple[str, ...], ...],
                         List[List[PLMRequirement]]]] = None
    for part in partitions(reqs):
        if not all(_block_feasible(b, source) for b in part):
            continue
        cost = sum(_price(b, memgen) for b in part)
        key = (cost, -len(part),
               tuple(sorted(tuple(sorted(r.component for r in b))
                            for b in part)))
        if best is None or key < best[:3]:
            best = (key[0], key[1], key[2], part)
    assert best is not None            # singletons are always feasible

    groups: List[MemoryGroup] = []
    logic = 0.0
    for block in sorted(best[3],
                        key=lambda b: sorted(r.component for r in b)):
        block = sorted(block, key=lambda r: r.component)
        area, cap, bits, ports, banks = shared_area(block, memgen)
        private = sum(r.area_plm for r in block)
        if len(block) == 1:
            area, banks = private, 0
        groups.append(MemoryGroup(
            members=tuple(r.component for r in block),
            capacity=cap, word_bits=bits, ports=ports, area=area,
            area_private=private, unit=block[0].unit, banks=banks,
            requirements=tuple(block)))
        logic += sum(r.area_logic for r in block)
    return MemoryPlan(groups=tuple(groups),
                      area_memory=sum(g.area for g in groups),
                      area_logic=logic, compat_tag=source.tag)
