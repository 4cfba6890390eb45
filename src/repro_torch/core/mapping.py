"""Synthesis mapping — the inverse function phi (Section 6.2, Eqs. 4-5).

Given the optimal per-component latency requirements returned by the LP
(synthesis planning), find knob settings whose synthesis meets them.
Within a region (fixed port count) the unroll count is estimated with a
rearranged Amdahl's law:

  mu_target = phi(lam_target, lam_min, lam_max, mu_min, mu_max)
            = [ (lam_min*lam_max*mu_max + lam_target*lam_max*mu_min)
              - (lam_min*lam_max*mu_min + lam_target*lam_min*mu_max) ]
              / [ lam_target * (lam_max - lam_min) ]                (Eq. 5)

Failure handling, both per the paper:
  * mapping picks a mu_target violating the lambda-constraint, or the
    synthesized latency misses lam_target -> increase the unrolls
    ("we are willing to trade area to preserve the throughput");
  * lam_target falls between regions -> use the slowest (lower-right)
    point of the next region with more ports; that corner was already
    synthesized by Algorithm 1, so no new tool invocation happens.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .knobs import Region, Synthesis
from .oracle import OracleLedger

__all__ = ["phi", "MapOutcome", "map_target"]


def phi(lam_target: float, lam_min: float, lam_max: float,
        mu_min: int, mu_max: int) -> float:
    """Eq. (5).  Monotonically decreasing in lam_target on
    [lam_min, lam_max]; phi(lam_max)=mu_min, phi(lam_min)=mu_max."""
    if lam_max <= lam_min:
        return float(mu_max)
    num = ((lam_min * lam_max * mu_max + lam_target * lam_max * mu_min)
           - (lam_min * lam_max * mu_min + lam_target * lam_min * mu_max))
    den = lam_target * (lam_max - lam_min)
    return num / den


@dataclass(frozen=True)
class MapOutcome:
    component: str
    synthesis: Synthesis
    region: Optional[Region]
    requested_lam: float
    fallback: str = ""           # "", "next-region", "slowest", "fastest"


def _sorted_regions(regions: Sequence[Region]) -> List[Region]:
    return sorted(regions, key=lambda r: r.lam_max, reverse=True)


def _area_at(r: Region, lam: float) -> float:
    """Linear area estimate inside a region at latency ``lam`` (between
    the two characterized corners) — the ranking key when several
    regions contain the same latency target."""
    if r.lam_max <= r.lam_min:
        return min(r.area_min, r.area_max)
    t = (r.lam_max - lam) / (r.lam_max - r.lam_min)
    return r.area_min + min(1.0, max(0.0, t)) * (r.area_max - r.area_min)


def _pick_region(regs: Sequence[Region], lam_target: float
                 ) -> Optional[Region]:
    """The region to map ``lam_target`` in.

    Within one tile the paper's rule stands: first containing region in
    lam_max-descending order (fewest ports) — byte-compatible with the
    two-knob engine and with checked-in recordings of its walks.  The
    tile axis makes cross-tile overlap the norm, and there the slowest
    region is frequently a far more expensive large-tile one, so among
    candidates from *different* tiles we take the one expected cheapest
    at the target (legacy order as the deterministic tie-break)."""
    cands = [r for r in regs if r.contains_lambda(lam_target)]
    if not cands:
        return None
    if len({r.tile for r in cands}) <= 1:
        return cands[0]                      # regs is lam_max-descending
    return min(cands, key=lambda r: (_area_at(r, lam_target),
                                     -r.lam_max, r.ports, r.tile))


def map_target(tool: OracleLedger, component: str,
               regions: Sequence[Region], lam_target: float,
               *, max_unroll_bumps: int = 4) -> MapOutcome:
    """Map one component's lam_target to a synthesized implementation."""
    regs = _sorted_regions(regions)
    if not regs:
        raise ValueError(f"{component}: no regions")

    # 1. find the region to map in (cheapest containing lam_target)
    region = _pick_region(regs, lam_target)

    if region is None:
        if lam_target > regs[0].lam_max:
            # slower than every implementation: keep the cheapest point
            r = regs[0]
            s = tool.synthesize(component, unrolls=r.mu_min, ports=r.ports,
                                tile=r.tile)
            return MapOutcome(component, s, r, lam_target, fallback="slowest")
        faster = [r for r in regs if r.lam_max < lam_target]
        if faster:
            # between regions: conservative fallback to the slowest point
            # of the next region with a larger number of ports (already
            # synthesized during characterization -> cache hit).
            r = max(faster, key=lambda r: r.lam_max)
            s = tool.synthesize(component, unrolls=r.mu_min, ports=r.ports,
                                tile=r.tile)
            return MapOutcome(component, s, r, lam_target, fallback="next-region")
        r = min(regs, key=lambda r: r.lam_min)
        s = tool.synthesize(component, unrolls=r.mu_max, ports=r.ports,
                            max_states=(r.facts.h(r.mu_max, r.ports)
                                        if r.facts and r.facts.has_plm_access else None),
                            tile=r.tile)
        return MapOutcome(component, s, r, lam_target, fallback="fastest")

    # 2. Amdahl inverse inside the region
    mu = int(math.ceil(phi(lam_target, region.lam_min, region.lam_max,
                           region.mu_min, region.mu_max)))
    mu = max(region.mu_min, min(region.mu_max, mu))

    last: Optional[Synthesis] = None
    for bump in range(max_unroll_bumps + 1):
        mu_try = min(region.mu_max, mu + bump)
        cap = None
        if region.facts is not None and region.facts.has_plm_access:
            cap = region.facts.h(mu_try, region.ports)
        s = tool.synthesize(component, unrolls=mu_try, ports=region.ports,
                            max_states=cap, tile=region.tile)
        if s.feasible:
            last = s
            if s.lam <= lam_target * (1.0 + 1e-9):
                return MapOutcome(component, s, region, lam_target)
        if mu_try == region.mu_max:
            break
    if last is not None:
        # feasible but misses lam_target: keep it only if within the
        # region bound, else fall through to the next-ports region.
        if last.lam <= region.lam_max + 1e-12 and last.lam <= lam_target * 1.25:
            return MapOutcome(component, last, region, lam_target)

    # 3. trade area for throughput: slowest point of the next region up
    faster = [r for r in regs if r.lam_max < lam_target]
    if faster:
        r = max(faster, key=lambda r: r.lam_max)
        s = tool.synthesize(component, unrolls=r.mu_min, ports=r.ports,
                            tile=r.tile)
        return MapOutcome(component, s, r, lam_target, fallback="next-region")
    r = min(regs, key=lambda r: r.lam_min)
    cap = r.facts.h(r.mu_max, r.ports) if r.facts and r.facts.has_plm_access else None
    s = tool.synthesize(component, unrolls=r.mu_max, ports=r.ports,
                        max_states=cap, tile=r.tile)
    return MapOutcome(component, s, r, lam_target, fallback="fastest")
