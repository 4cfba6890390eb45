"""Component characterization — Algorithm 1 of the paper (Section 5).

For each port count (powers of two up to ``max_ports``) the algorithm
synthesizes the two corners of a design-space region:

  lower-right (lam_max, alpha_min): unrolls = ports (line 3) — every PLM
      port is exploited, the point is not redundant;
  upper-left (lam_min, alpha_max): the largest unroll count, walking down
      from ``max_unrolls``, whose synthesis satisfies the
      lambda-constraint h_ports(unrolls) of Eq. (1) (lines 4-7).

The PLM for the region's port count is generated and its area added to
both corners (lines 8-10 — our HLSTool folds this in, see hlsim.py).

Eq. (1)'s gamma_r / gamma_w / eta are extracted from the CDFG of the
lower-right synthesis, exactly as in the paper.  For loops without PLM
accesses Eq. (1) is inapplicable (Section 5), and the optional
neighbourhood search is used for the upper-left corner instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .knobs import CDFGFacts, KnobSpace, Region, Synthesis
from .oracle import OracleLedger
from .pareto import DesignPoint, pareto_front_min_min, span

__all__ = ["CharacterizationResult", "characterize_component", "spans"]


@dataclass
class CharacterizationResult:
    component: str
    regions: List[Region]
    points: List[DesignPoint]           # every feasible synthesized point
    invocations: int
    failed: int

    @property
    def lam_span(self) -> float:
        return span([p.perf for p in self.points])

    @property
    def area_span(self) -> float:
        return span([p.cost for p in self.points])


def _point(component: str, s: Synthesis) -> DesignPoint:
    knobs = [("ports", s.ports), ("unrolls", s.unrolls)]
    if s.tile:
        # the third knob axis; only labelled when the space declared it,
        # so two-knob characterizations stay byte-identical to the seed
        knobs.append(("tile", s.tile))
    return DesignPoint(perf=s.lam, cost=s.area, knobs=tuple(knobs),
                       meta=(("states", float(s.states_per_iter)),))


def characterize_component(tool: OracleLedger, component: str,
                           space: KnobSpace, *,
                           neighbourhood: int = 2,
                           prune_dominated_regions: bool = True
                           ) -> CharacterizationResult:
    """Run Algorithm 1 for one component.

    ``prune_dominated_regions`` drops regions whose fast corner is no
    faster than an already-found region (Section 7.2: 'multiple ports can
    incur in additional area for no latency gains' — such components
    report fewer regions in Table 1).  The syntheses spent discovering
    this are still counted, as in Fig. 11.
    """
    before = tool.total(component)
    failed_before = tool.failed.get(component, 0)
    regions: List[Region] = []
    points: List[DesignPoint] = []

    for tile in space.tiles():
        # the no-latency-gain pruning is an argument about one port
        # ladder (Section 7.2); it resets per tile — regions at a
        # smaller tile are cheaper-but-slower and stay Pareto-relevant
        # even when a larger tile is faster everywhere, and the kept
        # set must not depend on tile_sizes ordering
        best_lam_min = float("inf")
        for ports in space.ports():
            # ---- lower-right corner: unrolls = ports (line 3) ---------
            lr = tool.synthesize(component, unrolls=max(1, ports),
                                 ports=ports, tile=tile)
            if not lr.feasible:
                continue
            facts = tool.cdfg_facts(component, lr)
            lam_max, area_min = lr.lam, lr.area
            mu_min = max(1, ports)

            # ---- upper-left corner (lines 4-7) -------------------------
            ul: Optional[Synthesis] = None
            mu_max = mu_min
            if facts.has_plm_access:
                for unrolls in range(space.max_unrolls, max(1, ports), -1):
                    cap = facts.h(unrolls, ports)   # Eq. (1) upper bound
                    cand = tool.synthesize(component, unrolls=unrolls,
                                           ports=ports, max_states=cap,
                                           tile=tile)
                    if cand.feasible:
                        ul, mu_max = cand, unrolls
                        break
            else:
                # Optional neighbourhood search (Section 5, last
                # paragraph): synthesize around max_unrolls and keep a
                # local Pareto point.
                cands: List[Synthesis] = []
                lo = max(max(1, ports) + 1, space.max_unrolls - neighbourhood)
                for unrolls in range(space.max_unrolls, lo - 1, -1):
                    cand = tool.synthesize(component, unrolls=unrolls,
                                           ports=ports, tile=tile)
                    if cand.feasible:
                        cands.append(cand)
                if cands:
                    ul = min(cands, key=lambda s: (s.lam, s.area))
                    mu_max = ul.unrolls

            if ul is None:
                ul, mu_max = lr, mu_min  # degenerate single-point region

            region = Region(ports=ports,
                            lam_max=lam_max, area_min=area_min,
                            lam_min=ul.lam, area_max=ul.area,
                            mu_min=mu_min, mu_max=mu_max, facts=facts,
                            tile=tile)

            improves = region.lam_min < best_lam_min * (1.0 - 1e-9)
            if improves or not prune_dominated_regions or not regions:
                regions.append(region)
                best_lam_min = min(best_lam_min, region.lam_min)
                points.append(_point(component, lr))
                if ul is not lr:
                    points.append(_point(component, ul))

    invocations = tool.total(component) - before
    # per-run delta, like `invocations`: a pre-warmed ledger (restored
    # cache, repeated characterization) must not double-count failures
    failed = tool.failed.get(component, 0) - failed_before
    return CharacterizationResult(component=component, regions=regions,
                                  points=points, invocations=invocations,
                                  failed=failed)


def spans(results: Dict[str, CharacterizationResult]) -> Dict[str, Dict[str, float]]:
    """Table 1 rows: per-component region count and lambda/alpha spans."""
    out: Dict[str, Dict[str, float]] = {}
    for name, res in results.items():
        out[name] = {
            "regions": float(len(res.regions)),
            "lam_span": res.lam_span,
            "area_span": res.area_span,
            "invocations": float(res.invocations),
        }
    return out
