"""The COSMOS driver (Fig. 1) and the exhaustive-search baseline.

``cosmos_dse`` — component characterization (Algorithm 1) + synthesis
planning (Eq. 2 LP over the TMG) + synthesis mapping (phi) — is now a
thin wrapper over :class:`repro_torch.core.session.ExplorationSession`, which
batches every independent oracle invocation per phase; ``workers=1``
reproduces the seed's sequential drive call-for-call.  The exhaustive
baseline synthesizes every (ports x unrolls) combination per component —
the paper's Fig. 11 reference — in one batch (all points are
independent), and, for small systems, composes the per-component Pareto
fronts to the exact system front (Fig. 5), which is what COSMOS's mapped
curve is validated against in the tests.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .knobs import KnobSpace
from .oracle import InvocationRequest, OracleCache, OracleLedger
from .pareto import DesignPoint, pareto_front_max_min, pareto_front_min_min
from .session import (CosmosResult, ExplorationSession, ProgressEvent,
                      SystemPoint)
from .tmg import TMG

__all__ = ["SystemPoint", "CosmosResult", "cosmos_dse",
           "ExhaustiveResult", "exhaustive_dse", "compose_exhaustive"]


def cosmos_dse(tmg: TMG, tool, spaces: Dict[str, KnobSpace],
               *, delta: float = 0.25,
               fixed: Optional[Dict[str, float]] = None,
               counting: Optional[OracleLedger] = None,
               workers: int = 1,
               cache: Optional[OracleCache] = None,
               on_event: Optional[Callable[[ProgressEvent], None]] = None
               ) -> CosmosResult:
    """Run the complete COSMOS methodology on a system TMG.

    ``spaces`` maps component name -> knob bounds; ``fixed`` maps
    components executed in software (Matrix-Inv in Fig. 8) to their fixed
    effective latency — they are excluded from synthesis.  ``counting``
    accepts a pre-built :class:`OracleLedger` (the legacy ``CountingTool``
    is one) when the caller wants to share accounting across runs;
    ``workers`` > 1 batches each phase's independent invocations without
    changing any result or count.
    """
    session = ExplorationSession(tmg, tool, spaces, delta=delta, fixed=fixed,
                                 ledger=counting, cache=cache,
                                 workers=workers, on_event=on_event)
    return session.run()


# ----------------------------------------------------------------------
# Exhaustive baseline (Section 3.3 / Fig. 11 reference)
# ----------------------------------------------------------------------
@dataclass
class ExhaustiveResult:
    points: Dict[str, List[DesignPoint]]     # every synthesized point
    fronts: Dict[str, List[DesignPoint]]     # per-component Pareto fronts
    invocations: Dict[str, int]

    @property
    def total_invocations(self) -> int:
        return sum(self.invocations.values())

    def combinations(self) -> float:
        """Number of system-level combinations an exhaustive composition
        must check: prod_i |front_i| (paper: > 9e12 for WAMI)."""
        out = 1.0
        for f in self.fronts.values():
            out *= max(1, len(f))
        return out


def exhaustive_dse(components: Sequence[str], tool,
                   spaces: Dict[str, KnobSpace],
                   counting: Optional[OracleLedger] = None,
                   *, workers: int = 1) -> ExhaustiveResult:
    """Step (i) of the exhaustive method: synthesize ALL knob combinations.

    Every point is independent, so the whole sweep is a single
    ``evaluate_batch`` over the ledger; results (and counts — every
    unique point is invoked exactly once, feasible or not) are identical
    to the sequential drive regardless of ``workers``.
    """
    ctool = counting or OracleLedger(tool, workers=workers)
    requests: List[InvocationRequest] = []
    spans: List[Tuple[str, int, int]] = []      # (component, start, stop)
    for name in components:
        space = spaces[name]
        start = len(requests)
        for tile in space.tiles():
            for ports in space.ports():
                for unrolls in range(max(1, ports), space.max_unrolls + 1):
                    requests.append(InvocationRequest(
                        component=name, unrolls=unrolls, ports=ports,
                        tile=tile))
        spans.append((name, start, len(requests)))

    results = ctool.evaluate_batch(requests, workers=workers)

    points: Dict[str, List[DesignPoint]] = {}
    for name, start, stop in spans:
        pts: List[DesignPoint] = []
        for req, s in zip(requests[start:stop], results[start:stop]):
            if s.feasible:
                knobs = [("ports", req.ports), ("unrolls", req.unrolls)]
                if req.tile:
                    knobs.append(("tile", req.tile))
                pts.append(DesignPoint(perf=s.lam, cost=s.area,
                                       knobs=tuple(knobs)))
        points[name] = pts
    fronts = {n: pareto_front_min_min(p) for n, p in points.items()}
    inv = {n: ctool.invocations[n] for n, _, _ in spans
           if n in ctool.invocations}
    for name, n in ctool.invocations.items():
        inv.setdefault(name, n)
    return ExhaustiveResult(points=points, fronts=fronts, invocations=inv)


def compose_exhaustive(tmg: TMG, fronts: Dict[str, List[DesignPoint]],
                       fixed: Optional[Dict[str, float]] = None,
                       limit: int = 2_000_000) -> List[DesignPoint]:
    """Step (iii): compose per-component Pareto points into the exact
    system front.  Exponential — only for small systems / tests."""
    fixed = fixed or {}
    names = [t.name for t in tmg.transitions]
    choice_lists: List[List[Tuple[float, float]]] = []
    for n in names:
        if n in fixed:
            choice_lists.append([(fixed[n], 0.0)])
        else:
            choice_lists.append([(p.perf, p.cost) for p in fronts[n]])
    total = 1
    for cl in choice_lists:
        total *= len(cl)
    if total > limit:
        raise ValueError(f"{total} combinations exceed limit {limit}")
    out: List[DesignPoint] = []
    for combo in itertools.product(*choice_lists):
        delays = {n: c[0] for n, c in zip(names, combo)}
        cost = sum(c[1] for c in combo)
        out.append(DesignPoint(perf=tmg.throughput(delays), cost=cost))
    return pareto_front_max_min(out)
