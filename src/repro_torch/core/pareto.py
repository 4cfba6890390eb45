"""Pareto utilities: dominance, fronts, spans, and delta-granularity curves.

Two dominance conventions coexist in the paper, and every function here
is explicitly suffixed with the one it uses — mixing them silently
inverts a front:

  * **min-min** (components): performance is the effective latency
    lambda and cost is the area alpha, both minimized.  Algorithm 1
    regions, per-component fronts, and the exhaustive per-component
    sweep (``exhaustive_dse``) live here.
  * **max-min** (systems): performance is the effective throughput
    theta, MAXIMIZED, while cost alpha is still minimized.  Fig. 10's
    system curve, ``CosmosResult.pareto()``, and the delta-granularity
    condition of Problem 1 live here.

``span`` (max/min ratio over one metric, Section 1.3 / Table 1) is
convention-free; ``check_delta_curve`` is max-min by definition.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    # the point type
    "DesignPoint",
    # min-min convention (components: lambda down, alpha down)
    "dominates_min_min",
    "pareto_front_min_min",
    # max-min convention (systems: theta up, alpha down)
    "dominates_max_min",
    "pareto_front_max_min",
    "check_delta_curve",
    # convention-free diagnostics
    "span",
]


@dataclass(frozen=True)
class DesignPoint:
    """A synthesized implementation.

    ``perf``: latency (component view) or throughput (system view).
    ``cost``: area (mm^2 for hlsim; shared-memory bytes for the CUDA oracle).
    ``knobs``: the knob assignment that produced it.
    ``meta``: free-form (e.g. per-component lambda breakdown at system level).
    """

    perf: float
    cost: float
    knobs: Tuple[Tuple[str, int], ...] = ()
    meta: Tuple[Tuple[str, float], ...] = ()

    def knob(self, name: str) -> int:
        return dict(self.knobs)[name]


def dominates_min_min(a: DesignPoint, b: DesignPoint) -> bool:
    """a dominates b under the COMPONENT convention: both metrics
    minimized (perf = latency lambda, cost = area alpha).  Dominance is
    strict — no-worse on both axes AND strictly better on at least one,
    so duplicated points never dominate each other."""
    return (a.perf <= b.perf and a.cost <= b.cost) and (a.perf < b.perf or a.cost < b.cost)


def dominates_max_min(a: DesignPoint, b: DesignPoint) -> bool:
    """a dominates b under the SYSTEM convention: perf = throughput
    theta MAXIMIZED, cost = area alpha minimized.  Strict in the same
    sense as :func:`dominates_min_min`."""
    return (a.perf >= b.perf and a.cost <= b.cost) and (a.perf > b.perf or a.cost < b.cost)


def _front(points: Sequence[DesignPoint], dom) -> List[DesignPoint]:
    pts = list(points)
    out: List[DesignPoint] = []
    for p in pts:
        if not any(dom(q, p) for q in pts if q is not p):
            out.append(p)
    # dedupe identical (perf, cost) pairs
    seen, uniq = set(), []
    for p in out:
        key = (p.perf, p.cost)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    return uniq


def pareto_front_min_min(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Pareto-optimal subset under the component (min-min) convention,
    deduplicated on (perf, cost) and sorted by ascending latency — the
    left-to-right order of a Fig. 4 component curve."""
    return sorted(_front(points, dominates_min_min), key=lambda p: (p.perf, p.cost))


def pareto_front_max_min(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Pareto-optimal subset under the system (max-min) convention,
    deduplicated on (perf, cost) and sorted by ascending throughput —
    the left-to-right order of the Fig. 10 system curve (costs ascend
    with it, or the point would be dominated)."""
    return sorted(_front(points, dominates_max_min), key=lambda p: (p.perf, p.cost))


def span(values: Iterable[float]) -> float:
    """max/min ratio over one metric (the paper's lambda_span /
    alpha_span, Section 1.3 / Table 1).

    Returns 1.0 for an empty set (a degenerate single-point space) and
    +inf when the minimum is non-positive — an infeasible latency/area
    should never reach here, so the inf flags the upstream bug instead
    of masking it.
    """
    vals = [v for v in values]
    if not vals:
        return 1.0
    lo, hi = min(vals), max(vals)
    if lo <= 0:
        return float("inf")
    return hi / lo


def check_delta_curve(points: Sequence[DesignPoint], delta: float) -> bool:
    """Problem 1 condition (i), on the max-min (system) front of
    ``points``: consecutive Pareto points d, d' (ascending theta) must
    satisfy max(d'_alpha/d_alpha - 1, d'_theta/d_theta - 1) < delta.

    Returns False for fronts containing non-positive coordinates (the
    ratios would be meaningless).  The tolerance term absorbs float
    error at the boundary gap == delta, which counts as satisfied.
    """
    front = pareto_front_max_min(points)
    for d, d2 in zip(front, front[1:]):
        if d.perf <= 0 or d.cost <= 0:
            return False
        gap = max(d2.cost / d.cost - 1.0, d2.perf / d.perf - 1.0)
        if gap >= delta + 1e-12:
            return False
    return True
