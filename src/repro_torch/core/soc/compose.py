"""SoC composition: replicas x Pareto points under global chip budgets.

The layer above one accelerator's DSE.  Each registered app brings its
system-level Pareto front (from
:class:`~repro_torch.core.session.ExplorationSession` — PLM-shared
fronts included, and on the ``cuda`` backend fronts timed on the
card); a :class:`~repro_torch.core.soc.workload.TrafficMix` says what
fraction of the request stream each app must serve; an
:class:`~repro_torch.core.soc.budget.SoCBudget` caps area, power, and
DRAM bandwidth chip-wide.  The :class:`SoCComposer` picks, per app, a
**replica count** and an **operating point** (one front point) to
maximize the *sustained mix throughput*

    T = min over apps of  (replicas_a * theta_a) / share_a

— the CHARM CDSE move (SNIPPETS.md: duplicated large/small accelerators
sized to the workload mix), applied to COSMOS fronts.

Two allocators, mirroring :mod:`repro_torch.core.analysis.packing`:

* :func:`greedy_composition` — the production path: start every app at
  its cheapest point with one replica (or raise
  :class:`BudgetInfeasibleError` *naming the violated budget*), then
  repeatedly give the bottleneck app the feasible move with the best
  marginal utility (delta-capacity per delta-area), with full
  deterministic tie-breaking;
* :func:`optimal_composition` — the exhaustive packer: enumerate every
  (point, replicas) assignment on small instances (guarded by
  ``max_apps`` / ``max_configs``, exponential past them) — the oracle
  the tests gate the greedy against.

Every composition is wrapped in ``soc.compose`` spans and counters
through :mod:`repro_torch.core.obs`, carries its budget + mix
provenance
(lint rule SOC001), and is independently re-proved by
:mod:`repro_torch.core.soc.verify`.  CLI::

    python -m repro_torch.core.soc.compose --mix wami=0.6,fleet=0.4 \\
        --budget sys_medium --tech 45 --out composition.json --verify
"""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import NULL_TRACER, MetricsRegistry
from ..pareto import DesignPoint
from .budget import SoCBudget, get_budget
from .workload import TrafficMix

__all__ = ["OperatingPoint", "Allocation", "Composition",
           "BudgetInfeasibleError", "operating_points",
           "greedy_composition", "optimal_composition", "SoCComposer",
           "main"]

#: deterministic order the three envelopes are checked in — the *first*
#: violated one names a :class:`BudgetInfeasibleError`
BUDGET_FIELDS = ("area_mm2", "power_w", "bw_gbps")

_REL_TOL = 1e-12
_MAX_APPS = 3                 # exhaustive guard, like packing.py
_MAX_CONFIGS = 200_000
_MAX_MOVES = 100_000          # greedy safety valve (never hit in practice)


class BudgetInfeasibleError(ValueError):
    """The mix cannot be served at all: even the minimal configuration
    (every app at its cheapest point, one replica) violates a budget.
    ``budget_field`` names the violated envelope."""

    def __init__(self, mix_name: str, budget: SoCBudget, budget_field: str,
                 need: float, limit: float):
        self.mix_name = mix_name
        self.budget_name = budget.name
        self.budget_field = budget_field
        self.need = need
        self.limit = limit
        super().__init__(
            f"traffic mix {mix_name!r} is infeasible under budget "
            f"{budget.name!r}: the minimal configuration (cheapest point, "
            f"one replica per app) needs {budget_field}={need:.6g} > "
            f"budget {limit:.6g}")


@dataclass(frozen=True)
class OperatingPoint:
    """One front point, priced against a budget's tech node.

    ``index`` is the point's position on the app's ascending-theta
    front; ``theta``/``cost`` are the front's native numbers; the three
    per-replica budget charges are derived through the demand's
    ``area_scale``/``bytes_per_request`` and the budget's tech tables.
    """

    index: int
    theta: float                  # requests/s one replica sustains
    cost: float                   # app-native front cost
    area_mm2: float               # at the budget's tech node
    power_w: float
    bw_gbps: float
    knobs: Tuple[Tuple[str, int], ...] = ()

    def to_json(self) -> Dict[str, Any]:
        return {"index": self.index, "theta": self.theta,
                "cost": self.cost, "area_mm2": self.area_mm2,
                "power_w": self.power_w, "bw_gbps": self.bw_gbps,
                "knobs": [list(k) for k in self.knobs]}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "OperatingPoint":
        return cls(index=doc["index"], theta=doc["theta"],
                   cost=doc["cost"], area_mm2=doc["area_mm2"],
                   power_w=doc["power_w"], bw_gbps=doc["bw_gbps"],
                   knobs=tuple((str(k), int(v))
                               for k, v in doc.get("knobs", [])))


def price_point(theta: float, cost: float, demand,
                budget: SoCBudget) -> Tuple[float, float, float]:
    """One replica's (area_mm2, power_w, bw_gbps) budget charge."""
    area_ref = cost * demand.area_scale
    return (budget.scale_area(area_ref), budget.power_of(area_ref),
            theta * demand.bytes_per_request / 1e9)


def operating_points(front: Sequence[DesignPoint], demand,
                     budget: SoCBudget) -> List[OperatingPoint]:
    """Price an app's front against a budget.  Points with non-positive
    throughput or area are unusable as replicas and are dropped."""
    out: List[OperatingPoint] = []
    for i, p in enumerate(front):
        area, power, bw = price_point(p.perf, p.cost, demand, budget)
        if p.perf <= 0 or area <= 0:
            continue
        out.append(OperatingPoint(index=i, theta=p.perf, cost=p.cost,
                                  area_mm2=area, power_w=power,
                                  bw_gbps=bw, knobs=tuple(p.knobs)))
    if not out:
        raise ValueError(f"app {demand.app!r}: no usable operating point "
                         f"on a front of {len(front)} point(s)")
    return out


@dataclass(frozen=True)
class Allocation:
    """One app's slice of the chip: ``replicas`` copies at ``point``."""

    app: str
    share: float                  # normalized share of the request mix
    replicas: int
    point: OperatingPoint

    @property
    def capacity(self) -> float:
        """Requests/s this allocation sustains (replicas x theta)."""
        return self.replicas * self.point.theta

    @property
    def area_mm2(self) -> float:
        return self.replicas * self.point.area_mm2

    @property
    def power_w(self) -> float:
        return self.replicas * self.point.power_w

    @property
    def bw_gbps(self) -> float:
        return self.replicas * self.point.bw_gbps

    def to_json(self) -> Dict[str, Any]:
        return {"app": self.app, "share": self.share,
                "replicas": self.replicas, "capacity": self.capacity,
                "area_mm2": self.area_mm2, "power_w": self.power_w,
                "bw_gbps": self.bw_gbps, "point": self.point.to_json()}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "Allocation":
        return cls(app=doc["app"], share=doc["share"],
                   replicas=doc["replicas"],
                   point=OperatingPoint.from_json(doc["point"]))


@dataclass(frozen=True)
class Composition:
    """One solved chip: allocations + totals + full provenance.

    ``to_json`` embeds the budget and the mix — the SOC001 lint rule
    and :mod:`repro_torch.core.soc.verify` both insist a committed
    artifact carries enough provenance to be independently re-priced.
    """

    budget: SoCBudget
    mix: TrafficMix
    allocations: Tuple[Allocation, ...]
    method: str                   # "greedy" | "exhaustive"
    sustained_throughput: float   # T, requests/s on the mix

    @property
    def area_mm2(self) -> float:
        return sum(a.area_mm2 for a in self.allocations)

    @property
    def power_w(self) -> float:
        return sum(a.power_w for a in self.allocations)

    @property
    def bw_gbps(self) -> float:
        return sum(a.bw_gbps for a in self.allocations)

    @property
    def throughput_per_area(self) -> float:
        """Sustained requests/s per mm^2 of the composition."""
        return self.sustained_throughput / self.area_mm2

    def to_json(self) -> Dict[str, Any]:
        return {"version": 1,
                "budget": self.budget.to_json(),
                "mix": self.mix.to_json(),
                "method": self.method,
                "sustained_throughput": self.sustained_throughput,
                "throughput_per_area": self.throughput_per_area,
                "totals": {"area_mm2": self.area_mm2,
                           "power_w": self.power_w,
                           "bw_gbps": self.bw_gbps},
                "allocations": [a.to_json() for a in self.allocations]}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "Composition":
        return cls(budget=SoCBudget.from_json(doc["budget"]),
                   mix=TrafficMix.from_json(doc["mix"]),
                   allocations=tuple(Allocation.from_json(a)
                                     for a in doc["allocations"]),
                   method=doc["method"],
                   sustained_throughput=doc["sustained_throughput"])


# ----------------------------------------------------------------------
# shared machinery
# ----------------------------------------------------------------------
def _priced(budget: SoCBudget, mix: TrafficMix,
            fronts: Dict[str, Sequence[DesignPoint]]
            ) -> Dict[str, List[OperatingPoint]]:
    missing = sorted(d.app for d in mix.demands if d.app not in fronts)
    if missing:
        raise KeyError(f"mix {mix.name!r}: no front supplied for "
                       f"{missing}; fronts cover {sorted(fronts)}")
    return {d.app: operating_points(fronts[d.app], d, budget)
            for d in mix.demands}


def _totals(state: Dict[str, Tuple[int, int]],
            pts: Dict[str, List[OperatingPoint]]
            ) -> Tuple[float, float, float]:
    area = power = bw = 0.0
    for app, (idx, reps) in state.items():
        p = pts[app][idx]
        area += reps * p.area_mm2
        power += reps * p.power_w
        bw += reps * p.bw_gbps
    return area, power, bw


def _fits(budget: SoCBudget, totals: Tuple[float, float, float]) -> bool:
    limits = (budget.area_mm2, budget.power_w, budget.bw_gbps)
    return all(t <= lim * (1 + _REL_TOL)
               for t, lim in zip(totals, limits))


def _min_state(pts: Dict[str, List[OperatingPoint]]
               ) -> Dict[str, Tuple[int, int]]:
    """Every app at its cheapest-area point, one replica — the minimal
    configuration the infeasibility check (and greedy) starts from."""
    state: Dict[str, Tuple[int, int]] = {}
    for app in sorted(pts):
        best = min(range(len(pts[app])),
                   key=lambda i: (pts[app][i].area_mm2, i))
        state[app] = (best, 1)
    return state


def _check_feasible_start(budget: SoCBudget, mix: TrafficMix,
                          pts: Dict[str, List[OperatingPoint]]
                          ) -> Dict[str, Tuple[int, int]]:
    state = _min_state(pts)
    totals = _totals(state, pts)
    limits = (budget.area_mm2, budget.power_w, budget.bw_gbps)
    for field_, need, limit in zip(BUDGET_FIELDS, totals, limits):
        if need > limit * (1 + _REL_TOL):
            raise BudgetInfeasibleError(mix.name, budget, field_,
                                        need, limit)
    return state


def _sustained(state: Dict[str, Tuple[int, int]],
               pts: Dict[str, List[OperatingPoint]],
               shares: Dict[str, float]) -> float:
    return min(reps * pts[app][idx].theta / shares[app]
               for app, (idx, reps) in state.items())


def _finish(budget: SoCBudget, mix: TrafficMix,
            pts: Dict[str, List[OperatingPoint]],
            state: Dict[str, Tuple[int, int]], method: str
            ) -> Composition:
    shares = mix.shares()
    allocations = tuple(
        Allocation(app=app, share=shares[app], replicas=state[app][1],
                   point=pts[app][state[app][0]])
        for app in sorted(state))
    return Composition(budget=budget, mix=mix, allocations=allocations,
                       method=method,
                       sustained_throughput=_sustained(state, pts, shares))


# ----------------------------------------------------------------------
# the greedy / marginal-utility allocator
# ----------------------------------------------------------------------
def greedy_composition(budget: SoCBudget, mix: TrafficMix,
                       fronts: Dict[str, Sequence[DesignPoint]], *,
                       tracer=None, metrics: Optional[MetricsRegistry] = None
                       ) -> Composition:
    """Deterministic marginal-utility allocation.

    Start from the minimal configuration (raising
    :class:`BudgetInfeasibleError` if even that violates a budget),
    then loop: find the bottleneck app (lowest capacity/share, ties by
    name) and apply its best feasible capacity-increasing move — switch
    operating point and/or add a replica — ranked by marginal utility
    (delta-capacity / delta-area), ties by smaller delta-area, smaller
    delta-power, then (point index, replicas).  Between moves, any app
    that can *repack* (same-or-higher capacity, strictly less area, no
    more replicas) does, freeing budget for the bottleneck.  Both step
    kinds strictly increase (total capacity, -total area), so the walk
    terminates; the final state is the sustained-throughput local
    optimum the exhaustive packer gates in tests.
    """
    tracer = tracer if tracer is not None else NULL_TRACER
    metrics = metrics if metrics is not None else MetricsRegistry()
    moves_c = metrics.counter("soc.moves")
    pts = _priced(budget, mix, fronts)
    shares = mix.shares()
    with tracer.span("soc.allocate", mix=mix.name, budget=budget.name,
                     method="greedy") as sp:
        state = _check_feasible_start(budget, mix, pts)
        moves = 0
        while moves < _MAX_MOVES:
            if _repack(budget, pts, state, shares):
                moves += 1
                moves_c.inc()
                continue
            bottleneck = min(
                state, key=lambda a: (state[a][1] * pts[a][state[a][0]].theta
                                      / shares[a], a))
            move = _best_move(budget, pts, state, bottleneck)
            if move is None:
                break
            tracer.instant("soc.move", app=bottleneck,
                           point=move[0], replicas=move[1])
            state[bottleneck] = move
            moves += 1
            moves_c.inc()
        sp.set("moves", moves)
        sp.set("sustained_throughput", _sustained(state, pts, shares))
    return _finish(budget, mix, pts, state, "greedy")


def _candidates(reps: int, n_points: int):
    for idx2 in range(n_points):
        for reps2 in sorted({1, reps, reps + 1}):
            yield idx2, reps2


def _best_move(budget: SoCBudget, pts: Dict[str, List[OperatingPoint]],
               state: Dict[str, Tuple[int, int]], app: str
               ) -> Optional[Tuple[int, int]]:
    """The bottleneck's best feasible capacity-increasing move, or
    None.  Candidates: every point at 1, current, or current+1
    replicas (covering add-a-replica, switch-point, and
    collapse-to-one-bigger)."""
    idx, reps = state[app]
    cur = pts[app][idx]
    cap = reps * cur.theta
    area0, power0, bw0 = _totals(state, pts)
    best_key = None
    best = None
    for idx2, reps2 in _candidates(reps, len(pts[app])):
        if (idx2, reps2) == (idx, reps):
            continue
        p2 = pts[app][idx2]
        cap2 = reps2 * p2.theta
        if cap2 <= cap * (1 + _REL_TOL):
            continue
        d_area = reps2 * p2.area_mm2 - reps * cur.area_mm2
        d_power = reps2 * p2.power_w - reps * cur.power_w
        d_bw = reps2 * p2.bw_gbps - reps * cur.bw_gbps
        if not _fits(budget, (area0 + d_area, power0 + d_power,
                              bw0 + d_bw)):
            continue
        utility = (cap2 - cap) / max(d_area, 1e-9)
        key = (-utility, d_area, d_power, idx2, reps2)
        if best_key is None or key < best_key:
            best_key, best = key, (idx2, reps2)
    return best


def _repack(budget: SoCBudget, pts: Dict[str, List[OperatingPoint]],
            state: Dict[str, Tuple[int, int]],
            shares: Dict[str, float]) -> bool:
    """Apply the first available area-freeing repack: a config with
    same-or-higher capacity, strictly less area, and no more replicas.
    Returns True if a repack was applied."""
    for app in sorted(state):
        idx, reps = state[app]
        cur = pts[app][idx]
        cap = reps * cur.theta
        area = reps * cur.area_mm2
        best_key = None
        best = None
        for idx2, reps2 in _candidates(reps, len(pts[app])):
            if (idx2, reps2) == (idx, reps) or reps2 > reps:
                continue
            p2 = pts[app][idx2]
            if reps2 * p2.theta < cap * (1 - _REL_TOL):
                continue
            area2 = reps2 * p2.area_mm2
            if area2 >= area * (1 - _REL_TOL):
                continue
            key = (area2, reps2 * p2.power_w, idx2, reps2)
            if best_key is None or key < best_key:
                best_key, best = key, (idx2, reps2)
        if best is not None:
            state[app] = best
            return True
    return False


# ----------------------------------------------------------------------
# the exhaustive packer (small instances — the gate oracle)
# ----------------------------------------------------------------------
def optimal_composition(budget: SoCBudget, mix: TrafficMix,
                        fronts: Dict[str, Sequence[DesignPoint]], *,
                        max_apps: int = _MAX_APPS,
                        max_configs: int = _MAX_CONFIGS) -> Composition:
    """The certified optimum by full enumeration.

    Every per-app (point, replicas) config within the individual
    budget caps, crossed over apps; exponential, so guarded by
    ``max_apps`` and ``max_configs`` (:class:`ValueError` past either —
    mirroring :func:`repro_torch.core.analysis.packing.optimal_plan`).
    Deterministic ties: max sustained throughput, then min area, then
    min power, then lexicographic (point index, replicas) per sorted
    app.  The oracle the greedy is gated against.
    """
    import itertools
    if len(mix.demands) > max_apps:
        raise ValueError(f"exhaustive composition is exponential: "
                         f"{len(mix.demands)} apps > max_apps={max_apps}")
    pts = _priced(budget, mix, fronts)
    shares = mix.shares()
    _check_feasible_start(budget, mix, pts)

    apps = sorted(pts)
    per_app: List[List[Tuple[int, int]]] = []
    total = 1
    for app in apps:
        configs: List[Tuple[int, int]] = []
        for i, p in enumerate(pts[app]):
            caps = [budget.area_mm2 / p.area_mm2,
                    budget.power_w / p.power_w if p.power_w > 0
                    else math.inf,
                    budget.bw_gbps / p.bw_gbps if p.bw_gbps > 0
                    else math.inf]
            rmax = int(min(caps) * (1 + _REL_TOL))
            configs.extend((i, r) for r in range(1, rmax + 1))
        per_app.append(configs)
        total *= max(1, len(configs))
    if total > max_configs:
        raise ValueError(f"exhaustive composition too large: {total} "
                         f"configs > max_configs={max_configs}")

    best_key = None
    best_state = None
    for combo in itertools.product(*per_app):
        state = dict(zip(apps, combo))
        if not _fits(budget, _totals(state, pts)):
            continue
        t = _sustained(state, pts, shares)
        area, power, _ = _totals(state, pts)
        key = (-t, area, power, combo)
        if best_key is None or key < best_key:
            best_key, best_state = key, state
    assert best_state is not None     # min config is feasible by check
    return _finish(budget, mix, pts, best_state, "exhaustive")


# ----------------------------------------------------------------------
# the composer: registry-resolved fronts + obs wiring
# ----------------------------------------------------------------------
class SoCComposer:
    """Front resolution + allocation, end to end.

    Resolves each demand's Pareto front through the package's registry
    (``build_session(app, backend, share_plm=..., delta=...)``; on the
    ``cuda`` backend that times the app's kernels on the card) unless
    pre-computed ``fronts`` are injected; prices, allocates, and
    returns a :class:`Composition`.  All work is traced (``soc.compose``
    > ``soc.front`` / ``soc.allocate`` spans) and counted
    (``soc.compositions``, ``soc.moves``, the
    ``soc.sustained_throughput`` gauge) through
    :mod:`repro_torch.core.obs`.
    """

    def __init__(self, budget: SoCBudget, mix: TrafficMix, *,
                 fronts: Optional[Dict[str, Sequence[DesignPoint]]] = None,
                 workers: int = 4, tracer=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.budget = budget
        self.mix = mix
        self.workers = workers
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._fronts: Optional[Dict[str, List[DesignPoint]]] = (
            {k: list(v) for k, v in fronts.items()}
            if fronts is not None else None)

    def fronts(self) -> Dict[str, List[DesignPoint]]:
        """Each demand's system-level Pareto front, memoized.  One
        exploration session per app, in demand order."""
        if self._fronts is None:
            from ..registry import build_session
            out: Dict[str, List[DesignPoint]] = {}
            for d in self.mix.demands:
                with self.tracer.span("soc.front", app=d.app,
                                      backend=d.backend,
                                      share_plm=d.share_plm) as sp:
                    session = build_session(
                        d.app, d.backend, share_plm=d.share_plm,
                        delta=d.delta, workers=self.workers)
                    out[d.app] = session.run().pareto()
                    sp.set("points", len(out[d.app]))
            self._fronts = out
        return self._fronts

    def compose(self, method: str = "greedy") -> Composition:
        """Solve the chip.  ``method``: ``"greedy"`` (production) or
        ``"exhaustive"`` (the small-instance packer)."""
        if method not in ("greedy", "exhaustive"):
            raise ValueError(f"unknown method {method!r}; "
                             f"methods: ['exhaustive', 'greedy']")
        with self.tracer.span("soc.compose", mix=self.mix.name,
                              budget=self.budget.name,
                              tech_nm=self.budget.tech_nm,
                              method=method) as sp:
            fronts = self.fronts()
            fn = (greedy_composition if method == "greedy"
                  else optimal_composition)
            comp = fn(self.budget, self.mix, fronts,
                      **({"tracer": self.tracer, "metrics": self.metrics}
                         if method == "greedy" else {}))
            self.metrics.counter("soc.compositions").inc()
            self.metrics.gauge("soc.sustained_throughput").set(
                comp.sustained_throughput)
            sp.set("sustained_throughput", comp.sustained_throughput)
            sp.set("area_mm2", comp.area_mm2)
        return comp


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------
def _render(comp: Composition) -> str:
    b = comp.budget
    lines = [f"composition: mix={comp.mix.name} budget={b.name} "
             f"tech={b.tech_nm}nm method={comp.method}",
             "app,share,point,replicas,theta_per_replica,capacity,"
             "area_mm2,power_w,bw_gbps"]
    for a in comp.allocations:
        lines.append(f"{a.app},{a.share:.4f},{a.point.index},"
                     f"{a.replicas},{a.point.theta:.6g},"
                     f"{a.capacity:.6g},{a.area_mm2:.6g},"
                     f"{a.power_w:.6g},{a.bw_gbps:.6g}")
    lines.append(f"sustained_throughput={comp.sustained_throughput:.6g} "
                 f"req/s on the mix")
    lines.append(f"totals: area {comp.area_mm2:.6g}/{b.area_mm2:g} mm2, "
                 f"power {comp.power_w:.6g}/{b.power_w:g} W, "
                 f"bw {comp.bw_gbps:.6g}/{b.bw_gbps:g} GB/s")
    lines.append(f"throughput_per_area={comp.throughput_per_area:.6g} "
                 f"req/s/mm2")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.soc.compose",
        description="compose registered apps onto one SoC under global "
                    "area/power/bandwidth budgets")
    ap.add_argument("--mix", default="wami=0.6,fleet=0.4",
                    metavar="APP=SHARE,...",
                    help="the traffic mix (default wami=0.6,fleet=0.4)")
    ap.add_argument("--budget", default="sys_medium",
                    help="budget preset (sys_small/sys_medium/sys_large)")
    ap.add_argument("--area", type=float, default=None,
                    help="custom area envelope, mm^2 (overrides preset)")
    ap.add_argument("--power", type=float, default=None,
                    help="custom power envelope, W")
    ap.add_argument("--bw", type=float, default=None,
                    help="custom bandwidth envelope, GB/s")
    ap.add_argument("--tech", type=int, default=None, metavar="NM",
                    help="re-anchor the budget at this tech node "
                         "(45/32/22/16)")
    ap.add_argument("--method", choices=["greedy", "exhaustive"],
                    default="greedy")
    ap.add_argument("--workers", type=int, default=4,
                    help="session fan-out while resolving fronts")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the composition JSON artifact here")
    ap.add_argument("--verify", action="store_true",
                    help="independently re-prove the composition "
                         "(repro_torch.core.soc.verify) before reporting")
    args = ap.parse_args(argv)

    try:
        budget = get_budget(args.budget)
        if args.area or args.power or args.bw:
            from dataclasses import replace
            budget = replace(
                budget, name=f"{args.budget}-custom",
                area_mm2=args.area or budget.area_mm2,
                power_w=args.power or budget.power_w,
                bw_gbps=args.bw or budget.bw_gbps)
        if args.tech is not None:
            budget = budget.at_tech(args.tech)
        mix = TrafficMix.parse(args.mix)
        mix.resolve()                 # registry listing errors on typos
        composer = SoCComposer(budget, mix, workers=args.workers)
        comp = composer.compose(args.method)
        if args.verify:
            from .verify import assert_composition_sound
            assert_composition_sound(comp, fronts=composer.fronts())
    except (BudgetInfeasibleError, KeyError, ValueError,
            AssertionError) as e:
        print(f"soc-compose: FAIL — {e}", file=sys.stderr)
        return 1
    print(_render(comp))
    if args.verify:
        print("verify: composition independently re-proved feasible")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(comp.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
