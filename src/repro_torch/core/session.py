"""ExplorationSession: the batched COSMOS drive.

The methodology as an object with explicit phases —

    session.characterize()   # Algorithm 1, ALL components concurrently
    session.plan()           # Eq. (2) LP sweep over the TMG
    session.map()            # phi mapping, ALL plan points concurrently
    session.result()         # -> CosmosResult

— each phase batching every independent oracle invocation through the
:class:`~repro_torch.core.oracle.OracleLedger`.  Because the ledger
de-duplicates identical knob points in flight and every backend is pure,
a batched drive produces *byte-identical* fronts and invocation counts
to the sequential one; only the wall clock changes.  Sessions emit
:class:`ProgressEvent`s.

``cosmos_dse`` in :mod:`repro_torch.core.dse` is a thin wrapper over
this class.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .characterize import CharacterizationResult, characterize_component
from .knobs import KnobSpace
from .mapping import MapOutcome, map_target
from .oracle import OracleCache, OracleLedger
from .pareto import DesignPoint, pareto_front_max_min
from .planning import ComponentModel, PlanPoint, Schedule, sweep, theta_bounds
from .tmg import TMG

__all__ = ["SystemPoint", "CosmosResult", "ProgressEvent",
           "ExplorationSession"]


@dataclass(frozen=True)
class SystemPoint:
    """A mapped system implementation (one point of Fig. 10).

    ``cost_actual`` is the paper's per-component cost sum.
    ``cost_unshared``, ``plm_groups`` and ``memory_plan`` are the fields
    a system-level PLM planner fills; this package has no planner yet,
    so they keep their empty defaults (and the point's ``repr`` stays
    field-for-field comparable with a planner-capable drive).
    """

    theta_planned: float
    cost_planned: float
    theta_actual: float
    cost_actual: float
    outcomes: Tuple[MapOutcome, ...]
    cost_unshared: Optional[float] = None
    plm_groups: Tuple[Tuple[str, ...], ...] = ()
    memory_plan: Optional[Any] = None
    schedule: Optional[Schedule] = None

    @property
    def sigma_mismatch(self) -> float:
        """sigma(d_p, d_m) = |d_m - d_p| / d_p  (Section 7.3)."""
        if self.cost_planned <= 0:
            return float("inf")
        return abs(self.cost_actual - self.cost_planned) / self.cost_planned

    def as_design_point(self) -> DesignPoint:
        return DesignPoint(perf=self.theta_actual, cost=self.cost_actual)


@dataclass
class CosmosResult:
    characterizations: Dict[str, CharacterizationResult]
    planned: List[PlanPoint]
    mapped: List[SystemPoint]
    invocations: Dict[str, int]         # total per component (char + map)
    theta_min: float
    theta_max: float

    @property
    def total_invocations(self) -> int:
        return sum(self.invocations.values())

    def pareto(self) -> List[DesignPoint]:
        return pareto_front_max_min([m.as_design_point() for m in self.mapped])


@dataclass(frozen=True)
class ProgressEvent:
    """One progress tick: ``done``/``total`` work units within ``phase``."""

    phase: str                   # "characterize" | "plan" | "map"
    label: str                   # component name / plan-point label
    done: int
    total: int


# ----------------------------------------------------------------------
# The session
# ----------------------------------------------------------------------
class ExplorationSession:
    """One COSMOS exploration of a system TMG over a synthesis oracle.

    ``tool`` is any oracle backend (``HLSTool``, ``CudaOracle``, or
    anything matching the ``SynthesisTool``/``Oracle`` protocols); it is
    wrapped in an :class:`OracleLedger` unless a ledger is passed
    directly.  ``workers`` bounds the per-phase fan-out (1 is the
    sequential drive, call for call).  ``fixed`` maps software
    components (Matrix-Inv in Fig. 8) to their fixed effective latency —
    they join the TMG but are never synthesized.
    """

    def __init__(self, tmg: TMG, tool, spaces: Dict[str, KnobSpace], *,
                 delta: float = 0.25,
                 fixed: Optional[Dict[str, float]] = None,
                 ledger: Optional[OracleLedger] = None,
                 cache: Optional[OracleCache] = None,
                 workers: int = 1,
                 on_event: Optional[Callable[[ProgressEvent], None]] = None):
        self.tmg = tmg
        self.spaces = dict(spaces)
        self.delta = float(delta)
        self.fixed = dict(fixed or {})
        self.workers = max(1, int(workers))
        self.on_event = on_event
        if ledger is not None:
            if cache is not None:
                raise ValueError("pass `cache` to the ledger's constructor "
                                 "when supplying a pre-built ledger — a "
                                 "session-level cache would be silently "
                                 "ignored otherwise")
            self.ledger = ledger
        else:
            self.ledger = OracleLedger(tool, cache=cache,
                                       workers=self.workers)
        self._progress_lock = threading.Lock()
        # phase outputs (None = phase not run yet)
        self.characterizations: Optional[Dict[str, CharacterizationResult]] = None
        self.models: Optional[Dict[str, ComponentModel]] = None
        self.planned: Optional[List[PlanPoint]] = None
        self.mapped: Optional[List[SystemPoint]] = None
        self.theta_min: float = 0.0
        self.theta_max: float = 0.0

    # -- plumbing ------------------------------------------------------
    def _emit(self, phase: str, label: str, done: int, total: int) -> None:
        if self.on_event is not None:
            self.on_event(ProgressEvent(phase=phase, label=label,
                                        done=done, total=total))

    def _pool_map(self, fn, items: Sequence) -> List:
        """Run ``fn`` over ``items`` preserving order; fan out when the
        session has workers to spare."""
        if self.workers <= 1 or len(items) <= 1:
            return [fn(it) for it in items]
        with ThreadPoolExecutor(max_workers=min(self.workers,
                                                len(items))) as pool:
            return list(pool.map(fn, items))

    def _names(self) -> List[str]:
        return [t.name for t in self.tmg.transitions]

    # -- phase 1: characterization (Algorithm 1) -----------------------
    def characterize(self) -> Dict[str, CharacterizationResult]:
        """Characterize every non-fixed component; all components run
        concurrently (each component's corner walk stays sequential —
        Algorithm 1 is adaptive within a component)."""
        if self.characterizations is not None:
            self._build_models()
            return self.characterizations
        self.ledger.phase = "characterize"
        work = [n for n in self._names() if n not in self.fixed]
        self._emit("characterize", "", 0, len(work))
        done = [0]

        def one(name: str) -> CharacterizationResult:
            res = characterize_component(self.ledger, name,
                                         self.spaces[name])
            with self._progress_lock:
                done[0] += 1
                n_done = done[0]
            self._emit("characterize", name, n_done, len(work))
            return res

        results = self._pool_map(one, work)
        self.characterizations = dict(zip(work, results))
        self._build_models()
        return self.characterizations

    def _build_models(self) -> None:
        assert self.characterizations is not None
        models: Dict[str, ComponentModel] = {}
        for name in self._names():
            if name in self.fixed:
                models[name] = ComponentModel.fixed_latency(name,
                                                            self.fixed[name])
            else:
                models[name] = ComponentModel.from_regions(
                    name, self.characterizations[name].regions)
        self.models = models

    # -- phase 2: synthesis planning (Eq. 2 sweep) ---------------------
    def plan(self) -> List[PlanPoint]:
        if self.planned is not None:
            return self.planned
        if self.models is None:
            self.characterize()
        self.ledger.phase = "plan"
        self._emit("plan", "", 0, 1)
        self.theta_min, self.theta_max = theta_bounds(self.tmg, self.models)
        self.planned = sweep(self.tmg, self.models, self.delta)
        self._emit("plan", f"{len(self.planned)} points", 1, 1)
        return self.planned

    # -- phase 3: synthesis mapping (phi) ------------------------------
    def map(self) -> List[SystemPoint]:
        if self.mapped is not None:
            return self.mapped
        if self.planned is None:
            self.plan()
        self.ledger.phase = "map"
        planned = self.planned
        self._emit("map", "", 0, len(planned))
        done = [0]

        def one(plan_pt: PlanPoint) -> SystemPoint:
            outcomes: List[MapOutcome] = []
            lam_actual: Dict[str, float] = {}
            cost = 0.0
            for name in self._names():
                if name in self.fixed:
                    lam_actual[name] = self.fixed[name]
                    continue
                out = map_target(self.ledger, name,
                                 self.characterizations[name].regions,
                                 plan_pt.lam_targets[name])
                outcomes.append(out)
                lam_actual[name] = out.synthesis.lam
                cost += out.synthesis.area
            theta_actual = self.tmg.throughput(lam_actual)
            with self._progress_lock:
                done[0] += 1
                n_done = done[0]
            self._emit("map", f"theta={plan_pt.theta:.3g}", n_done,
                       len(planned))
            return SystemPoint(theta_planned=plan_pt.theta,
                               cost_planned=plan_pt.cost,
                               theta_actual=theta_actual,
                               cost_actual=cost,
                               outcomes=tuple(outcomes),
                               schedule=plan_pt.schedule)

        self.mapped = self._pool_map(one, planned)
        return self.mapped

    # -- results -------------------------------------------------------
    def run(self) -> CosmosResult:
        self.map()           # pulls characterize() and plan() as needed
        self.ledger.flush()
        return self.result()

    def result(self) -> CosmosResult:
        if self.mapped is None:
            raise RuntimeError("session has not completed the map phase")
        # normalize invocation-dict ordering to the TMG transition order
        # (under a concurrent drive dict insertion order is racy otherwise)
        inv: Dict[str, int] = {}
        for name in self._names():
            if name in self.ledger.invocations:
                inv[name] = self.ledger.invocations[name]
        for name, n in self.ledger.invocations.items():
            inv.setdefault(name, n)
        return CosmosResult(characterizations=dict(self.characterizations),
                            planned=list(self.planned),
                            mapped=list(self.mapped),
                            invocations=inv,
                            theta_min=self.theta_min,
                            theta_max=self.theta_max)
