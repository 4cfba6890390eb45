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

__all__ = ["SystemPoint", "CosmosResult", "ProgressEvent", "DSEQuery",
           "ExplorationSession"]


@dataclass(frozen=True)
class SystemPoint:
    """A mapped system implementation (one point of Fig. 10).

    When the session carries a PLM planner, ``cost_actual`` is the
    planned shared-memory system cost, ``cost_unshared`` keeps the
    paper's naive per-component sum for comparison, ``plm_groups``
    records the shared-bank grouping (members of singleton groups are
    omitted), and ``memory_plan`` is the full emitted plan.  Without a
    planner ``cost_unshared`` is None and ``cost_actual`` is the naive
    sum.
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
class DSEQuery:
    """One DSE request, as data: the session-as-query entry point.

    Everything :func:`~repro_torch.core.registry.build_session` resolves
    — app, backend, budget (``delta``), PLM sharing, tile axes,
    fan-out.  Hashable, so a query can key caches.
    """

    app: str
    backend: str = "analytical"
    delta: Optional[float] = None
    share_plm: bool = False
    tile_sizes: Optional[Tuple[int, ...]] = None
    tiles: Optional[Tuple[int, ...]] = None
    workers: int = 1

    def __post_init__(self):
        # tolerate list inputs (queries arrive from JSON-ish callers)
        for name in ("tile_sizes", "tiles"):
            val = getattr(self, name)
            if val is not None and not isinstance(val, tuple):
                object.__setattr__(self, name, tuple(val))


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
    ``memory_planner`` (a :class:`~repro_torch.core.plm.planner.PLMPlanner`)
    replaces the map phase's naive per-component cost sum with the
    planned shared-PLM system cost; the naive sum is kept on every
    :class:`SystemPoint` as ``cost_unshared``.  Each plan point's solved
    LP schedule is handed to the planner (when its ``plan_point``
    accepts one), opening the schedule-conditional certificate tier.
    ``verify_plans=True`` adds a strict post-pass: every emitted memory
    plan is independently re-proved race-free by
    :mod:`repro_torch.core.analysis.verify`, and the session raises
    :class:`~repro_torch.core.analysis.verify.PlanVerificationError` on
    the first violation instead of returning an unsound point.
    """

    def __init__(self, tmg: TMG, tool, spaces: Dict[str, KnobSpace], *,
                 delta: float = 0.25,
                 fixed: Optional[Dict[str, float]] = None,
                 ledger: Optional[OracleLedger] = None,
                 cache: Optional[OracleCache] = None,
                 workers: int = 1,
                 memory_planner=None,
                 verify_plans: bool = False,
                 on_event: Optional[Callable[[ProgressEvent], None]] = None):
        self.tmg = tmg
        self.spaces = dict(spaces)
        self.delta = float(delta)
        self.fixed = dict(fixed or {})
        self.workers = max(1, int(workers))
        self.memory_planner = memory_planner
        self.verify_plans = bool(verify_plans)
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
            cost_naive = 0.0
            for name in self._names():
                if name in self.fixed:
                    lam_actual[name] = self.fixed[name]
                    continue
                out = map_target(self.ledger, name,
                                 self.characterizations[name].regions,
                                 plan_pt.lam_targets[name])
                outcomes.append(out)
                lam_actual[name] = out.synthesis.lam
                cost_naive += out.synthesis.area
            theta_actual = self.tmg.throughput(lam_actual)
            cost_actual, cost_unshared, groups = cost_naive, None, ()
            mem = None
            if self.memory_planner is not None:
                mem = self._plan_memory(plan_pt, outcomes)
                cost_actual = mem.system_cost
                cost_unshared = cost_naive
                groups = tuple(g.members for g in mem.groups
                               if len(g.members) > 1)
            with self._progress_lock:
                done[0] += 1
                n_done = done[0]
            self._emit("map", f"theta={plan_pt.theta:.3g}", n_done,
                       len(planned))
            return SystemPoint(theta_planned=plan_pt.theta,
                               cost_planned=plan_pt.cost,
                               theta_actual=theta_actual,
                               cost_actual=cost_actual,
                               outcomes=tuple(outcomes),
                               cost_unshared=cost_unshared,
                               plm_groups=groups,
                               memory_plan=mem,
                               schedule=plan_pt.schedule)

        self.mapped = self._pool_map(one, planned)
        return self.mapped

    def _plan_memory(self, plan_pt: PlanPoint,
                     outcomes: Sequence[MapOutcome]):
        """Run the memory planner for one mapped point, handing it the
        plan point's LP schedule when the planner can take one, and —
        under ``verify_plans`` — re-proving the emitted plan sound."""
        import inspect
        synths = {o.component: o.synthesis for o in outcomes}
        planner = self.memory_planner
        params = inspect.signature(planner.plan_point).parameters
        kwargs: Dict[str, Any] = {}
        if "schedule" in params:
            kwargs["schedule"] = plan_pt.schedule
        # pre-schedule custom planners get no keyword
        mem = planner.plan_point(self.ledger, synths, **kwargs)
        if self.verify_plans:
            from .analysis.verify import assert_plan_sound
            assert_plan_sound(mem, self.tmg, plan_pt.schedule)
        return mem

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

    # -- session-as-query ----------------------------------------------
    @classmethod
    def from_query(cls, query: DSEQuery, **kwargs) -> "ExplorationSession":
        """Resolve a :class:`DSEQuery` through the App/Backend registry.
        Keywords (``ledger``, ``tool``, ``verify_plans``, ...) flow to
        :func:`~repro_torch.core.registry.build_query_session`."""
        from .registry import build_query_session   # lazy: registry imports us
        return build_query_session(query, **kwargs)
