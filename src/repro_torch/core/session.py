"""ExplorationSession: the batched, resumable COSMOS drive.

The methodology as an object with explicit phases —

    session.characterize()   # Algorithm 1, ALL components concurrently
    session.plan()           # Eq. (2) LP sweep over the TMG
    session.map()            # phi mapping, ALL plan points concurrently
    session.result()         # -> CosmosResult (unchanged surface)

— each phase batching every independent oracle invocation through the
:class:`~repro_torch.core.oracle.OracleLedger`.  Because the ledger
de-duplicates identical knob points in flight and every backend is pure,
a batched drive produces *byte-identical* fronts and invocation counts
to the sequential one; only the wall clock changes.

Sessions also emit :class:`ProgressEvent`s and serialize/restore
mid-run: completed phases are checkpointed through
:mod:`repro_torch.checkpoint.store` and a restored session continues
from the first unfinished phase (pair with a
:class:`~repro_torch.core.oracle.PersistentOracleCache` to also skip the
already-paid tool invocations).

``cosmos_dse`` in :mod:`repro_torch.core.dse` is a thin wrapper over
this class.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple)

from .characterize import CharacterizationResult, characterize_component
from .knobs import CDFGFacts, KnobSpace, Region
from .mapping import MapOutcome, map_target
from .surrogate import RidgeSurrogate, guided_characterize_component
from .obs import NULL_TRACER
from .oracle import (OracleCache, OracleLedger, _synth_from_json,
                     _synth_to_json)
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
class ProgressEvent:
    """One progress tick: ``done``/``total`` work units within ``phase``."""

    phase: str                   # "characterize" | "plan" | "map"
    label: str                   # component name / plan-point label
    done: int
    total: int


@dataclass(frozen=True)
class DSEQuery:
    """One DSE request, as data: the session-as-query entry point.

    Everything :func:`~repro_torch.core.registry.build_session`
    resolves — app, backend, budget (``delta``), PLM sharing, tile axes,
    fan-out — plus the ``tenant`` label the service uses for
    attribution.  Hashable, so a
    query can key caches and coalescing pools.

    ``pool_key`` names the oracle pool the query may share with other
    tenants: everything that changes what the *tool* answers for a knob
    key.  ``share_plm`` is part of it because the measured backends
    price unrecorded points through a different (unit-calibrated)
    fallback under ``share_plm``; ``delta``/``tile_sizes``/``workers``
    are not, because they only change which points a session asks for,
    never a point's price.
    """

    app: str
    backend: str = "analytical"
    delta: Optional[float] = None
    share_plm: bool = False
    tile_sizes: Optional[Tuple[int, ...]] = None
    tiles: Optional[Tuple[int, ...]] = None
    workers: int = 1
    tenant: str = ""

    def __post_init__(self):
        # tolerate list inputs (queries arrive from JSON-ish callers)
        for name in ("tile_sizes", "tiles"):
            val = getattr(self, name)
            if val is not None and not isinstance(val, tuple):
                object.__setattr__(self, name, tuple(val))

    @property
    def pool_key(self) -> Tuple[str, str, bool, Tuple[int, ...]]:
        return (self.app, self.backend, self.share_plm, self.tiles or ())


# ----------------------------------------------------------------------
# JSON codecs for mid-run serialization
# ----------------------------------------------------------------------
def _facts_to_json(f: Optional[CDFGFacts]) -> Optional[Dict[str, Any]]:
    if f is None:
        return None
    return {"gamma_r": f.gamma_r, "gamma_w": f.gamma_w, "eta": f.eta,
            "trip": f.trip, "has_plm_access": f.has_plm_access}


def _facts_from_json(d: Optional[Dict[str, Any]]) -> Optional[CDFGFacts]:
    if d is None:
        return None
    return CDFGFacts(**d)


def _region_to_json(r: Region) -> Dict[str, Any]:
    return {"ports": r.ports, "lam_max": r.lam_max, "area_min": r.area_min,
            "lam_min": r.lam_min, "area_max": r.area_max, "mu_min": r.mu_min,
            "mu_max": r.mu_max, "facts": _facts_to_json(r.facts),
            "tile": r.tile}


def _region_from_json(d: Dict[str, Any]) -> Region:
    d = dict(d)
    d["facts"] = _facts_from_json(d["facts"])
    d.setdefault("tile", 0)       # pre-tile session snapshots
    return Region(**d)


def _dp_to_json(p: DesignPoint) -> Dict[str, Any]:
    return {"perf": p.perf, "cost": p.cost,
            "knobs": [list(kv) for kv in p.knobs],
            "meta": [list(kv) for kv in p.meta]}


def _dp_from_json(d: Dict[str, Any]) -> DesignPoint:
    return DesignPoint(perf=d["perf"], cost=d["cost"],
                       knobs=tuple((k, v) for k, v in d["knobs"]),
                       meta=tuple((k, v) for k, v in d["meta"]))


def _char_to_json(c: CharacterizationResult) -> Dict[str, Any]:
    return {"component": c.component,
            "regions": [_region_to_json(r) for r in c.regions],
            "points": [_dp_to_json(p) for p in c.points],
            "invocations": c.invocations, "failed": c.failed}


def _char_from_json(d: Dict[str, Any]) -> CharacterizationResult:
    return CharacterizationResult(
        component=d["component"],
        regions=[_region_from_json(r) for r in d["regions"]],
        points=[_dp_from_json(p) for p in d["points"]],
        invocations=d["invocations"], failed=d["failed"])


def _plan_to_json(p: PlanPoint) -> Dict[str, Any]:
    out = {"theta": p.theta, "cost": p.cost,
           "lam_targets": dict(p.lam_targets)}
    if p.schedule is not None:
        out["schedule"] = p.schedule.to_json()
    return out


def _plan_from_json(d: Dict[str, Any]) -> PlanPoint:
    sched = d.get("schedule")     # pre-schedule snapshots: None
    if sched is not None:
        sched = Schedule.from_json(sched)
    return PlanPoint(theta=d["theta"], cost=d["cost"],
                     lam_targets=dict(d["lam_targets"]), schedule=sched)


def _outcome_to_json(o: MapOutcome) -> Dict[str, Any]:
    return {"component": o.component,
            "synthesis": _synth_to_json(o.synthesis),
            "region": None if o.region is None else _region_to_json(o.region),
            "requested_lam": o.requested_lam, "fallback": o.fallback}


def _outcome_from_json(d: Dict[str, Any]) -> MapOutcome:
    region = d["region"]
    return MapOutcome(component=d["component"],
                      synthesis=_synth_from_json(d["synthesis"]),
                      region=None if region is None
                      else _region_from_json(region),
                      requested_lam=d["requested_lam"],
                      fallback=d["fallback"])


def _system_to_json(m: SystemPoint) -> Dict[str, Any]:
    """Serialize one mapped point — including ``schedule`` and the
    memory plan's ``compat_tag``, which must survive a save/restore
    cycle byte-identically."""
    out: Dict[str, Any] = {
        "theta_planned": m.theta_planned, "cost_planned": m.cost_planned,
        "theta_actual": m.theta_actual, "cost_actual": m.cost_actual,
        "outcomes": [_outcome_to_json(o) for o in m.outcomes],
        "cost_unshared": m.cost_unshared,
        "plm_groups": [list(g) for g in m.plm_groups],
    }
    if m.memory_plan is not None:
        from .plm.spec import memory_plan_to_json
        out["memory_plan"] = memory_plan_to_json(m.memory_plan)
    if m.schedule is not None:
        out["schedule"] = m.schedule.to_json()
    return out


def _system_from_json(d: Dict[str, Any]) -> SystemPoint:
    mem = d.get("memory_plan")
    if mem is not None:
        from .plm.spec import memory_plan_from_json
        mem = memory_plan_from_json(mem)
    sched = d.get("schedule")
    if sched is not None:
        sched = Schedule.from_json(sched)
    return SystemPoint(
        theta_planned=d["theta_planned"], cost_planned=d["cost_planned"],
        theta_actual=d["theta_actual"], cost_actual=d["cost_actual"],
        outcomes=tuple(_outcome_from_json(o) for o in d["outcomes"]),
        cost_unshared=d["cost_unshared"],
        plm_groups=tuple(tuple(g) for g in d["plm_groups"]),
        memory_plan=mem, schedule=sched)


# ----------------------------------------------------------------------
# The session
# ----------------------------------------------------------------------
class ExplorationSession:
    """One COSMOS exploration of a system TMG over a synthesis oracle.

    ``tool`` is any oracle backend (``HLSTool``, ``XLATool``,
    ``CudaOracle``, or anything matching the ``SynthesisTool``/``Oracle``
    protocols); it is wrapped in an :class:`OracleLedger` unless a ledger
    is passed directly.  ``workers`` bounds the per-phase fan-out (1 is
    the sequential drive, call for call).  ``fixed``
    maps software components (Matrix-Inv in Fig. 8) to their fixed
    effective latency — they join the TMG but are never synthesized.
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
    ``pricer`` (a :class:`~repro_torch.core.pricing.BatchPricer`) turns
    on surrogate-guided characterization (``surrogate``, default a fresh
    :class:`~repro_torch.core.surrogate.RidgeSurrogate`); ``tracer``
    records the phase spans (default: the ledger's tracer).
    """

    def __init__(self, tmg: TMG, tool, spaces: Dict[str, KnobSpace], *,
                 delta: float = 0.25,
                 fixed: Optional[Dict[str, float]] = None,
                 ledger: Optional[OracleLedger] = None,
                 cache: Optional[OracleCache] = None,
                 workers: int = 1,
                 memory_planner=None,
                 verify_plans: bool = False,
                 pricer=None,
                 surrogate=None,
                 tracer=None,
                 on_event: Optional[Callable[[ProgressEvent], None]] = None):
        self.tmg = tmg
        self.spaces = dict(spaces)
        self.delta = float(delta)
        self.fixed = dict(fixed or {})
        self.workers = max(1, int(workers))
        self.memory_planner = memory_planner
        self.verify_plans = bool(verify_plans)
        # surrogate-guided characterization (core.surrogate): a
        # BatchPricer turns the Algorithm-1 walk into grid lookups and
        # the surrogate picks which corner to confirm through the real
        # oracle; None keeps the unguided walk exactly as before
        self.pricer = pricer
        if surrogate is None and pricer is not None:
            surrogate = RidgeSurrogate()
        self.surrogate = surrogate
        self.guided: Optional[Dict[str, Any]] = None  # per-component stats
        self.on_event = on_event
        if tracer is not None:
            self.tracer = tracer
        elif ledger is not None:
            # one trace for the whole drive: adopt the ledger's tracer so
            # phase spans and oracle.point spans land in the same export
            self.tracer = getattr(ledger, "tracer", NULL_TRACER)
        else:
            self.tracer = NULL_TRACER
        if ledger is not None:
            if cache is not None:
                raise ValueError("pass `cache` to the ledger's constructor "
                                 "when supplying a pre-built ledger — a "
                                 "session-level cache would be silently "
                                 "ignored otherwise")
            self.ledger = ledger
        else:
            self.ledger = OracleLedger(tool, cache=cache,
                                       workers=self.workers,
                                       tracer=self.tracer)
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
        # progress is span-derived: the same tick that reaches on_event
        # lands in the trace as a zero-duration instant, so callbacks
        # (the legacy surface) and trace exports can never disagree
        self.tracer.instant("session.progress", phase=phase, label=label,
                            done=done, total=total)
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
        with self.tracer.span("session.characterize",
                              components=len(work)) as phase_sp:
            self._emit("characterize", "", 0, len(work))

            done = [0]

            guided_stats: Dict[str, Any] = {}
            if self.pricer is not None and self.surrogate is not None:
                # phase-start fit from whatever the ledger already paid
                # for (a restored or pre-warmed session): every
                # component then ranks against the SAME surrogate state
                # regardless of fan-out order, so the guided books are
                # identical at any worker count
                self.surrogate.fit(self.ledger.records)

            def one(name: str) -> CharacterizationResult:
                # explicit parent: under a fan-out this runs on a pool
                # thread, where the thread-local stack is empty
                with self.tracer.span("session.component",
                                      parent=phase_sp,
                                      component=name) as sp:
                    if self.pricer is not None:
                        guided = guided_characterize_component(
                            self.ledger, name, self.spaces[name],
                            pricer=self.pricer, surrogate=self.surrogate,
                            refit=False)
                        res = guided.result
                        with self._progress_lock:
                            guided_stats[name] = {
                                "confirmed": guided.confirmed,
                                "fell_back": guided.fell_back,
                                "grid_invocations": guided.grid_invocations,
                            }
                        sp.set("guided", True)
                        sp.set("confirmed", guided.confirmed)
                    else:
                        res = characterize_component(self.ledger, name,
                                                     self.spaces[name])
                    sp.set("regions", len(res.regions))
                    sp.set("invocations", res.invocations)
                with self._progress_lock:
                    done[0] += 1
                    n_done = done[0]
                self._emit("characterize", name, n_done, len(work))
                return res

            results = self._pool_map(one, work)
            self.characterizations = dict(zip(work, results))
            if self.pricer is not None:
                self.guided = {n: guided_stats[n] for n in work}
                if self.surrogate is not None:
                    # phase-end refit from everything actually paid for
                    # (confirmations included) — guides the next session
                    # sharing this surrogate; fit() canonicalizes record
                    # order, so the weights are fan-out independent too
                    self.surrogate.fit(self.ledger.records)
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
        with self.tracer.span("session.plan", delta=self.delta) as sp:
            self._emit("plan", "", 0, 1)
            self.theta_min, self.theta_max = theta_bounds(self.tmg,
                                                          self.models)
            self.planned = sweep(self.tmg, self.models, self.delta)
            sp.set("points", len(self.planned))
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
        with self.tracer.span("session.map",
                              points=len(planned)) as phase_sp:
            self._emit("map", "", 0, len(planned))
            done = [0]

            def one(plan_pt: PlanPoint) -> SystemPoint:
                with self.tracer.span("session.map_point",
                                      parent=phase_sp,
                                      theta=plan_pt.theta) as sp:
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
                    sp.set("theta_actual", theta_actual)
                    sp.set("cost_actual", cost_actual)
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
        if "tracer" in params:
            kwargs["tracer"] = self.tracer
        # pre-schedule / pre-tracer custom planners get neither keyword
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

    # -- mid-run serialization -----------------------------------------
    def state(self) -> Dict[str, Any]:
        """JSON-able snapshot of every completed phase.

        Version 2 also snapshots the mapped points (schedules, memory
        plans with their ``compat_tag``, map outcomes): a session saved
        after ``map()`` restores its full result without a single tool
        invocation.  Version-1 snapshots (no ``mapped``) still load —
        they re-map from the cached invocations as before.
        """
        return {
            "version": 2,
            "delta": self.delta,
            "fixed": dict(self.fixed),
            "characterizations": (
                None if self.characterizations is None else
                {n: _char_to_json(c)
                 for n, c in self.characterizations.items()}),
            "theta": [self.theta_min, self.theta_max],
            "planned": (None if self.planned is None else
                        [_plan_to_json(p) for p in self.planned]),
            "mapped": (None if self.mapped is None else
                       [_system_to_json(m) for m in self.mapped]),
        }

    def load_state(self, state: Dict[str, Any]) -> None:
        if state.get("version") not in (1, 2):
            raise ValueError(f"unknown session state version: "
                             f"{state.get('version')!r}")
        chars = state.get("characterizations")
        if chars is not None:
            self.characterizations = {n: _char_from_json(c)
                                      for n, c in chars.items()}
            self._build_models()
        planned = state.get("planned")
        if planned is not None:
            self.planned = [_plan_from_json(p) for p in planned]
            self.theta_min, self.theta_max = state["theta"]
        mapped = state.get("mapped")          # absent in version-1 snapshots
        if mapped is not None:
            self.mapped = [_system_from_json(m) for m in mapped]

    def save(self, root: str) -> None:
        """Checkpoint the completed phases atomically (store protocol)."""
        import numpy as np
        from ..checkpoint import store
        step = (store.latest_step(root) or 0) + 1
        n_done = sum(x is not None for x in (self.characterizations,
                                             self.planned, self.mapped))
        store.save(root, step, {"phases_done": np.asarray(n_done)},
                   extra={"session": self.state()})

    @classmethod
    def restore(cls, root: str, tmg: TMG, tool,
                spaces: Dict[str, KnobSpace], **kwargs) -> "ExplorationSession":
        """Rebuild a session from :meth:`save` output and continue from
        the first unfinished phase."""
        import numpy as np
        from ..checkpoint import store
        sess = cls(tmg, tool, spaces, **kwargs)
        step = store.latest_step(root)
        if step is not None:
            _, extra = store.restore(root, step,
                                     {"phases_done": np.asarray(0)})
            sess.load_state(extra["session"])
        return sess

    # -- session-as-query ----------------------------------------------
    @classmethod
    def from_query(cls, query: DSEQuery, **kwargs) -> "ExplorationSession":
        """Resolve a :class:`DSEQuery` through the App/Backend registry
        — what the DSE service runs per tenant.  Keywords (``ledger``,
        ``tool``, ``verify_plans``, ...) flow to
        :func:`~repro_torch.core.registry.build_query_session`."""
        from .registry import build_query_session   # lazy: registry imports us
        return build_query_session(query, **kwargs)
