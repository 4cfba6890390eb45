"""COSMOS core: compositional DSE coordinating synthesis + memory tools.

The paper's primary contribution, implemented generically over a batched
synthesis oracle:

  * :mod:`repro_torch.core.tmg` — timed-marked-graph system model
    (Section 2.2)
  * :mod:`repro_torch.core.oracle` — the oracle protocol: batched
    ``evaluate``/``evaluate_batch`` and the ``OracleLedger`` invocation
    accounting (Fig. 11)
  * :mod:`repro_torch.core.session` — ``ExplorationSession``: the
    batched drive with explicit characterize/plan/map phases
  * :mod:`repro_torch.core.characterize` — Algorithm 1 (Section 5)
  * :mod:`repro_torch.core.planning` — Eq. (2) LP synthesis planning
    (Section 6.1)
  * :mod:`repro_torch.core.mapping` — Eq. (4/5) synthesis mapping
    (Section 6.2)
  * :mod:`repro_torch.core.dse` — thin drivers + exhaustive baseline
    (Section 7)
  * :mod:`repro_torch.core.hlsim` / :mod:`repro_torch.core.memgen` — the
    simulated HLS + Mnemosyne oracles
  * :mod:`repro_torch.core.cuda_oracle` — the measured backend:
    knob-parameterized CUDA kernels timed on the card per point, with
    record/replay
  * :mod:`repro_torch.core.xlatool` — the analytical fleet backend:
    roofline prices of fleet shares on the chip table
    (:mod:`repro_torch.core.chips`), footprints from
    :mod:`repro_torch.core.autotune`
  * :mod:`repro_torch.core.plm` — system-level PLM planning (shared
    banks across components the TMG certifies non-concurrent) and the
    unit exchange rates of :mod:`repro_torch.core.calibrate`;
    :mod:`repro_torch.core.analysis` re-proves emitted plans
  * :mod:`repro_torch.core.registry` — the App/Backend registry and
    ``build_session``, the one session constructor
  * :mod:`repro_torch.core.pricing` / :mod:`repro_torch.core.surrogate`
    — bit-exact whole-grid pricing of the analytical backends and
    surrogate-guided characterization over it
  * :mod:`repro_torch.core.obs` — span tracer, metrics registry, trace
    schema
"""

from .calibrate import (CalibratedTool, CalibrationFit, calibrate_to_records,
                        fit_area_scale, fit_latency_scales)
from .characterize import CharacterizationResult, characterize_component, spans
from .cuda_oracle import (CudaKernelSpec, CudaOracle, MeasurementSet,
                          MeasurementStore, MissingMeasurementError)
from .dse import (CosmosResult, ExhaustiveResult, SystemPoint,
                  compose_exhaustive, cosmos_dse, exhaustive_dse)
from .hlsim import ComponentSpec, HLSTool, LoopNest
from .knobs import (CDFGFacts, KnobSpace, Region, Synthesis, SynthesisTool,
                    powers_of_two)
from .mapping import MapOutcome, map_target, phi
from .memgen import MemGen, PLM, PLMSpec
from .obs import (Counter, Gauge, Histogram, LogicalClock, MetricsRegistry,
                  NULL_TRACER, NullTracer, Span, Tracer, WallClock)
from .oracle import (CountingTool, InvocationRecord, InvocationRequest,
                     Oracle, OracleBatchMixin, OracleLedger,
                     PersistentOracleCache, SharedOracle)
from .pareto import (DesignPoint, check_delta_curve, dominates_max_min,
                     dominates_min_min, pareto_front_max_min,
                     pareto_front_min_min, span)
from .planning import (ComponentModel, PiecewiseLinearCost, PlanPoint,
                       Schedule, plan, sweep, theta_bounds)
from .plm import (MemoryCompatGraph, MemoryGroup, MemoryPlan, PLMPlanner,
                  PLMRequirement, UnitSystem, exclusive_pairs,
                  fit_unit_system, smem_area_bytes)
from .registry import (App, Backend, build_query_session, build_session,
                       build_tool, get_app, get_backend, list_apps,
                       list_backends, register_app, register_backend)
from .pricing import BatchPricer
from .session import DSEQuery, ExplorationSession, ProgressEvent
from .surrogate import (GuidedCharacterization, RidgeSurrogate,
                        guided_characterize_component)
from .tmg import TMG, Place, Transition, feedback_pipeline_tmg, pipeline_tmg

__all__ = [
    "TMG", "Place", "Transition", "pipeline_tmg", "feedback_pipeline_tmg",
    "DesignPoint", "pareto_front_min_min", "pareto_front_max_min", "span",
    "check_delta_curve", "dominates_min_min", "dominates_max_min",
    "KnobSpace", "Region", "Synthesis", "CDFGFacts", "SynthesisTool",
    "powers_of_two",
    "Oracle", "OracleBatchMixin", "OracleLedger", "CountingTool",
    "InvocationRequest", "InvocationRecord", "PersistentOracleCache",
    "SharedOracle",
    "CudaOracle", "CudaKernelSpec", "MeasurementStore", "MeasurementSet",
    "MissingMeasurementError",
    "PLMRequirement", "MemoryGroup", "MemoryPlan", "MemoryCompatGraph",
    "exclusive_pairs", "PLMPlanner", "UnitSystem", "fit_unit_system",
    "smem_area_bytes",
    "CalibrationFit", "CalibratedTool", "fit_latency_scales",
    "fit_area_scale", "calibrate_to_records",
    "App", "Backend", "register_app", "register_backend", "get_app",
    "get_backend", "list_apps", "list_backends", "build_tool",
    "build_session", "build_query_session",
    "ExplorationSession", "ProgressEvent", "DSEQuery",
    "ComponentSpec", "LoopNest", "HLSTool", "MemGen", "PLM", "PLMSpec",
    "CharacterizationResult", "characterize_component", "spans",
    "ComponentModel", "PiecewiseLinearCost", "PlanPoint", "Schedule",
    "plan", "sweep", "theta_bounds",
    "phi", "map_target", "MapOutcome",
    "cosmos_dse", "CosmosResult", "exhaustive_dse", "ExhaustiveResult",
    "compose_exhaustive", "SystemPoint",
    "BatchPricer", "RidgeSurrogate", "GuidedCharacterization",
    "guided_characterize_component",
    "Tracer", "Span", "NullTracer", "NULL_TRACER", "WallClock",
    "LogicalClock", "MetricsRegistry", "Counter", "Gauge", "Histogram",
]
