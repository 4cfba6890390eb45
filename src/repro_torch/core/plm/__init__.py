"""System-level PLM planning: memory as a first-class DSE axis.

  * :mod:`.spec`    — requirements, groups, and memory plans;
  * :mod:`.compat`  — the TMG one-token-cycle non-concurrency
    certificate (which components may share banks);
  * :mod:`.planner` — the deterministic greedy shared-bank planner whose
    benefit guard makes the planned system cost pointwise no worse than
    the paper's per-component sum;
  * :mod:`.units`   — fitted exchange rates (latency scales + one global
    area scale) so mixed measured+analytical systems price in one unit,
    and the measured oracle's one area rule (:func:`smem_area_bytes`).

Entry point: hang a :class:`PLMPlanner` on an
:class:`~repro_torch.core.session.ExplorationSession`
(``memory_planner=``), or ``build_session(app, backend,
share_plm=True)`` through :mod:`repro_torch.core.registry`.
"""

from .compat import CompatSource, MemoryCompatGraph, exclusive_pairs
from .planner import PLMPlanner, shared_area
from .spec import (MemoryGroup, MemoryPlan, PLMRequirement,
                   memory_plan_from_json, memory_plan_to_json,
                   requirement_from_synthesis)
from .units import (BANK_OVERHEAD_BYTES, UnitSystem, fit_unit_system,
                    smem_area_bytes)

__all__ = [
    "PLMRequirement", "MemoryGroup", "MemoryPlan",
    "requirement_from_synthesis", "memory_plan_to_json",
    "memory_plan_from_json",
    "CompatSource", "MemoryCompatGraph", "exclusive_pairs",
    "PLMPlanner", "shared_area",
    "UnitSystem", "fit_unit_system", "smem_area_bytes",
    "BANK_OVERHEAD_BYTES",
]
