"""Static analysis over schedules, PLM plans, and the registry.

Derivation-only tools (nothing here compiles or times a kernel):

* :mod:`.intervals` — schedule-conditional non-concurrency certificates
  from the LP's solved sigma/tau (busy-interval analysis mod the
  period), feeding the planner's two-tier
  :class:`~repro_torch.core.plm.compat.CompatSource`;
* :mod:`.verify` — an independent race detector that re-proves every
  shared-bank group of an emitted
  :class:`~repro_torch.core.plm.spec.MemoryPlan` pairwise
  non-concurrent, capacity-feasible, and dominance-guarded
  (``python -m repro_torch.core.analysis.verify`` runs it over plan
  artifacts);
* :mod:`.packing` — the exhaustive-optimal shared-bank packer that gates
  the greedy planner on small graphs;
* :mod:`.lint` — the static lint over the package's registry
  (``python -m repro_torch.core.analysis.lint``): registry consistency,
  kernel-spec static feasibility against the card's shared memory,
  knob-space sanity, traced oracles and SoC artifact provenance, with
  stable rule IDs (docs/analysis.md).

Submodules are imported lazily: :mod:`repro_torch.core.plm.planner`
pulls :mod:`.intervals` at plan time, and an eager ``verify`` import
here would close an import cycle back into the planner.
"""

from __future__ import annotations

_SUBMODULES = ("intervals", "verify", "lint", "packing")

__all__ = list(_SUBMODULES) + [
    "BusyInterval", "ScheduleCertificate", "schedule_exclusive_pairs",
    "compat_source_for", "Violation", "PlanVerificationError",
    "verify_plan", "optimal_plan", "LintFinding", "lint_app", "lint_all",
]

_LAZY = {
    "BusyInterval": "intervals",
    "ScheduleCertificate": "intervals",
    "schedule_exclusive_pairs": "intervals",
    "compat_source_for": "intervals",
    "Violation": "verify",
    "PlanVerificationError": "verify",
    "verify_plan": "verify",
    "optimal_plan": "packing",
    "LintFinding": "lint",
    "lint_app": "lint",
    "lint_all": "lint",
}


def __getattr__(name: str):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    mod = _LAZY.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
