"""SoC composition: many accelerator instances, one chip.

The layer above one accelerator's DSE.
:mod:`~repro_torch.core.soc.budget` defines the global
area/power/bandwidth envelopes with Lumos-style tech-node scaling;
:mod:`~repro_torch.core.soc.workload` the per-app traffic mix (resolved
through the package's registry); :mod:`~repro_torch.core.soc.compose`
the replica x Pareto-point allocators (deterministic greedy + the
exhaustive small-instance packer); :mod:`~repro_torch.core.soc.verify`
the independent re-checker.  See docs/soc.md.
"""

from .budget import (BUDGET_PRESETS, REF_TECH_NM, SoCBudget, TECH_NODES,
                     get_budget)
from .workload import DEFAULT_DEMANDS, AppDemand, TrafficMix

__all__ = [
    "SoCBudget", "BUDGET_PRESETS", "TECH_NODES", "REF_TECH_NM",
    "get_budget",
    "AppDemand", "TrafficMix", "DEFAULT_DEMANDS",
    "OperatingPoint", "Allocation", "Composition",
    "BudgetInfeasibleError", "operating_points", "greedy_composition",
    "optimal_composition", "SoCComposer",
    "CompositionVerificationError", "verify_composition",
    "assert_composition_sound",
]

# compose/verify are also `python -m` entry points: importing them
# eagerly here would double-import under runpy (same rule as
# repro_torch.core.analysis), so their names resolve lazily
_COMPOSE_LAZY = {
    "OperatingPoint", "Allocation", "Composition",
    "BudgetInfeasibleError", "operating_points", "greedy_composition",
    "optimal_composition", "SoCComposer",
}
_VERIFY_LAZY = {
    "CompositionVerificationError", "verify_composition",
    "assert_composition_sound",
}


def __getattr__(name):
    if name in _COMPOSE_LAZY:
        from . import compose
        return getattr(compose, name)
    if name in _VERIFY_LAZY:
        from . import verify
        return getattr(verify, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
