"""Fit the analytical backend's constants to measured oracle points.

COSMOS treats the synthesis tool as ground truth; analytical models like
``HLSTool`` are stand-ins whose *absolute* numbers are uncalibrated (the
paper's claims are about ratios — hlsim.py).  Once a measured backend
(:class:`~repro_torch.core.cuda_oracle.CudaOracle`) has priced real
(component, knob) points, this module closes the loop: it fits one
latency scale per component — the geometric mean of measured/analytical
over the commonly-feasible points, i.e. the least-squares solution in
log space — and wraps the analytical tool so both backends report
Pareto fronts on a comparable latency axis.  Shapes are NOT refitted:
if the analytical Amdahl profile is wrong within a region, the residual
spread (``lam_spread``) reports it rather than hiding it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .knobs import CDFGFacts, Synthesis, SynthesisTool
from .oracle import InvocationRecord, call_synthesize

__all__ = ["CalibrationFit", "fit_latency_scales", "fit_area_scale",
           "CalibratedTool", "calibrate_to_records"]


@dataclass(frozen=True)
class CalibrationFit:
    """Per-component latency scales + goodness-of-fit diagnostics."""

    scales: Dict[str, float]            # lam_measured ~= scale * lam_model
    points: Dict[str, int]              # fitted points per component
    lam_spread: Dict[str, float]        # max/min residual ratio (1.0 = exact)

    def scale(self, component: str) -> float:
        return self.scales.get(component, 1.0)


def _log_ratios(model: SynthesisTool, measured: Iterable[Tuple],
                axis: str) -> Dict[str, List[float]]:
    """Per-component log(measured / model-``axis``) over usable points.

    ``measured`` rows are (component, ports, unrolls, value) with an
    optional trailing tile — tile-axis drives must be compared against
    the model *at their tile*, not the native one.  Non-positive /
    non-finite measurements and infeasible model points are skipped.
    """
    logs: Dict[str, List[float]] = {}
    for comp, ports, unrolls, value, *rest in measured:
        if not (value > 0.0) or not math.isfinite(value):
            continue
        synth = call_synthesize(model, comp, unrolls=unrolls, ports=ports,
                                tile=rest[0] if rest else 0)
        ref = getattr(synth, axis)
        if not synth.feasible or ref <= 0:
            continue
        logs.setdefault(comp, []).append(math.log(value / ref))
    # order-independent float sums -> deterministic fits
    return {comp: sorted(ls) for comp, ls in logs.items()}


def fit_latency_scales(
        model: SynthesisTool,
        measured: Iterable[Tuple[str, int, int, float]]) -> CalibrationFit:
    """``measured``: (component, ports, unrolls, lam_measured[, tile])
    points.

    Infeasible model points and non-positive measurements are skipped;
    a component with no usable overlap keeps scale 1.0 (reported with
    points=0).
    """
    scales, points, spread = {}, {}, {}
    for comp, ls in _log_ratios(model, measured, "lam").items():
        scales[comp] = math.exp(sum(ls) / len(ls))
        points[comp] = len(ls)
        spread[comp] = math.exp(ls[-1] - ls[0]) if len(ls) > 1 else 1.0
    return CalibrationFit(scales=scales, points=points, lam_spread=spread)


def fit_area_scale(model: SynthesisTool,
                   measured: Iterable[Tuple[str, int, int, float]]
                   ) -> Tuple[float, int, float]:
    """Fit ONE global area exchange rate measured-unit-per-model-unit.

    ``measured``: (component, ports, unrolls, area_measured[, tile])
    points in the measured backend's unit (e.g. shared-memory bytes).
    The scale is the log-space least-squares solution over every usable
    point — global rather than per-component on purpose: a single
    multiplier cannot reorder model-unit areas, so dominance relations
    *within* the analytical backend are preserved exactly.  Returns
    (scale, n_points, residual spread); (1.0, 0, 1.0) when nothing
    overlaps.
    """
    logs = sorted(ls for per_comp in
                  _log_ratios(model, measured, "area").values()
                  for ls in per_comp)
    if not logs:
        return 1.0, 0, 1.0
    scale = math.exp(sum(logs) / len(logs))
    spread = math.exp(logs[-1] - logs[0]) if len(logs) > 1 else 1.0
    return scale, len(logs), spread


def calibrate_to_records(model: SynthesisTool,
                         records: Sequence[InvocationRecord]
                         ) -> CalibrationFit:
    """Fit from an :class:`OracleLedger`'s records of a measured drive
    (the feasible ones carry the measured lambda; tile-axis records
    are compared against the model at their own tile)."""
    return fit_latency_scales(
        model, ((r.component, r.ports, r.unrolls, r.lam, r.tile)
                for r in records if r.feasible))


class CalibratedTool:
    """An analytical SynthesisTool with per-component latency scales.

    By default areas are left untouched — the two backends price cost in
    different units (mm^2 vs shared-memory bytes) on purpose; only the
    latency
axis, which the TMG throughput composes, is brought onto the
    measured scale.  Pass ``area_scale`` (see :func:`fit_area_scale` /
    :mod:`repro_torch.core.plm.units`) to also convert areas into the measured
    backend's cost unit — a single global multiplier, so min-min
    dominance among this tool's own points is preserved; ``unit`` then
    tags the converted requirements for the PLM planner.
    """

    def __init__(self, model: SynthesisTool, fit: CalibrationFit, *,
                 area_scale: float = 1.0, unit: str = "mm2"):
        self.model = model
        self.fit = fit
        self.area_scale = float(area_scale)
        self.unit = unit

    def synthesize(self, component: str, *, unrolls: int, ports: int,
                   max_states: Optional[int] = None,
                   tile: int = 0) -> Synthesis:
        s = call_synthesize(self.model, component, unrolls=unrolls,
                            ports=ports, max_states=max_states, tile=tile)
        if not s.feasible:
            return s
        k = self.fit.scale(component)
        a = self.area_scale
        detail = {**s.detail, "lam_scale": k}
        if a != 1.0:
            detail["area_scale"] = a
            for key in ("area_logic", "area_plm"):
                if key in detail:
                    detail[key] = detail[key] * a
        return Synthesis(lam=s.lam * k, area=s.area * a, ports=s.ports,
                         unrolls=s.unrolls,
                         states_per_iter=s.states_per_iter,
                         feasible=s.feasible,
                         detail=detail, tile=s.tile)

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        return self.model.cdfg_facts(component, synth)

    def plm_requirement(self, component: str, synth: Synthesis):
        """Requirements in this tool's unit, so calibrated components can
        share banks with (and sum cleanly against) the measured
        backend's.  Built from the already-converted synthesis detail —
        delegating to the model would re-scale areas a second time."""
        if self.area_scale == 1.0:
            fn = getattr(self.model, "plm_requirement", None)
            return None if fn is None else fn(component, synth)
        # lazy: repro_torch.core.plm.units imports this module
        from dataclasses import replace as _replace

        from .plm.spec import requirement_from_synthesis
        req = requirement_from_synthesis(component, synth, unit=self.unit)
        if self.unit == "bytes" and req.capacity:
            # requirement_from_synthesis reports capacity in PLM words;
            # byte-unit groups compare capacities against shared-memory
            # bytes
            req = _replace(req,
                           capacity=req.capacity * max(8, req.word_bits) // 8)
        return req
