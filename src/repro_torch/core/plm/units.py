"""One cost unit per system: exchange rates between backend area units.

A mixed drive — :class:`~repro_torch.core.cuda_oracle.CudaOracle`
pricing the measured components in shared-memory bytes, an analytical
fallback pricing the rest in mm² — would otherwise sum the two straight
into one "system cost".  This module fits, from a measurement recording
alone, (a) the per-component latency scales the analytical model needs
to sit on the measured latency axis and (b) ONE global area exchange
rate (bytes per mm²).  A single multiplier cannot reorder the analytical
backend's own areas, so per-backend dominance is preserved exactly while
the system sum — and the PLM planner's cross-backend bank sharing —
becomes unit-clean.

Everything is computed from the store's *sorted* entries and an
analytical model query per entry, with no kernel execution: the
measured area is the oracle's own deterministic footprint formula
(:func:`smem_area_bytes`, the one rule the oracle prices by), so the fit
is byte-reproducible on any machine holding the recording.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from ..calibrate import (CalibratedTool, CalibrationFit, fit_area_scale,
                         fit_latency_scales)
from ..knobs import SynthesisTool

__all__ = ["UnitSystem", "fit_unit_system", "smem_area_bytes",
           "BANK_OVERHEAD_BYTES"]

#: fixed per-bank overhead (descriptors, barriers) in the area model
BANK_OVERHEAD_BYTES = 4096


def smem_area_bytes(spec, ports: int, unrolls: int) -> float:
    """The measured oracle's area rule: the double-buffered block bytes
    (``2 * step``, the footprint the shared-memory budget is checked
    against) in every parallel bank, plus a fixed per-bank overhead —
    ``2 * step * ports + 4096 * ports``.  ``spec`` is any
    CudaKernelSpec-shaped object (duck-typed: ``shape`` and
    ``vmem_bytes``)."""
    H, W = spec.shape
    step = spec.vmem_bytes(H, W, ports=ports, unrolls=unrolls)
    return float(2 * step * ports + BANK_OVERHEAD_BYTES * ports)


@dataclass(frozen=True)
class UnitSystem:
    """The fitted exchange rates for one mixed-backend system."""

    unit: str                       # the canonical cost unit ("bytes")
    lam: CalibrationFit             # per-component latency scales
    area_scale: float               # canonical-unit per model-unit
    area_points: int
    area_spread: float              # max/min residual ratio (1.0 = exact)

    def calibrated(self, model: SynthesisTool) -> CalibratedTool:
        """Wrap an analytical tool so it reports measured-axis latencies
        and canonical-unit areas — the fallback a mixed system drive
        (and the PLM planner) can consume directly."""
        return CalibratedTool(model, self.lam, area_scale=self.area_scale,
                              unit=self.unit)


def fit_unit_system(store, components: Dict[str, object],
                    model: SynthesisTool) -> UnitSystem:
    """Fit a :class:`UnitSystem` from a measurement recording.

    ``store`` is a :class:`~repro_torch.core.cuda_oracle.MeasurementStore`
    (duck-typed: ``.entries`` maps (component, ports, unrolls) to wall
    seconds); ``components`` maps component name to its
    CudaKernelSpec.  For every recorded point the measured latency is
    wall/ports (the oracle's column-bank convention) and the measured
    area is :func:`smem_area_bytes`; both fits skip points the
    analytical model deems infeasible.
    """
    lam_pts = []
    area_pts = []
    for key in sorted(store.entries):
        comp, ports, unrolls = key
        spec = components.get(comp)
        if spec is None or not spec.divisible(ports, unrolls):
            continue
        wall = store.entries[key]
        lam_pts.append((comp, ports, unrolls, wall / ports))
        area_pts.append((comp, ports, unrolls,
                         smem_area_bytes(spec, ports, unrolls)))
    lam_fit = fit_latency_scales(model, lam_pts)
    scale, n, spread = fit_area_scale(model, area_pts)
    return UnitSystem(unit="bytes", lam=lam_fit, area_scale=scale,
                      area_points=n, area_spread=spread)
