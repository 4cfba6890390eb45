"""SoC budgets: the global area / power / bandwidth envelopes.

COSMOS sizes *one* accelerator; composing a chip's worth of them needs
the budgets the chip itself imposes.  :class:`SoCBudget` carries the
three envelopes every composition is priced against — logic area
(mm^2), power (W), and DRAM bandwidth (GB/s) — plus a technology-node
scaling hook in the Lumos MPSoC style (SNIPPETS.md: ``budget.area`` /
``budget.power`` / ``budget.bw[tech]``): accelerators are characterized
once at the 45 nm reference node, and :meth:`SoCBudget.scale_area` /
:meth:`SoCBudget.power_of` re-price a reference-node area at the
budget's node through per-node scaling tables.  Area shrinks faster
than per-op power falls, so power density rises with every shrink —
the dark-silicon pressure the composer trades replicas against.

Three Lumos-flavored presets (``sys_small`` / ``sys_medium`` /
``sys_large``) cover the bench and CLI defaults; custom envelopes are
one dataclass call.  Everything here is pure data + arithmetic —
deterministic, JSON-round-trippable, no registry access.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

__all__ = ["TECH_NODES", "REF_TECH_NM", "SoCBudget", "BUDGET_PRESETS",
           "get_budget"]

#: the technology nodes the scaling tables know, newest last
TECH_NODES = (45, 32, 22, 16)

#: the node accelerator fronts are characterized at (all area scales in
#: :mod:`repro_torch.core.soc.workload` are mm^2 at this node)
REF_TECH_NM = 45

# per-node scaling relative to the 45 nm reference: logic shrinks
# ~0.5x per node, per-op power falls slower (~0.66x), and the DRAM
# interface speeds up — so power density *rises* with every shrink
_AREA_SCALE = {45: 1.0, 32: 0.505, 22: 0.255, 16: 0.129}
_POWER_SCALE = {45: 1.0, 32: 0.66, 22: 0.44, 16: 0.29}
_BW_SCALE = {45: 1.0, 32: 1.33, 22: 1.78, 16: 2.37}


def _check_tech(tech_nm: int) -> int:
    if tech_nm not in _AREA_SCALE:
        raise KeyError(f"unknown tech node {tech_nm!r} nm; known nodes: "
                       f"{list(TECH_NODES)}")
    return tech_nm


@dataclass(frozen=True)
class SoCBudget:
    """One chip's global envelopes, at one technology node.

    ``power_density_w_per_mm2`` is the accelerator logic's power
    density at the *reference* node; :meth:`power_of` applies the
    per-node per-op scaling on top of it.
    """

    name: str
    area_mm2: float
    power_w: float
    bw_gbps: float
    tech_nm: int = REF_TECH_NM
    power_density_w_per_mm2: float = 0.5

    def __post_init__(self):
        _check_tech(self.tech_nm)
        for field_ in ("area_mm2", "power_w", "bw_gbps",
                       "power_density_w_per_mm2"):
            v = getattr(self, field_)
            if not (isinstance(v, (int, float)) and v > 0):
                raise ValueError(f"budget {self.name!r}: {field_} must be "
                                 f"a positive number, got {v!r}")

    # -- the tech-node scaling hook ------------------------------------
    def at_tech(self, tech_nm: int) -> "SoCBudget":
        """This budget re-anchored at another node: the logic envelopes
        (area, power) stay the chip's — they are package/cooling
        limits — while the bandwidth envelope follows the node's DRAM
        interface scaling (Lumos's ``budget.bw[tech]`` table)."""
        _check_tech(tech_nm)
        bw = self.bw_gbps * _BW_SCALE[tech_nm] / _BW_SCALE[self.tech_nm]
        return replace(self, tech_nm=tech_nm, bw_gbps=bw)

    def scale_area(self, area_mm2_ref: float) -> float:
        """Reference-node (45 nm) logic area -> area at this node."""
        return area_mm2_ref * _AREA_SCALE[self.tech_nm]

    def power_of(self, area_mm2_ref: float) -> float:
        """Reference-node logic area -> watts at this node (density x
        per-op scaling; divided by area scaling this is the rising
        power-density curve)."""
        return (area_mm2_ref * self.power_density_w_per_mm2
                * _POWER_SCALE[self.tech_nm])

    # -- provenance ----------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "area_mm2": self.area_mm2,
                "power_w": self.power_w, "bw_gbps": self.bw_gbps,
                "tech_nm": self.tech_nm,
                "power_density_w_per_mm2": self.power_density_w_per_mm2}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "SoCBudget":
        return cls(name=doc["name"], area_mm2=doc["area_mm2"],
                   power_w=doc["power_w"], bw_gbps=doc["bw_gbps"],
                   tech_nm=doc.get("tech_nm", REF_TECH_NM),
                   power_density_w_per_mm2=doc.get(
                       "power_density_w_per_mm2", 0.5))


#: the Lumos-flavored platform presets (all at the 45 nm reference)
BUDGET_PRESETS: Dict[str, SoCBudget] = {
    "sys_small": SoCBudget("sys_small", area_mm2=100.0, power_w=40.0,
                           bw_gbps=128.0),
    "sys_medium": SoCBudget("sys_medium", area_mm2=200.0, power_w=80.0,
                            bw_gbps=256.0),
    "sys_large": SoCBudget("sys_large", area_mm2=400.0, power_w=150.0,
                           bw_gbps=512.0),
}


def get_budget(name: str) -> SoCBudget:
    """Resolve a preset by name; unknown names list what IS defined
    (the registry's error style)."""
    try:
        return BUDGET_PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown budget preset {name!r}; presets: "
                       f"{sorted(BUDGET_PRESETS)}") from None
