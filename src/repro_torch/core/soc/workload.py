"""Traffic mixes: what the chip is asked to serve, per registered app.

A :class:`TrafficMix` is the demand side of SoC composition: a named
set of :class:`AppDemand` entries, one per registered app, each saying
*how much* of the request stream is that app (``share``) and how to
price one served request against the chip budgets:

* ``bytes_per_request`` — DRAM traffic per request, so a replica
  running at ``theta`` requests/s charges ``theta * bytes_per_request``
  against the bandwidth envelope;
* ``area_scale`` — the exchange rate from the app's *native* Pareto
  cost unit to reference-node mm^2.  COSMOS fronts are app-native on
  purpose (WAMI prices in mm^2, the fleet pipeline in HBM bytes — see
  docs/memory.md on unit systems); the mix is where a chip-level
  comparison fixes the rate, and provenance keeps it auditable;
* ``backend`` / ``share_plm`` / ``delta`` — which exploration produces
  the front the composer consumes (PLM-shared fronts included).

Apps resolve through :mod:`repro_torch.core.registry` — any app
registered there participates, and typos raise the registry's listing
errors.  A front of the measured ``cuda`` backend prices in the card
oracle's shared-memory bytes (``plm/units.py::smem_area_bytes``), so a
mix over such fronts sets each ``area_scale`` through the app's fitted
unit system (``TrafficMix.parse``'s per-app overrides).
``TrafficMix.parse("wami=0.6,fleet=0.4")`` is the CLI/bench surface;
:data:`DEFAULT_DEMANDS` carries the per-app pricing defaults the parser
applies so one string names a fully priced mix.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["AppDemand", "TrafficMix", "DEFAULT_DEMANDS"]


@dataclass(frozen=True)
class AppDemand:
    """One app's slice of the mix, plus its budget pricing knobs."""

    app: str
    share: float
    bytes_per_request: float = 0.0
    area_scale: float = 1.0          # ref-node mm^2 per native cost unit
    backend: str = "analytical"
    share_plm: bool = False
    delta: Optional[float] = None

    def __post_init__(self):
        if not (isinstance(self.share, (int, float)) and self.share > 0):
            raise ValueError(f"demand {self.app!r}: share must be positive, "
                             f"got {self.share!r}")
        if self.area_scale <= 0:
            raise ValueError(f"demand {self.app!r}: area_scale must be "
                             f"positive, got {self.area_scale!r}")
        if self.bytes_per_request < 0:
            raise ValueError(f"demand {self.app!r}: bytes_per_request must "
                             f"be >= 0, got {self.bytes_per_request!r}")

    def to_json(self) -> Dict[str, Any]:
        return {"app": self.app, "share": self.share,
                "bytes_per_request": self.bytes_per_request,
                "area_scale": self.area_scale, "backend": self.backend,
                "share_plm": self.share_plm, "delta": self.delta}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "AppDemand":
        return cls(app=doc["app"], share=doc["share"],
                   bytes_per_request=doc.get("bytes_per_request", 0.0),
                   area_scale=doc.get("area_scale", 1.0),
                   backend=doc.get("backend", "analytical"),
                   share_plm=doc.get("share_plm", False),
                   delta=doc.get("delta"))


#: per-app pricing defaults :meth:`TrafficMix.parse` applies — the one
#: place the bench, the CLI, and the tests agree on what a request of
#: each built-in app costs the chip.  WAMI serves 2048x2048 u16 frames
#: (~8.4 MB DRAM traffic each) from its mm^2-priced, PLM-shared front;
#: the fleet pipeline's front prices in HBM bytes, exchanged at
#: 2 mm^2 per TB of pinned HBM footprint.
DEFAULT_DEMANDS: Dict[str, Dict[str, Any]] = {
    "wami": {"bytes_per_request": 2 * 2048 * 2048 * 2.0,
             "area_scale": 1.0, "share_plm": True},
    "fleet": {"bytes_per_request": 1.0e9, "area_scale": 2.0e-12},
}


@dataclass(frozen=True)
class TrafficMix:
    """A named, normalizable set of per-app demands (apps unique)."""

    name: str
    demands: Tuple[AppDemand, ...]

    def __post_init__(self):
        if not isinstance(self.demands, tuple):
            object.__setattr__(self, "demands", tuple(self.demands))
        if not self.demands:
            raise ValueError(f"mix {self.name!r}: no demands")
        apps = [d.app for d in self.demands]
        if len(set(apps)) != len(apps):
            raise ValueError(f"mix {self.name!r}: duplicate apps {apps}")

    # -- reading -------------------------------------------------------
    def demand(self, app: str) -> AppDemand:
        for d in self.demands:
            if d.app == app:
                return d
        raise KeyError(f"mix {self.name!r} has no demand for app {app!r}; "
                       f"apps in mix: {sorted(d.app for d in self.demands)}")

    def shares(self) -> Dict[str, float]:
        """Per-app share of the request stream, normalized to sum 1."""
        total = sum(d.share for d in self.demands)
        return {d.app: d.share / total for d in self.demands}

    def resolve(self) -> List[Any]:
        """The registered :class:`~repro_torch.core.registry.App`
        records, in demand order — unknown apps raise the registry's
        listing KeyError (the same error a bad ``--mix`` gets on the
        CLI)."""
        from ..registry import get_app
        return [get_app(d.app) for d in self.demands]

    # -- construction --------------------------------------------------
    @classmethod
    def parse(cls, spec: str, name: Optional[str] = None,
              **overrides: Dict[str, Any]) -> "TrafficMix":
        """``"wami=0.6,fleet=0.4"`` -> a fully priced mix.

        Each app picks up its :data:`DEFAULT_DEMANDS` pricing;
        ``overrides`` maps app -> field dict for per-call tweaks
        (``TrafficMix.parse(spec, wami={"share_plm": False})``).
        """
        demands: List[AppDemand] = []
        for part in (p for p in spec.split(",") if p.strip()):
            if "=" not in part:
                raise ValueError(f"bad mix entry {part!r} in {spec!r} "
                                 f"(want app=share,app=share,...)")
            app, share_s = part.split("=", 1)
            app = app.strip()
            fields: Dict[str, Any] = dict(DEFAULT_DEMANDS.get(app, {}))
            fields.update(overrides.get(app, {}))
            demands.append(AppDemand(app=app, share=float(share_s),
                                     **fields))
        if not demands:
            raise ValueError(f"empty mix spec {spec!r}")
        if name is None:
            name = "_".join(f"{d.app}{round(d.share * 100):g}"
                            for d in demands)
        return cls(name=name, demands=tuple(demands))

    def normalized(self) -> "TrafficMix":
        shares = self.shares()
        return replace(self, demands=tuple(
            replace(d, share=shares[d.app]) for d in self.demands))

    # -- provenance ----------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name,
                "demands": [d.to_json() for d in self.demands]}

    @classmethod
    def from_json(cls, doc: Dict[str, Any]) -> "TrafficMix":
        return cls(name=doc["name"],
                   demands=tuple(AppDemand.from_json(d)
                                 for d in doc["demands"]))
