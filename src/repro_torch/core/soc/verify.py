"""Independent re-verification of SoC compositions.

The composer *constructs* a composition; this module *re-proves* it,
trusting nothing but the artifact itself (and, optionally, freshly
resolved fronts).  In the :mod:`repro_torch.core.analysis.verify` style,
every obligation carries a stable rule ID:

* ``C-PROV`` — the artifact carries full provenance: the budget it was
  priced against and the mix it serves (the in-file half of lint rule
  SOC001);
* ``C-REPL`` — every demand in the mix gets exactly one allocation
  with a positive integer replica count, and no allocation serves an
  app outside the mix;
* ``C-PRICE`` — each allocation's per-replica area/power/bandwidth
  re-derives from its front point's native (theta, cost) through the
  demand's exchange rates and the budget's tech tables;
* ``C-AREA`` / ``C-POWER`` / ``C-BW`` — the re-summed totals fit the
  corresponding envelope;
* ``C-THETA`` — the claimed sustained throughput equals the re-derived
  ``min(capacity / share)`` over the normalized mix;
* ``C-FRONT`` — (only when fronts are supplied) every chosen operating
  point is actually on its app's Pareto front.

``python -m repro_torch.core.soc.verify [dir|file ...]`` re-proves committed
``*.composition.json`` artifacts (default: ``artifacts/bench_torch/soc``,
where this package writes; any path may be given, the JAX package's
``artifacts/bench/soc`` among them, which it only reads);
``--fronts`` additionally re-resolves each app's front through the
registry and checks ``C-FRONT`` against the *current* exploration.
Exit status is the number of violated artifacts (0 = everything
proved).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.verify import Violation
from ..pareto import DesignPoint
from .compose import BUDGET_FIELDS, Composition, price_point

__all__ = ["CompositionVerificationError", "verify_composition",
           "assert_composition_sound", "verify_composition_file", "main"]

_REL_TOL = 1e-9


class CompositionVerificationError(AssertionError):
    """Raised by :func:`assert_composition_sound` — a composition
    failed independent re-verification."""

    def __init__(self, violations: Sequence[Violation]):
        self.violations = tuple(violations)
        super().__init__("composition failed verification:\n  " +
                         "\n  ".join(str(v) for v in violations))


def verify_composition(comp: Composition, *,
                       fronts: Optional[Dict[str, Sequence[DesignPoint]]]
                       = None) -> List[Violation]:
    """Re-prove ``comp``; returns all violations ([] = proved)."""
    out: List[Violation] = []
    b = comp.budget

    # C-PROV: budget + mix provenance must be present and priceable
    if not comp.mix.demands:
        out.append(Violation("C-PROV", (), "mix carries no demands"))
        return out

    shares = comp.mix.shares()
    allocated = {}
    for a in comp.allocations:
        if a.app in allocated:
            out.append(Violation("C-REPL", (a.app,),
                                 "app allocated more than once"))
        allocated[a.app] = a
    for app in sorted(set(shares) - set(allocated)):
        out.append(Violation("C-REPL", (app,),
                             "demand in the mix has no allocation"))
    for app in sorted(set(allocated) - set(shares)):
        out.append(Violation("C-REPL", (app,),
                             "allocation for an app outside the mix"))

    for app in sorted(set(allocated) & set(shares)):
        a = allocated[app]
        if not (isinstance(a.replicas, int) and a.replicas >= 1):
            out.append(Violation("C-REPL", (app,),
                                 f"replica count {a.replicas!r} is not a "
                                 f"positive integer"))
            continue
        if abs(a.share - shares[app]) > _REL_TOL:
            out.append(Violation("C-REPL", (app,),
                                 f"recorded share {a.share!r} != "
                                 f"normalized mix share {shares[app]!r}"))
        # C-PRICE: re-derive the per-replica budget charges
        d = comp.mix.demand(app)
        area, power, bw = price_point(a.point.theta, a.point.cost, d, b)
        for field_, got, want in (("area_mm2", a.point.area_mm2, area),
                                  ("power_w", a.point.power_w, power),
                                  ("bw_gbps", a.point.bw_gbps, bw)):
            if abs(got - want) > _REL_TOL * max(1.0, abs(want)):
                out.append(Violation(
                    "C-PRICE", (app,),
                    f"recorded {field_} {got!r} != re-derived {want!r} "
                    f"(theta={a.point.theta}, cost={a.point.cost})"))
        # C-FRONT: the chosen point must be on the app's front
        if fronts is not None:
            front = fronts.get(app)
            if front is None:
                out.append(Violation("C-FRONT", (app,),
                                     "no front supplied for this app"))
            elif not any(abs(p.perf - a.point.theta)
                         <= _REL_TOL * max(1.0, abs(p.perf))
                         and abs(p.cost - a.point.cost)
                         <= _REL_TOL * max(1.0, abs(p.cost))
                         for p in front):
                out.append(Violation(
                    "C-FRONT", (app,),
                    f"operating point (theta={a.point.theta}, "
                    f"cost={a.point.cost}) is not on the app's "
                    f"{len(front)}-point Pareto front"))

    if any(v.rule == "C-REPL" for v in out):
        return out                     # totals below assume a clean cover

    # C-AREA / C-POWER / C-BW: re-summed totals fit the envelopes
    totals = (sum(a.area_mm2 for a in comp.allocations),
              sum(a.power_w for a in comp.allocations),
              sum(a.bw_gbps for a in comp.allocations))
    limits = (b.area_mm2, b.power_w, b.bw_gbps)
    rules = ("C-AREA", "C-POWER", "C-BW")
    for rule, field_, total, limit in zip(rules, BUDGET_FIELDS, totals,
                                          limits):
        if total > limit * (1 + _REL_TOL):
            out.append(Violation(
                rule, tuple(sorted(allocated)),
                f"re-summed {field_} {total:.6g} exceeds budget "
                f"{b.name!r} envelope {limit:.6g}"))

    # C-THETA: the throughput claim re-derives from the allocations
    t = min(a.capacity / shares[a.app] for a in comp.allocations)
    if abs(comp.sustained_throughput - t) > _REL_TOL * max(1.0, t):
        out.append(Violation(
            "C-THETA", tuple(sorted(allocated)),
            f"claimed sustained throughput {comp.sustained_throughput!r} "
            f"!= re-derived min(capacity/share) {t!r}"))
    return out


def assert_composition_sound(comp: Composition, *,
                             fronts: Optional[Dict[str,
                                                   Sequence[DesignPoint]]]
                             = None) -> None:
    """:func:`verify_composition`, raising on the first unsound
    composition — the strict post-pass of ``compose --verify``."""
    violations = verify_composition(comp, fronts=fronts)
    if violations:
        raise CompositionVerificationError(violations)


# ----------------------------------------------------------------------
# committed-artifact verification (CLI)
# ----------------------------------------------------------------------
def verify_composition_file(path: str, *, with_fronts: bool = False,
                            workers: int = 4
                            ) -> Tuple[int, List[Violation]]:
    """Verify one committed ``*.composition.json`` artifact.

    Returns (number of allocations checked, all violations).  With
    ``with_fronts=True`` each demand's front is re-resolved through the
    registry, so the proof also pins the chosen points to the *current*
    exploration's Pareto front (``C-FRONT``).
    """
    with open(path) as f:
        doc = json.load(f)
    missing = [k for k in ("budget", "mix", "allocations",
                           "sustained_throughput", "method") if k not in doc]
    if missing:
        return 0, [Violation("C-PROV", (),
                             f"artifact is missing provenance keys "
                             f"{missing}")]
    comp = Composition.from_json(doc)
    fronts = None
    if with_fronts:
        from .compose import SoCComposer
        fronts = SoCComposer(comp.budget, comp.mix,
                             workers=workers).fronts()
    return len(comp.allocations), verify_composition(comp, fronts=fronts)


def _find_composition_files(paths) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, n) for n in sorted(os.listdir(p))
                       if n.endswith(".composition.json"))
        else:
            out.append(p)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.soc.verify",
        description="independently re-prove committed SoC composition "
                    "artifacts feasible")
    ap.add_argument("paths", nargs="*",
                    default=[os.path.join("artifacts", "bench_torch",
                                          "soc")],
                    help="*.composition.json files or directories")
    ap.add_argument("--fronts", action="store_true",
                    help="re-resolve each app's Pareto front through the "
                         "registry and pin the chosen points (C-FRONT)")
    args = ap.parse_args(argv)
    files = _find_composition_files(args.paths)
    if not files:
        print(f"verify: no *.composition.json under {list(args.paths)}",
              file=sys.stderr)
        return 1
    bad = 0
    for path in files:
        if not os.path.exists(path):
            # the default directory exists only once a run has written
            # there: a missing path fails, with no traceback
            bad += 1
            print(f"FAIL {path}: no such file or directory")
            continue
        n, violations = verify_composition_file(path,
                                                with_fronts=args.fronts)
        if violations:
            bad += 1
            print(f"FAIL {path}: {len(violations)} violation(s) "
                  f"across {n} allocation(s)")
            for v in violations:
                print(f"  {v}")
        else:
            extra = ", front-pinned" if args.fronts else ""
            print(f"ok   {path}: {n} allocation(s) re-priced, "
                  f"budget-feasible, throughput claim re-derived{extra}")
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
