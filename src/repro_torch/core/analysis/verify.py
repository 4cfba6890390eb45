"""Independent race detector for emitted PLM plans.

The planner (:mod:`repro_torch.core.plm.planner`) *constructs* shared-bank
groups from non-concurrency certificates; this module *re-proves* them
from scratch, trusting nothing but the plan itself, the TMG, and the
schedule the plan conditions on.  Every multi-member group of a
:class:`~repro_torch.core.plm.spec.MemoryPlan` must be

* **race-free** (rule ``V-RACE``): each member pair certified
  non-concurrent — structurally (one-token cycle) or by the schedule's
  busy intervals; a plan whose ``compat_tag`` names a schedule is only
  checked against a schedule with the *same* tag (``V-TAG``);
* **capacity-feasible** (``V-CAP``): the shared envelope covers every
  member requirement (capacity, word width, ports), members share one
  unit, and no unsplittable (capacity-0) requirement was merged;
* **honestly priced** (``V-AREA``): the group's recorded area matches
  an independent re-derivation through ``shared_area`` (multi-member)
  or the private PLM price (singleton);
* **dominance-guarded** (``V-GUARD``): the shared area never exceeds
  the private per-component sum the group replaces.

``python -m repro_torch.core.analysis.verify [dir|file ...]`` verifies
plan artifacts (``*.plans.json``: the app's name and, per point, its
plan and schedule); with no arguments it scans
``artifacts/bench_torch/fig10``.  Exit status is the number of violated
plans (0 = everything proved).
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

from ..memgen import MemGen
from ..planning import Schedule
from ..plm.compat import exclusive_pairs
from ..plm.spec import MemoryPlan, memory_plan_from_json
from ..tmg import TMG
from .intervals import schedule_exclusive_pairs

__all__ = ["Violation", "PlanVerificationError", "verify_plan",
           "assert_plan_sound", "verify_plans_file", "main"]

_REL_TOL = 1e-9


@dataclass(frozen=True)
class Violation:
    """One failed proof obligation of a memory plan."""

    rule: str                     # V-RACE | V-TAG | V-CAP | V-AREA | V-GUARD
    group: Tuple[str, ...]
    detail: str

    def __str__(self) -> str:
        return f"{self.rule} [{'+'.join(self.group)}]: {self.detail}"


class PlanVerificationError(AssertionError):
    """Raised by :func:`assert_plan_sound` — an emitted plan failed
    independent re-verification."""

    def __init__(self, violations: Sequence[Violation]):
        self.violations = tuple(violations)
        super().__init__("memory plan failed verification:\n  " +
                         "\n  ".join(str(v) for v in violations))


def verify_plan(plan: MemoryPlan, tmg: TMG,
                schedule: Optional[Schedule] = None, *,
                memgen: Optional[MemGen] = None) -> List[Violation]:
    """Re-prove ``plan`` sound; returns all violations ([] = proved).

    ``schedule`` supplies the conditional certificate tier.  It is only
    consulted when its tag matches the plan's ``compat_tag`` — a plan
    that conditions on schedule A is *not* proved race-free by the
    disjoint intervals of schedule B.
    """
    memgen = memgen or MemGen()
    out: List[Violation] = []
    structural = exclusive_pairs(tmg)
    known = {t.name for t in tmg.transitions}

    conditional = frozenset()
    if plan.compat_tag is not None:
        if schedule is None:
            out.append(Violation(
                "V-TAG", (),
                f"plan conditions on schedule {plan.compat_tag!r} but no "
                f"schedule was supplied for verification"))
        elif schedule.tag() != plan.compat_tag:
            out.append(Violation(
                "V-TAG", (),
                f"plan conditions on schedule {plan.compat_tag!r}; "
                f"got {schedule.tag()!r}"))
        else:
            conditional = schedule_exclusive_pairs(schedule).pairs
    certified = structural | conditional

    for g in plan.groups:
        members = tuple(g.members)
        unknown = [m for m in members if m not in known]
        if unknown:
            out.append(Violation("V-RACE", members,
                                 f"members not in the TMG: {unknown}"))
            continue
        if len(members) > 1:
            for i, u in enumerate(members):
                for v in members[i + 1:]:
                    if frozenset((u, v)) not in certified:
                        out.append(Violation(
                            "V-RACE", members,
                            f"no non-concurrency certificate for "
                            f"({u}, {v})"))
        # capacity / envelope / unit obligations need the requirements
        reqs = g.requirements
        if reqs:
            names = tuple(sorted(r.component for r in reqs))
            if names != tuple(sorted(members)):
                out.append(Violation(
                    "V-CAP", members,
                    f"requirements cover {names}, group covers "
                    f"{tuple(sorted(members))}"))
            units = {r.unit for r in reqs}
            if len(units) > 1:
                out.append(Violation("V-CAP", members,
                                     f"mixed units in one group: "
                                     f"{sorted(units)}"))
            if len(reqs) > 1:
                for r in reqs:
                    if r.capacity <= 0:
                        out.append(Violation(
                            "V-CAP", members,
                            f"unsplittable requirement {r.component} "
                            f"(capacity 0) was merged"))
                    if r.capacity > g.capacity:
                        out.append(Violation(
                            "V-CAP", members,
                            f"{r.component} needs capacity {r.capacity} "
                            f"> group envelope {g.capacity}"))
                    if r.word_bits > g.word_bits:
                        out.append(Violation(
                            "V-CAP", members,
                            f"{r.component} needs {r.word_bits}-bit words "
                            f"> group width {g.word_bits}"))
                    if r.ports > g.ports:
                        out.append(Violation(
                            "V-CAP", members,
                            f"{r.component} needs {r.ports} ports "
                            f"> group envelope {g.ports}"))
            # area re-derivation: the plan must charge what the shared
            # model (or the private price, for singletons) says
            if len(units) == 1:
                if len(reqs) == 1:
                    expect = reqs[0].area_plm
                else:
                    from ..plm.planner import shared_area
                    expect = shared_area(
                        sorted(reqs, key=lambda r: r.component), memgen)[0]
                if abs(g.area - expect) > _REL_TOL * max(1.0, expect):
                    out.append(Violation(
                        "V-AREA", members,
                        f"recorded area {g.area!r} != re-derived "
                        f"{expect!r}"))
        if g.area > g.area_private + _REL_TOL * max(1.0, g.area_private):
            out.append(Violation(
                "V-GUARD", members,
                f"shared area {g.area!r} exceeds private sum "
                f"{g.area_private!r}"))
    return out


def assert_plan_sound(plan: MemoryPlan, tmg: TMG,
                      schedule: Optional[Schedule] = None, *,
                      memgen: Optional[MemGen] = None) -> None:
    """:func:`verify_plan`, raising on the first unsound plan — the
    session's strict post-pass (``ExplorationSession(verify_plans=True)``)."""
    violations = verify_plan(plan, tmg, schedule, memgen=memgen)
    if violations:
        raise PlanVerificationError(violations)


# ----------------------------------------------------------------------
# committed-artifact verification (CLI)
# ----------------------------------------------------------------------
def verify_plans_file(path: str) -> Tuple[int, List[Violation]]:
    """Verify one committed ``*.plans.json`` artifact.

    Returns (number of plan points checked, all violations).  The file
    names its app; the TMG is rebuilt from the registry, so the proof is
    against the *current* structural model, not the one that emitted
    the plan.
    """
    with open(path) as f:
        doc = json.load(f)
    from ..registry import get_app
    tmg = get_app(doc["app"]).tmg()
    violations: List[Violation] = []
    points = doc.get("points", [])
    for pt in points:
        plan = memory_plan_from_json(pt["plan"])
        sched = pt.get("schedule")
        sched = Schedule.from_json(sched) if sched is not None else None
        for v in verify_plan(plan, tmg, sched):
            violations.append(Violation(
                v.rule, v.group,
                f"(theta={pt.get('theta_planned')}) {v.detail}"))
    return len(points), violations


def _find_plan_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(os.path.join(p, n) for n in sorted(os.listdir(p))
                       if n.endswith(".plans.json"))
        else:
            out.append(p)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis.verify",
        description="re-prove committed PLM plan artifacts race-free")
    ap.add_argument("paths", nargs="+",
                    help="*.plans.json files or directories holding them")
    args = ap.parse_args(argv)
    files = _find_plan_files(args.paths)
    if not files:
        print(f"verify: no *.plans.json under {list(args.paths)}",
              file=sys.stderr)
        return 1
    bad = 0
    for path in files:
        n, violations = verify_plans_file(path)
        if violations:
            bad += 1
            print(f"FAIL {path}: {len(violations)} violation(s) "
                  f"across {n} plan(s)")
            for v in violations:
                print(f"  {v}")
        else:
            print(f"ok   {path}: {n} plan(s) proved race-free, "
                  f"capacity-feasible, dominance-guarded")
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
