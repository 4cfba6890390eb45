"""Busy-interval analysis of LP schedules → non-concurrency certificates.

The Eq. (2) LP (:mod:`repro_torch.core.planning`) solves for transition
initiation times sigma and firing delays tau at a target throughput
theta.  Under the resulting periodic schedule, firing k of transition i
occupies the busy interval

    [sigma_i + k/theta,  sigma_i + tau_i + k/theta)

so on the circle of circumference ``period = 1/theta`` transition i is
busy exactly on ``[sigma_i mod period, sigma_i + tau_i mod period)``.
Every TMG here carries a one-token self place per transition, which
forces ``tau_i <= period`` — a busy interval wraps the circle at most
once, and two transitions execute concurrently at some instant iff
their circular intervals overlap.

Pairs whose intervals are disjoint (with a conservative tolerance:
touching counts as overlap) are certified non-concurrent *under that
schedule*.  These are strictly weaker guarantees than the structural
one-token-cycle certificates of :mod:`repro_torch.core.plm.compat` —
they hold only while the system runs the tagged schedule — and strictly
richer: on WAMI they certify dozens of pairs beyond the six-component
LK clique.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional, Tuple

from ..planning import Schedule
from ..plm.compat import CompatSource, exclusive_pairs
from ..tmg import TMG

__all__ = [
    "BusyInterval",
    "ScheduleCertificate",
    "busy_intervals",
    "intervals_overlap",
    "schedule_exclusive_pairs",
    "compat_source_for",
]

Pair = FrozenSet[str]

# relative tolerance (fraction of the period) below which two intervals
# are treated as touching — i.e. NOT certified disjoint.  Conservative:
# widening it can only drop certificates, never admit a race.
_REL_TOL = 1e-9


@dataclass(frozen=True)
class BusyInterval:
    """One transition's busy window on the schedule circle.

    ``start`` is normalized into ``[0, period)``; ``length`` is the
    planned firing delay tau (``length <= period`` for any schedule of a
    TMG with one-token self places).
    """

    name: str
    start: float
    length: float

    @property
    def end(self) -> float:
        return self.start + self.length


def busy_intervals(schedule: Schedule) -> Dict[str, BusyInterval]:
    """Every transition's busy interval, starts normalized mod period."""
    period = schedule.period
    out: Dict[str, BusyInterval] = {}
    for name, sigma in schedule.sigma.items():
        out[name] = BusyInterval(name=name, start=sigma % period,
                                 length=float(schedule.tau[name]))
    return out


def intervals_overlap(a: BusyInterval, b: BusyInterval, period: float,
                      tol: Optional[float] = None) -> bool:
    """Do the two circular intervals intersect (within tolerance)?

    Checked by unrolling b one period to each side: with both lengths
    <= period, an intersection on the circle implies a linear
    intersection at one of the three shifts.  ``tol`` > 0 makes the
    test conservative — intervals closer than ``tol`` count as
    overlapping, so a certificate always has real slack behind it.
    """
    if tol is None:
        tol = _REL_TOL * period
    if a.length >= period - tol or b.length >= period - tol:
        return True       # a full-period firing overlaps everything
    for k in (-1.0, 0.0, 1.0):
        if a.start < b.end + k * period + tol and \
                b.start + k * period < a.end + tol:
            return True
    return False


@dataclass(frozen=True)
class ScheduleCertificate:
    """Non-concurrency pairs certified by one LP schedule.

    ``pairs`` holds under the schedule identified by ``tag`` only — the
    planner and the verifier must carry the tag with any sharing
    decision derived from it (a different schedule, or a mapped design
    point run free-running instead of at the planned initiation times,
    voids the certificate).
    """

    tag: str
    theta: float
    pairs: FrozenSet[Pair]
    intervals: Tuple[BusyInterval, ...]

    def certifies(self, u: str, v: str) -> bool:
        return u != v and frozenset((u, v)) in self.pairs


def schedule_exclusive_pairs(schedule: Schedule,
                             tol: Optional[float] = None
                             ) -> ScheduleCertificate:
    """All unordered pairs whose busy intervals are disjoint mod period.

    Deterministic: a pure function of (sigma, tau, theta).  O(n^2) over
    the transitions — negligible next to one oracle invocation.
    """
    period = schedule.period
    ivs = busy_intervals(schedule)
    names = sorted(ivs)
    pairs = set()
    for i, u in enumerate(names):
        for v in names[i + 1:]:
            if not intervals_overlap(ivs[u], ivs[v], period, tol):
                pairs.add(frozenset((u, v)))
    return ScheduleCertificate(tag=schedule.tag(), theta=schedule.theta,
                               pairs=frozenset(pairs),
                               intervals=tuple(ivs[n] for n in names))


def compat_source_for(tmg: TMG, schedule: Optional[Schedule] = None
                      ) -> CompatSource:
    """The two-tier compatibility source for a TMG and (optionally) one
    of its LP schedules: structural one-token-cycle pairs plus the
    schedule-conditional busy-interval pairs, tagged."""
    base = CompatSource(structural=exclusive_pairs(tmg))
    if schedule is None:
        return base
    cert = schedule_exclusive_pairs(schedule)
    names = {t.name for t in tmg.transitions}
    missing = names - set(schedule.sigma)
    if missing:
        raise ValueError(f"schedule covers no initiation time for "
                         f"{sorted(missing)}")
    return base.with_conditional(cert.pairs, cert.tag)
