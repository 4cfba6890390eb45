"""Synthesis planning — the theta-constrained cost-minimization LP (Eq. 2).

    min   sum_i f_i(tau_i)
    s.t.  A sigma + M0/theta >= tau^-          (one row per place)
          lam_min_i <= tau_i <= lam_max_i

where A is the TMG incidence matrix (Eq. 3), M0 the initial marking,
sigma the transition initiation times and tau^-_i the firing delay of the
transition feeding place i.  The cost functions f_i are unknown a-priori
and are approximated with convex piecewise-linear functions built from
the region corners produced by Algorithm 1 (Section 6.1) — implemented
here as the lower convex envelope of the corner points, entering the LP
through epigraph variables.

The LP is solved with scipy's HiGHS when available and with a small
self-contained dense simplex otherwise, so the package runs with only
numpy installed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .knobs import Region
from .tmg import TMG

__all__ = [
    "PiecewiseLinearCost",
    "ComponentModel",
    "Schedule",
    "PlanPoint",
    "theta_bounds",
    "plan",
    "sweep",
]


# ----------------------------------------------------------------------
# Convex piecewise-linear cost approximation
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class PiecewiseLinearCost:
    """f(tau) = max_k (a_k * tau + b_k): convex, decreasing in latency.

    Built as the lower convex envelope of the characterized (lambda,
    alpha) corner points, which is the tightest convex under-approximation
    available from Algorithm 1's output.
    """

    slopes: Tuple[float, ...]
    intercepts: Tuple[float, ...]

    def __call__(self, tau: float) -> float:
        return max(a * tau + b for a, b in zip(self.slopes, self.intercepts))

    @staticmethod
    def from_points(points: Sequence[Tuple[float, float]]) -> "PiecewiseLinearCost":
        """Lower convex hull (Andrew monotone chain, lower part) of
        (lambda, alpha) points -> segment slopes/intercepts."""
        pts = sorted(set(points))
        if not pts:
            raise ValueError("no points")
        if len(pts) == 1:
            (x, y), = pts
            return PiecewiseLinearCost(slopes=(0.0,), intercepts=(y,))
        hull: List[Tuple[float, float]] = []
        for p in pts:
            while len(hull) >= 2:
                (x1, y1), (x2, y2) = hull[-2], hull[-1]
                # drop hull[-1] if it lies above segment hull[-2]->p
                if (y2 - y1) * (p[0] - x1) >= (p[1] - y1) * (x2 - x1):
                    hull.pop()
                else:
                    break
            hull.append(p)
        slopes, intercepts = [], []
        for (x1, y1), (x2, y2) in zip(hull, hull[1:]):
            if x2 == x1:
                continue
            a = (y2 - y1) / (x2 - x1)
            slopes.append(a)
            intercepts.append(y1 - a * x1)
        if not slopes:  # all points at the same lambda
            ymin = min(y for _, y in pts)
            slopes, intercepts = [0.0], [ymin]
        return PiecewiseLinearCost(slopes=tuple(slopes), intercepts=tuple(intercepts))


@dataclass(frozen=True)
class ComponentModel:
    """What the planner knows about one transition after characterization."""

    name: str
    lam_min: float
    lam_max: float
    cost: PiecewiseLinearCost
    fixed: bool = False          # e.g. Matrix-Inv runs in software (Fig. 8)

    @staticmethod
    def from_regions(name: str, regions: Sequence[Region]) -> "ComponentModel":
        pts: List[Tuple[float, float]] = []
        for r in regions:
            pts.append((r.lam_max, r.area_min))
            pts.append((r.lam_min, r.area_max))
        return ComponentModel(
            name=name,
            lam_min=min(r.lam_min for r in regions),
            lam_max=max(r.lam_max for r in regions),
            cost=PiecewiseLinearCost.from_points(pts),
        )

    @staticmethod
    def fixed_latency(name: str, lam: float, area: float = 0.0) -> "ComponentModel":
        return ComponentModel(name=name, lam_min=lam, lam_max=lam,
                              cost=PiecewiseLinearCost((0.0,), (area,)),
                              fixed=True)


@dataclass(frozen=True)
class Schedule:
    """The periodic schedule the LP solved for: firing k of transition i
    starts at ``sigma[i] + k * period`` and holds its resources for
    ``tau[i]``.  Admissibility is exactly the Eq. (2) place constraints,
    so a returned Schedule is always a feasible steady-state execution
    of the TMG at throughput ``theta``.

    Busy intervals ``[sigma_i, sigma_i + tau_i) mod period`` are what
    schedule-conditional non-concurrency certificates are built from.
    """

    theta: float
    sigma: Dict[str, float]           # transition initiation offsets (s)
    tau: Dict[str, float]             # planned firing delays (s)

    @property
    def period(self) -> float:
        return 1.0 / self.theta

    def tag(self) -> str:
        """A short stable identifier of the design point this schedule
        (and any certificate derived from it) holds under."""
        return f"theta={self.theta:.9g}"

    def to_json(self) -> Dict[str, object]:
        return {"theta": self.theta, "sigma": dict(self.sigma),
                "tau": dict(self.tau)}

    @staticmethod
    def from_json(d: Dict[str, object]) -> "Schedule":
        return Schedule(theta=float(d["theta"]),
                        sigma={k: float(v) for k, v in d["sigma"].items()},
                        tau={k: float(v) for k, v in d["tau"].items()})


@dataclass(frozen=True)
class PlanPoint:
    """One LP solution along the theta sweep (a 'planned point', Fig. 10)."""

    theta: float
    cost: float                       # sum_i f_i(tau_i): theoretical area
    lam_targets: Dict[str, float]     # per-component latency requirements
    schedule: Optional[Schedule] = None   # the solved sigma/tau behind it


# ----------------------------------------------------------------------
# Bounds
# ----------------------------------------------------------------------
def theta_bounds(tmg: TMG, models: Dict[str, ComponentModel]) -> Tuple[float, float]:
    """theta_min from all-slowest corners, theta_max from all-fastest
    (Section 6.1: 'it is possible to determine theta_min and theta_max by
    labeling the transitions of the TMG with such latencies')."""
    slow = {n: m.lam_max for n, m in models.items()}
    fast = {n: m.lam_min for n, m in models.items()}
    return tmg.throughput(slow), tmg.throughput(fast)


# ----------------------------------------------------------------------
# LP assembly + solve
# ----------------------------------------------------------------------
def _solve_lp(c, A_ub, b_ub, bounds):
    try:
        from scipy.optimize import linprog
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
        if not res.success:
            return None
        return np.asarray(res.x)
    except ImportError:  # pragma: no cover - exercised via _simplex tests
        return _simplex(c, A_ub, b_ub, bounds)


def _simplex(c, A_ub, b_ub, bounds):
    """Dependency-free fallback: convert to standard form and run a dense
    big-M simplex with Bland's rule.  Small problems only (n, m < ~200)."""
    c = np.asarray(c, dtype=float)
    A = np.asarray(A_ub, dtype=float)
    b = np.asarray(b_ub, dtype=float)
    n = c.size
    # shift variables to x' = x - lo >= 0; handle free vars via splitting
    shift = np.zeros(n)
    split = []
    for j, (lo, hi) in enumerate(bounds):
        if lo is None:
            split.append(j)
        else:
            shift[j] = lo
    b = b - A @ shift
    ub_rows, ub_rhs = [], []
    for j, (lo, hi) in enumerate(bounds):
        if hi is not None:
            row = np.zeros(n)
            row[j] = 1.0
            ub_rows.append(row)
            ub_rhs.append(hi - shift[j])
    if ub_rows:
        A = np.vstack([A] + [r[None, :] for r in ub_rows])
        b = np.concatenate([b, np.asarray(ub_rhs)])
    # split free variables x_j = u_j - v_j
    if split:
        A = np.hstack([A, -A[:, split]])
        c = np.concatenate([c, -c[split]])
        n = c.size
    m = A.shape[0]
    # slack + artificial (big-M) for negative rhs rows
    T = np.hstack([A, np.eye(m)])
    cc = np.concatenate([c, np.zeros(m)])
    basis = list(range(n, n + m))
    bigM = 1e9
    for i in range(m):
        if b[i] < 0:
            T[i, :] *= -1.0
            b = b.copy()
            b[i] *= -1.0
            art = np.zeros((m, 1)); art[i, 0] = 1.0
            T = np.hstack([T, art])
            cc = np.concatenate([cc, [bigM]])
            basis[i] = T.shape[1] - 1
    # simplex iterations
    for _ in range(20000):
        y = np.linalg.solve(T[:, basis].T, cc[basis])
        red = cc - y @ T
        enter = next((j for j in range(T.shape[1]) if red[j] < -1e-9), None)
        if enter is None:
            break
        d = np.linalg.solve(T[:, basis], T[:, enter])
        ratios = [(b_i / d_i, i) for i, (b_i, d_i) in
                  enumerate(zip(np.linalg.solve(T[:, basis], b), d)) if d_i > 1e-12]
        if not ratios:
            return None  # unbounded
        _, leave = min(ratios)
        basis[leave] = enter
    xb = np.linalg.solve(T[:, basis], b)
    x_full = np.zeros(T.shape[1])
    x_full[basis] = xb
    x = x_full[:n]
    if split:
        base = x[: n - len(split)].copy()
        for k, j in enumerate(split):
            base[j] = base[j] - x[n - len(split) + k]
        x = base
    return x + shift


def plan(tmg: TMG, models: Dict[str, ComponentModel], theta: float
         ) -> Optional[PlanPoint]:
    """Solve Eq. (2) for a single target throughput theta."""
    names = [t.name for t in tmg.transitions]
    for nme in names:
        if nme not in models:
            raise KeyError(f"no model for transition {nme}")
    n = len(names)
    A = tmg.incidence_matrix()          # m x n
    B = tmg.input_delay_selector()      # m x n
    M0 = tmg.initial_marking()
    m = A.shape[0]

    # variable layout: [sigma (n), tau (n), epigraph c (n)]
    nv = 3 * n
    rows: List[np.ndarray] = []
    rhs: List[float] = []

    # place rows:  -(A sigma - B tau) <= M0/theta
    for i in range(m):
        row = np.zeros(nv)
        row[0:n] = -A[i]
        row[n:2 * n] = B[i]
        rows.append(row)
        rhs.append(M0[i] / theta)

    # epigraph rows: a_k tau_i - c_i <= -b_k
    for i, nme in enumerate(names):
        mdl = models[nme]
        for a, bb in zip(mdl.cost.slopes, mdl.cost.intercepts):
            row = np.zeros(nv)
            row[n + i] = a
            row[2 * n + i] = -1.0
            rows.append(row)
            rhs.append(-bb)

    A_ub = np.vstack(rows)
    b_ub = np.asarray(rhs)

    bounds: List[Tuple[Optional[float], Optional[float]]] = []
    bounds += [(None, None)] * n                      # sigma free
    for nme in names:                                  # tau bounded
        mdl = models[nme]
        bounds.append((mdl.lam_min, mdl.lam_max))
    bounds += [(None, None)] * n                      # c free (epigraph)
    # pin sigma_0 (initiation times are translation-invariant)
    bounds[0] = (0.0, 0.0)

    c = np.zeros(nv)
    c[2 * n:] = 1.0

    x = _solve_lp(c, A_ub, b_ub, bounds)
    if x is None:
        return None
    sigma = {nme: float(x[i]) for i, nme in enumerate(names)}
    tau = {nme: float(x[n + i]) for i, nme in enumerate(names)}
    cost = float(sum(models[nme].cost(tau[nme]) for nme in names))
    return PlanPoint(theta=theta, cost=cost, lam_targets=tau,
                     schedule=Schedule(theta=theta, sigma=sigma, tau=tau))


def sweep(tmg: TMG, models: Dict[str, ComponentModel], delta: float,
          theta_min: Optional[float] = None, theta_max: Optional[float] = None
          ) -> List[PlanPoint]:
    """Problem 1 sweep: iterate theta from theta_min to theta_max with a
    ratio of (1 + delta) (Section 6.1), solving Eq. (2) at each step."""
    lo, hi = theta_bounds(tmg, models)
    theta_min = lo if theta_min is None else theta_min
    theta_max = hi if theta_max is None else theta_max
    out: List[PlanPoint] = []
    theta = theta_min
    while theta < theta_max * (1.0 + 1e-9):
        pt = plan(tmg, models, theta)
        if pt is not None:
            out.append(pt)
        theta *= (1.0 + delta)
    # always include the extreme
    if not out or abs(out[-1].theta - theta_max) / theta_max > 1e-9:
        pt = plan(tmg, models, theta_max)
        if pt is not None:
            out.append(pt)
    return out
