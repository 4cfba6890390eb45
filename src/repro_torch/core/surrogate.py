"""Surrogate-guided frugal characterization (Fig. 11, beyond 14.6x).

The paper's headline is invocation frugality: Algorithm 1 spends 14.6x
fewer HLS-tool invocations than exhaustive search on the WAMI zoo.
This module pushes further in the style of Ferretti et al.'s graph-DL
HLS-DSE proposal loop (PAPERS.md): a cheap model *proposes* likely-
Pareto knob points, and only the proposals are *confirmed* through the
real oracle.

Two cooperating pieces:

* :class:`RidgeSurrogate` — a lightweight TMG-feature ridge regression
  over per-component CDFG facts + knob coordinates, fitted online from
  the ledger's :class:`~repro_torch.core.oracle.InvocationRecord` stream (no
  extra oracle traffic).  It ranks candidate Pareto corners; before any
  records exist it defers to the grid's own latency ordering.  The
  session fits it only at characterize-phase boundaries — every
  component ranks against the same phase-start state, so the guided
  ledger books are identical at any worker count; a surrogate reused
  across sessions (the service's pools, or ``build_session(surrogate=)``)
  carries the previous run's fit into the next ranking.
* :func:`guided_characterize_component` — runs the full Algorithm-1
  corner walk against a :class:`~repro_torch.core.pricing.BatchPricer` grid
  (zero real invocations), then confirms the surrogate's top-ranked
  corner through the real ledger.  The confirmation is compared
  field-for-field against the grid's prediction; **any** mismatch
  discards the guided walk and re-runs the component through the real
  oracle unguided.

The fall-back guarantee this buys: the emitted regions/points — and
therefore the plan and the mapped Pareto front — are byte-identical to
the unguided walk, while the ledger's characterize-phase spend drops
from the full corner walk to one confirmation per component (the map
phase still pays real invocations for every mapped point, exactly as
before).  A poisoned surrogate can only change *which* corner is
confirmed, never the emitted front; a poisoned grid is caught by the
confirmation mismatch and costs one wasted invocation plus the normal
unguided walk.  ``tests/test_torch_pricing.py`` pins the grid's
bit-exactness; ``tests/test_torch_surrogate.py`` pins the byte-identity
and the invocation spend.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from .characterize import CharacterizationResult, characterize_component
from .knobs import CDFGFacts, KnobSpace, Region, Synthesis
from .oracle import InvocationRecord, InvocationRequest, OracleLedger
from .pricing import BatchPricer

__all__ = ["RidgeSurrogate", "GuidedCharacterization",
           "guided_characterize_component"]


class _GridWalk:
    """Ledger-shaped facade over a :class:`BatchPricer`.

    ``characterize_component`` duck-types its ``tool`` — it only calls
    ``synthesize``/``cdfg_facts``/``total``/``failed.get`` — so the
    whole Algorithm-1 corner walk runs unchanged against the grid, with
    local counters standing in for the ledger's accounting.  Nothing
    here touches the real oracle.
    """

    def __init__(self, pricer: BatchPricer):
        self._pricer = pricer
        self._total: Dict[str, int] = {}
        self.failed: Dict[str, int] = {}

    def synthesize(self, component: str, **kw: Any) -> Synthesis:
        self._total[component] = self._total.get(component, 0) + 1
        if not kw.get("tile", 1):
            # mirror call_synthesize: a falsy tile is not forwarded, so
            # tools without a tile axis (XLATool) answer exactly as they
            # would under the real ledger
            kw.pop("tile")
        out = self._pricer.synthesize(component, **kw)
        if not out.feasible:
            self.failed[component] = self.failed.get(component, 0) + 1
        return out

    def cdfg_facts(self, component: str, synth: Synthesis) -> CDFGFacts:
        return self._pricer.cdfg_facts(component, synth)

    def total(self, component: str) -> int:
        return self._total.get(component, 0)


class RidgeSurrogate:
    """Ridge regression on ``log(lam)`` over CDFG facts + knob coords.

    Feature vector per priced point: ``[1, log2 u, log2 p, u/p,
    gamma_r, gamma_w, eta, log2(trip+1), tile]`` with the facts taken
    from the component's characterized lower-right corner (the paper's
    Eq. (1) inputs).  Fitting is a closed-form normal-equations solve —
    cheap enough to re-fit at every phase boundary.  Thread-safe: the
    session's characterize phase fans components out over a pool.
    """

    N_FEATURES = 9

    def __init__(self, l2: float = 1e-6):
        self.l2 = float(l2)
        self._w: Optional[np.ndarray] = None
        self._facts: Dict[str, CDFGFacts] = {}
        self._lock = threading.Lock()

    # -- facts registry ------------------------------------------------
    def observe_facts(self, component: str, facts: CDFGFacts) -> None:
        with self._lock:
            self._facts[component] = facts

    def features(self, component: str, unrolls: int, ports: int,
                 tile: int) -> List[float]:
        f = self._facts.get(component)
        gamma_r = float(f.gamma_r) if f else 0.0
        gamma_w = float(f.gamma_w) if f else 0.0
        eta = float(f.eta) if f else 0.0
        trip = float(f.trip) if f else 0.0
        return [1.0, math.log2(unrolls), math.log2(ports),
                unrolls / ports, gamma_r, gamma_w, eta,
                math.log2(trip + 1.0), float(tile)]

    # -- fit / predict ---------------------------------------------------
    @property
    def fitted(self) -> bool:
        return self._w is not None

    def fit(self, records: Iterable[InvocationRecord]) -> bool:
        """Fit from the ledger's record stream; returns True when there
        is enough signal (more usable rows than features).  Records are
        sorted into a canonical order first so the solved weights are
        independent of arrival order (a fanned-out characterize phase
        appends records in thread-completion order)."""
        usable = sorted(
            (r for r in records
             if r.feasible and math.isfinite(r.lam) and r.lam > 0),
            key=lambda r: (r.component, r.unrolls, r.ports, r.tile,
                           r.lam))
        rows: List[List[float]] = []
        targets: List[float] = []
        for r in usable:
            rows.append(self.features(r.component, r.unrolls, r.ports,
                                      r.tile))
            targets.append(math.log(r.lam))
        if len(rows) <= self.N_FEATURES:
            return False
        X = np.asarray(rows)
        y = np.asarray(targets)
        gram = X.T @ X + self.l2 * np.eye(X.shape[1])
        w = np.linalg.solve(gram, X.T @ y)
        with self._lock:
            self._w = w
        return True

    def predict(self, component: str, unrolls: int, ports: int,
                tile: int) -> float:
        """Predicted ``log(lam)``; raises before the first ``fit``."""
        with self._lock:
            w = self._w
        if w is None:
            raise RuntimeError("surrogate is not fitted")
        x = np.asarray(self.features(component, unrolls, ports, tile))
        return float(x @ w)


@dataclass(frozen=True)
class _Candidate:
    """One confirmable Pareto corner of a kept region."""

    region: Region
    request: InvocationRequest
    grid_lam: float


@dataclass
class GuidedCharacterization:
    """Outcome of one guided component run.

    ``result`` is what an unguided :func:`characterize_component` would
    have returned (same regions/points; ``invocations``/``failed`` are
    the *real-ledger* per-run deltas, so Fig. 11 accounting reads real
    money spent).  ``confirmed`` counts oracle confirmations paid;
    ``fell_back`` records that a grid/oracle mismatch forced the full
    unguided walk; ``grid_invocations`` is what the walk would have
    cost without the grid (the frugality numerator).
    """

    result: CharacterizationResult
    confirmed: int
    fell_back: bool
    grid_invocations: int


def _corner_request(component: str, region: Region) -> InvocationRequest:
    """The region's upper-left corner as the oracle request the walk
    made for it (Algorithm 1 lines 4-7: the Eq. (1) cap applies only to
    a real ladder step on a PLM-accessing loop)."""
    if region.mu_max > region.mu_min and region.facts.has_plm_access:
        cap = region.facts.h(region.mu_max, region.ports)
    else:
        cap = None
    return InvocationRequest(component=component, unrolls=region.mu_max,
                             ports=region.ports, max_states=cap,
                             tile=region.tile)


def _rank(component: str, candidates: List[_Candidate],
          surrogate: Optional[RidgeSurrogate]) -> List[_Candidate]:
    """Most-likely-Pareto first: surrogate order once fitted, the
    grid's own latency order before that (and for ties)."""
    if surrogate is not None and surrogate.fitted:
        return sorted(candidates, key=lambda c: (
            surrogate.predict(component, c.request.unrolls,
                              c.request.ports, c.request.tile),
            c.grid_lam))
    return sorted(candidates, key=lambda c: c.grid_lam)


def guided_characterize_component(
        ledger: OracleLedger, component: str, space: KnobSpace, *,
        pricer: BatchPricer,
        surrogate: Optional[RidgeSurrogate] = None,
        confirmations: int = 1,
        neighbourhood: int = 2,
        prune_dominated_regions: bool = True,
        refit: bool = True) -> GuidedCharacterization:
    """Algorithm 1 with grid pricing + oracle confirmation (module doc).

    ``confirmations`` bounds how many top-ranked corners are confirmed
    through the real oracle (at least one; a degenerate characterization
    with no kept regions confirms nothing and spends nothing).
    ``refit=False`` skips the end-of-run surrogate refit — the session's
    fanned-out characterize phase passes it so every component ranks
    against the same phase-start surrogate state (the guided ledger
    books stay worker-count invariant) and refits once at phase end.
    """
    total_before = ledger.total(component)
    failed_before = ledger.failed.get(component, 0)

    walk = _GridWalk(pricer)
    grid_res = characterize_component(
        walk, component, space, neighbourhood=neighbourhood,
        prune_dominated_regions=prune_dominated_regions)

    if surrogate is not None and grid_res.regions:
        # Eq. (1) inputs for the feature vector: the component's facts
        # as observed on its (grid-priced) lower-right corners
        surrogate.observe_facts(component, grid_res.regions[0].facts)

    candidates = [
        _Candidate(region=r, request=_corner_request(component, r),
                   grid_lam=r.lam_min)
        for r in grid_res.regions]
    ranked = _rank(component, candidates, surrogate)

    fell_back = False
    confirmed = 0
    for cand in ranked[:max(0, confirmations)]:
        req = cand.request
        expected = pricer.synthesize(
            component, unrolls=req.unrolls, ports=req.ports,
            max_states=req.max_states,
            **({"tile": req.tile} if req.tile else {}))
        actual = ledger.evaluate(req)
        confirmed += 1
        if actual != expected:
            fell_back = True
            break

    if fell_back:
        # trust nothing from the grid: re-run the whole component
        # through the real oracle; every invocation is counted, and the
        # emitted regions/points are the unguided walk's by definition
        real = characterize_component(
            ledger, component, space, neighbourhood=neighbourhood,
            prune_dominated_regions=prune_dominated_regions)
        regions, points = real.regions, real.points
    else:
        regions, points = grid_res.regions, grid_res.points

    if surrogate is not None and refit:
        # online refit from everything the ledger has actually paid for
        # (confirmations included) — the next run ranks better
        surrogate.fit(ledger.records)

    result = CharacterizationResult(
        component=component, regions=regions, points=points,
        invocations=ledger.total(component) - total_before,
        failed=ledger.failed.get(component, 0) - failed_before)
    return GuidedCharacterization(
        result=result, confirmed=confirmed, fell_back=fell_back,
        grid_invocations=walk.total(component))
