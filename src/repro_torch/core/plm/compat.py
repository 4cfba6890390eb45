"""Memory compatibility: which components may share a PLM, and why.

Two components can share physical memory banks only if they never
execute concurrently.  The repo certifies that in two tiers:

**Tier 1 — structural.**  For a timed marked graph the token count of
every directed cycle is an invariant of the firing rule, and a
transition holds its cycle's tokens for the whole firing (it consumes
from the cycle at start and produces back at end).  Hence

    **every pair of distinct transitions on a common cycle whose total
    initial marking is exactly one token is mutually exclusive** —
    while one fires the cycle holds zero free tokens, so the other
    cannot start.

This holds for *every* admissible execution.  On the WAMI TMG (Fig. 8)
it certifies precisely the Lucas-Kanade refinement loop:
``alg:matrix_resh->warp`` carries one token and the forward edges carry
none, so warp, matrix_sub, sd_update, matrix_mul, matrix_add and
matrix_resh serialize per LK iteration and their PLMs may be one shared
multi-bank memory.

**Tier 2 — schedule-conditional.**  Streaming neighbours connected
through multi-token ping-pong channels (debayer/grayscale, ...) are
structurally concurrent, but the LP of Eq. (2) solves for initiation
times sigma that pin down exactly *when* each transition is busy.  When
two busy intervals ``[sigma_i, sigma_i + tau_i) mod period`` do not
overlap, the pair is non-concurrent *under that schedule* —
:mod:`repro_torch.core.analysis.intervals` derives these certificates and
:class:`CompatSource` carries both tiers to the planner, tagged with
the schedule they hold under.

The sharing model assumes a stage's PLM holds live data only during its
own load-compute-store window (Fig. 3) — contents are handed over via
TLM channels, not retained between firings — which is the same
assumption Mnemosyne's "address-space compatibility" sharing makes.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ..tmg import TMG

__all__ = ["exclusive_pairs", "CompatSource", "MemoryCompatGraph"]

Pair = FrozenSet[str]

# per-TMG caches: the structural certificate is a pure function of the
# marking, so one exploration (hundreds of mapped design points over one
# TMG) computes it exactly once.  Keyed weakly so throwaway test graphs
# do not accumulate.
_PAIRS_CACHE: "weakref.WeakKeyDictionary[TMG, FrozenSet[Pair]]" = (
    weakref.WeakKeyDictionary())
_GRAPH_CACHE: "weakref.WeakKeyDictionary[TMG, MemoryCompatGraph]" = (
    weakref.WeakKeyDictionary())


def exclusive_pairs(tmg: TMG) -> FrozenSet[Pair]:
    """All unordered transition pairs certified mutually exclusive by a
    one-token cycle.  Deterministic: derived purely from the marking.
    Cached per TMG (the docstring's build-once promise, made true)."""
    cached = _PAIRS_CACHE.get(tmg)
    if cached is not None:
        return cached
    pairs: Set[Pair] = set()
    for cyc in tmg.simple_cycles():
        if sum(p.tokens for p in cyc) != 1:
            continue
        names = sorted({p.src for p in cyc})
        for i, u in enumerate(names):
            for v in names[i + 1:]:
                pairs.add(frozenset((u, v)))
    out = frozenset(pairs)
    _PAIRS_CACHE[tmg] = out
    return out


@dataclass(frozen=True)
class CompatSource:
    """The two-tier non-concurrency certificate set the planner consumes.

    ``structural`` pairs hold for every admissible execution of the TMG;
    ``conditional`` pairs hold only under the schedule identified by
    ``tag`` (a :meth:`repro_torch.core.planning.Schedule.tag`).  ``tier``
    answers *why* a pair may share: ``"structural"``, ``"schedule"`` or
    ``None``.
    """

    structural: FrozenSet[Pair]
    conditional: FrozenSet[Pair] = frozenset()
    tag: Optional[str] = None

    def __post_init__(self):
        allp = frozenset(self.structural) | frozenset(self.conditional)
        object.__setattr__(self, "_all", allp)

    @property
    def pairs(self) -> FrozenSet[Pair]:
        return self._all          # type: ignore[attr-defined]

    def may_share(self, u: str, v: str) -> bool:
        return u != v and frozenset((u, v)) in self.pairs

    def tier(self, u: str, v: str) -> Optional[str]:
        key = frozenset((u, v))
        if u == v:
            return None
        if key in self.structural:
            return "structural"
        if key in self.conditional:
            return "schedule"
        return None

    def cliques_containing(self, members: Tuple[str, ...], cand: str) -> bool:
        """True when ``cand`` is pairwise-compatible with every member."""
        return all(self.may_share(m, cand) for m in members)

    @staticmethod
    def structural_for(tmg: TMG) -> "CompatSource":
        return CompatSource(structural=exclusive_pairs(tmg))

    def with_conditional(self, pairs: FrozenSet[Pair],
                         tag: Optional[str]) -> "CompatSource":
        """The same structural tier plus a schedule-conditional tier."""
        return CompatSource(structural=self.structural,
                            conditional=frozenset(pairs) - self.structural,
                            tag=tag)


class MemoryCompatGraph:
    """Adjacency view over :func:`exclusive_pairs` for the planner.

    ``may_share(u, v)`` is True when the TMG certifies u and v never
    overlap in time.  The graph is static per TMG — built once and
    cached (:meth:`for_tmg`), then reused across every mapped design
    point.
    """

    def __init__(self, tmg: TMG):
        self.names: List[str] = [t.name for t in tmg.transitions]
        self._adj: Dict[str, Set[str]] = {n: set() for n in self.names}
        for pair in exclusive_pairs(tmg):
            u, v = sorted(pair)
            self._adj[u].add(v)
            self._adj[v].add(u)

    @classmethod
    def for_tmg(cls, tmg: TMG) -> "MemoryCompatGraph":
        """The cached structural graph for ``tmg`` (built on first use)."""
        g = _GRAPH_CACHE.get(tmg)
        if g is None:
            g = cls(tmg)
            _GRAPH_CACHE[tmg] = g
        return g

    def as_source(self) -> CompatSource:
        """This graph's certificates as a (structural-only) CompatSource."""
        pairs = {frozenset((u, v))
                 for u, vs in self._adj.items() for v in vs}
        return CompatSource(structural=frozenset(pairs))

    def may_share(self, u: str, v: str) -> bool:
        return u != v and v in self._adj.get(u, ())

    def neighbours(self, u: str) -> Tuple[str, ...]:
        return tuple(sorted(self._adj.get(u, ())))

    def cliques_containing(self, members: Tuple[str, ...], cand: str) -> bool:
        """True when ``cand`` is pairwise-compatible with every member."""
        return all(self.may_share(m, cand) for m in members)
