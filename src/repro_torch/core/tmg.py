"""Timed marked graphs (TMGs) — the paper's computational model (Section 2.2).

A TMG is a Petri net in which every place has exactly one input and one
output transition.  Transitions model accelerator components; their firing
delay is the component's *effective latency* lambda.  Places model TLM
channels; their initial marking (tokens) models buffering (ping-pong
buffers contribute tokens, as in Fig. 3).

The minimum cycle time of a strongly-connected TMG is

    max_k ( D_k / N_k )            for every directed cycle k,

where D_k is the sum of transition delays on the cycle and N_k the number
of tokens on the cycle (Ramamoorthy & Ho, 1980).  The maximum sustainable
effective throughput theta is its reciprocal; for non-strongly-connected
TMGs theta is the minimum over the strongly-connected components
(Section 2.2 of the paper).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Place",
    "Transition",
    "TMG",
    "pipeline_tmg",
    "feedback_pipeline_tmg",
]


@dataclass(frozen=True)
class Transition:
    """A component of the accelerator (fires with delay = effective latency)."""

    name: str


@dataclass(frozen=True)
class Place:
    """A TLM channel between two components.

    ``tokens`` is the initial marking: 1 for a plain dependency edge, >1
    when the channel is double/circular-buffered (Fig. 3), and the
    feedback edge that closes a streaming pipeline carries the number of
    in-flight frames.
    """

    name: str
    src: str
    dst: str
    tokens: int = 0


class TMG:
    """A timed marked graph over named transitions.

    The class is deliberately small and dependency-free: the WAMI graph
    has 13 transitions and the LLM-block graphs have <10, so cycle
    enumeration is cheap.  All hot paths are plain python + numpy.
    """

    def __init__(self, transitions: Sequence[Transition], places: Sequence[Place]):
        self.transitions: List[Transition] = list(transitions)
        self.places: List[Place] = list(places)
        self._index: Dict[str, int] = {t.name: i for i, t in enumerate(self.transitions)}
        if len(self._index) != len(self.transitions):
            raise ValueError("duplicate transition names")
        for p in self.places:
            if p.src not in self._index or p.dst not in self._index:
                raise ValueError(f"place {p.name} references unknown transition")
        self._succ: Dict[str, List[Place]] = {t.name: [] for t in self.transitions}
        for p in self.places:
            self._succ[p.src].append(p)
        # lazily-filled cycle cache: the structure is immutable after
        # construction and every consumer (throughput, compat graphs,
        # certificates) re-enumerates the same cycles otherwise
        self._cycles: List[List[Place]] = None  # type: ignore[assignment]

    # ------------------------------------------------------------------
    # Structure
    # ------------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.transitions)

    @property
    def m(self) -> int:
        return len(self.places)

    def incidence_matrix(self) -> np.ndarray:
        """A[i, j] per Eq. (3): +1 if t_j is an output transition of p_i
        (consumes from it), -1 if t_j is an input transition of p_i
        (produces into it).  With this sign convention the Eq. (2) row
        A sigma + M0/theta >= tau^- reads
        sigma_dst - sigma_src + M0_i/theta >= tau_src: the consumer of a
        place fires no earlier than one producer latency after the
        producer, minus the slack of the initial tokens at period
        1/theta."""
        A = np.zeros((self.m, self.n), dtype=np.float64)
        for i, p in enumerate(self.places):
            A[i, self._index[p.dst]] += 1.0   # t_dst consumes from p
            A[i, self._index[p.src]] -= 1.0   # t_src produces into p
        return A

    def initial_marking(self) -> np.ndarray:
        return np.array([p.tokens for p in self.places], dtype=np.float64)

    def input_delay_selector(self) -> np.ndarray:
        """B[i, j] = 1 iff transition j feeds place i (tau^-_i = tau_j).

        Used to build the LP constraint A sigma + M0/theta >= B tau of
        Eq. (2):  tau^-_i is the firing delay of the transition entering
        place p_i.
        """
        B = np.zeros((self.m, self.n), dtype=np.float64)
        for i, p in enumerate(self.places):
            B[i, self._index[p.src]] = 1.0
        return B

    # ------------------------------------------------------------------
    # Cycles and throughput
    # ------------------------------------------------------------------
    def simple_cycles(self) -> List[List[Place]]:
        """Enumerate simple cycles (as place lists) via DFS (Johnson-lite).

        Graphs here are tiny; an exponential enumerator is fine and keeps
        the code auditable.  The result is computed once per TMG and
        cached — callers must not mutate the returned lists.
        """
        if self._cycles is not None:
            return self._cycles
        cycles: List[List[Place]] = []
        seen_keys = set()

        names = [t.name for t in self.transitions]
        for start in names:
            stack: List[Tuple[str, List[Place]]] = [(start, [])]
            while stack:
                node, path = stack.pop()
                for place in self._succ[node]:
                    nxt = place.dst
                    if nxt == start:
                        cyc = path + [place]
                        # canonicalize so each cycle is recorded once
                        key = frozenset(id_p.name for id_p in cyc)
                        if key not in seen_keys:
                            seen_keys.add(key)
                            cycles.append(cyc)
                    elif nxt not in {pl.src for pl in path} and nxt > start:
                        # ">" ordering prevents re-discovering cycles from
                        # a later start node
                        stack.append((nxt, path + [place]))
        self._cycles = cycles
        return cycles

    def strongly_connected(self) -> bool:
        """Kosaraju on the transition graph."""
        succ: Dict[str, List[str]] = {t.name: [] for t in self.transitions}
        pred: Dict[str, List[str]] = {t.name: [] for t in self.transitions}
        for p in self.places:
            succ[p.src].append(p.dst)
            pred[p.dst].append(p.src)

        def reach(adj: Dict[str, List[str]], root: str) -> set:
            out, stack = set(), [root]
            while stack:
                u = stack.pop()
                if u in out:
                    continue
                out.add(u)
                stack.extend(adj[u])
            return out

        root = self.transitions[0].name
        return len(reach(succ, root)) == self.n and len(reach(pred, root)) == self.n

    def min_cycle_time(self, delays: Dict[str, float]) -> float:
        """max over cycles of D_k / N_k.

        ``delays`` maps transition name -> firing delay (effective latency).
        A cycle with zero tokens is a deadlock -> +inf.
        """
        worst = 0.0
        for cyc in self.simple_cycles():
            d = sum(delays[p.src] for p in cyc)
            n_tok = sum(p.tokens for p in cyc)
            if n_tok == 0:
                return float("inf")
            worst = max(worst, d / n_tok)
        return worst

    def throughput(self, delays: Dict[str, float]) -> float:
        """Maximum sustainable effective throughput theta (Section 2.2)."""
        mct = self.min_cycle_time(delays)
        if mct == 0.0:
            return float("inf")
        return 1.0 / mct

    def critical_cycle(self, delays: Dict[str, float]) -> List[Place]:
        best, best_val = [], -1.0
        for cyc in self.simple_cycles():
            n_tok = sum(p.tokens for p in cyc)
            val = float("inf") if n_tok == 0 else sum(delays[p.src] for p in cyc) / n_tok
            if val > best_val:
                best, best_val = cyc, val
        return best

    def criticality(self, delays: Dict[str, float]) -> Dict[str, float]:
        """Per-component share of the critical cycle time — used by the DSE
        to prioritize synthesis of the components that bound throughput
        (Section 3.3: 'prioritizes the synthesis of the components
        depending on their level of contribution to the effective
        throughput')."""
        cyc = self.critical_cycle(delays)
        total = sum(delays[p.src] for p in cyc) or 1.0
        out = {t.name: 0.0 for t in self.transitions}
        for p in cyc:
            out[p.src] += delays[p.src] / total
        return out


# ----------------------------------------------------------------------
# Constructors for the common shapes
# ----------------------------------------------------------------------

def pipeline_tmg(names: Sequence[str], buffers: int = 1, frames_in_flight: int = 1) -> TMG:
    """A linear streaming pipeline closed by a feedback place.

    Forward places carry ``buffers`` tokens' worth of channel capacity
    modelled as: forward edge with 0 initial tokens is WRONG for a marked
    graph throughput model — the standard construction gives each forward
    edge 0 tokens and each *backward* (capacity) edge ``buffers`` tokens,
    plus a global feedback edge with ``frames_in_flight`` tokens.  The
    cycle (fwd_i, back_i) then has N = buffers and D = lam_i + lam_{i+1},
    which reproduces the ping-pong overlap of Fig. 3: with buffers=2 the
    pipeline sustains theta = 1/max(lam_i); with buffers=1 adjacent
    stages serialize (theta = 1/(lam_i + lam_{i+1}) pairwise).
    """
    transitions = [Transition(n) for n in names]
    places: List[Place] = []
    for a, b in zip(names, names[1:]):
        places.append(Place(f"fwd:{a}->{b}", a, b, tokens=0))
        places.append(Place(f"cap:{b}->{a}", b, a, tokens=buffers))
    # self-capacity on each stage: a component cannot re-fire before it
    # finished (initiation-interval 1 on itself)
    for nme in names:
        places.append(Place(f"self:{nme}", nme, nme, tokens=1))
    # close the stream: last -> first with the number of frames in flight
    places.append(Place(f"loop:{names[-1]}->{names[0]}", names[-1], names[0],
                        tokens=frames_in_flight + len(names) - 1))
    return TMG(transitions, places)


def feedback_pipeline_tmg(names: Sequence[str], loop_from: str, loop_to: str,
                          loop_tokens: int, buffers: int = 2) -> TMG:
    """Pipeline with an extra algorithmic feedback edge (e.g. Lucas-Kanade's
    iterative refinement loop in the WAMI TMG, Fig. 8)."""
    base = pipeline_tmg(names, buffers=buffers)
    places = list(base.places)
    places.append(Place(f"alg:{loop_from}->{loop_to}", loop_from, loop_to, tokens=loop_tokens))
    return TMG(base.transitions, places)
