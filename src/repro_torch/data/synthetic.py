"""Synthetic token stream: deterministic, seekable, structure-bearing.

Not uniform noise — a tiny order-2 Markov chain over the vocabulary so a
~100M model trained for a few hundred steps shows a real loss drop (the
end-to-end example's acceptance check).  Deterministic and seekable by
(shard, step), which is what makes checkpoint/restart exact: a restarted
run consumes exactly the batches it would have seen.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "TokenBatch"]


@dataclass(frozen=True)
class TokenBatch:
    tokens: np.ndarray
    targets: np.ndarray
    mask: np.ndarray


class SyntheticLM:
    """Order-2 Markov token source with per-(shard, step) seekability."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab
        self.seed = seed
        self.branching = min(branching, vocab)

    def _transition(self, a: np.ndarray, b: np.ndarray, rnd: np.ndarray
                    ) -> np.ndarray:
        """next = f(prev, r): each token has `branching` fixed successors
        (an order-1 chain a small model can actually learn in tens of
        steps — the loss-decrease acceptance check depends on it)."""
        h = (b * 10007 + (rnd % self.branching) * 257 + self.seed) % (2 ** 31)
        return ((b + (h % self.branching) * 2654435761 + 1) % self.vocab
                ).astype(np.int64)

    def batch(self, *, step: int, shard: int, n_shards: int,
              batch: int, seq: int) -> Dict[str, np.ndarray]:
        """Batch for a given (step, shard) — pure function of its args."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, n_shards]))
        B = batch
        toks = np.empty((B, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, B)
        toks[:, 1] = rng.integers(0, self.vocab, B)
        noise = rng.integers(0, 4, (B, seq + 1))
        for t in range(2, seq + 1):
            toks[:, t] = self._transition(toks[:, t - 2], toks[:, t - 1],
                                          noise[:, t])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, seq), np.float32),
        }
