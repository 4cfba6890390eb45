"""Traffic generators, read by name from a mix file's ``generator``.

Every seed asks for the same work (the same shapes), and only the
contents change.  Token ids are drawn from ``[1, vocab)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(w) for w in words]))


def token_rows(mix: Dict, seed: int, step: int, vocab: int
               ) -> Dict[str, np.ndarray]:
    """Step ``step``'s batch: ``mix["batch"]`` rows of ``mix["seq_len"]``
    + 1 seeded tokens.  Returns int32 ``tokens`` and ``targets`` (the row
    shifted by one)."""
    B, S = mix["batch"], mix["seq_len"]
    rows = _rng(seed, 2, step).integers(1, vocab, (B, S + 1), dtype=np.int64)
    return {"tokens": rows[:, :-1].astype(np.int32),
            "targets": rows[:, 1:].astype(np.int32)}


GENERATORS = {"token_rows": token_rows}
