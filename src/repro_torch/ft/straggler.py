"""Straggler detection: per-host step-time EWMA vs fleet median.

On a real pod each host reports its step wall-time; here the detector is
a pure function over the report vector so it is testable and usable in
simulation.  A host whose EWMA exceeds ``threshold`` x the fleet median
for ``patience`` consecutive windows is flagged; the launcher's policy
decides between (a) ignoring (transient), (b) excluding the host and
re-planning the mesh (``repro_torch.ft.elastic``), or (c) checkpoint-restart.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["StragglerDetector", "StragglerReport"]


@dataclass
class StragglerReport:
    step: int
    flagged: List[int]
    ewma: np.ndarray
    median: float


class StragglerDetector:
    def __init__(self, n_hosts: int, *, alpha: float = 0.3,
                 threshold: float = 1.5, patience: int = 3):
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self._ewma = np.zeros(n_hosts)
        self._strikes = np.zeros(n_hosts, np.int64)
        self._step = 0

    def update(self, step_times: Sequence[float]) -> StragglerReport:
        t = np.asarray(step_times, np.float64)
        assert t.shape == (self.n_hosts,)
        if self._step == 0:
            self._ewma = t.copy()
        else:
            self._ewma = self.alpha * t + (1 - self.alpha) * self._ewma
        med = float(np.median(self._ewma))
        slow = self._ewma > self.threshold * med
        self._strikes = np.where(slow, self._strikes + 1, 0)
        flagged = np.nonzero(self._strikes >= self.patience)[0].tolist()
        self._step += 1
        return StragglerReport(step=self._step, flagged=flagged,
                               ewma=self._ewma.copy(), median=med)
