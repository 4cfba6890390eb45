"""Host data pipeline: sharded iteration + background prefetch.

Each host materializes only its shard of the global batch (shard =
the process's rank in a real multi-host run; overridable for tests
and simulation).  A daemon thread keeps ``prefetch`` batches ready so
host data generation overlaps device compute — the standard input-
pipeline/step overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .synthetic import SyntheticLM

__all__ = ["DataPipeline"]


class DataPipeline:
    def __init__(self, source: SyntheticLM, *, global_batch: int, seq: int,
                 shard: int = 0, n_shards: int = 1, start_step: int = 0,
                 prefetch: int = 2,
                 augment: Optional[Callable[[Dict], Dict]] = None):
        assert global_batch % n_shards == 0
        self.source = source
        self.global_batch = global_batch
        self.local_batch = global_batch // n_shards
        self.seq = seq
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step
        self.augment = augment
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _make(self, step: int) -> Dict[str, np.ndarray]:
        b = self.source.batch(step=step, shard=self.shard,
                              n_shards=self.n_shards,
                              batch=self.local_batch, seq=self.seq)
        if self.augment:
            b = self.augment(b)
        return b

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put((step, self._make(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def seek(self, step: int):
        """Restart the stream at ``step`` (checkpoint restore)."""
        self.close()
        self.__init__(self.source, global_batch=self.global_batch,
                      seq=self.seq, shard=self.shard, n_shards=self.n_shards,
                      start_step=step,
                      prefetch=self._q.maxsize, augment=self.augment)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
