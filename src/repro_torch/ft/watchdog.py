"""Heartbeat watchdog: detects a hung training loop and triggers recovery.

The training loop calls ``beat(step)``; a daemon thread fires
``on_stall`` if no beat arrives within ``timeout_s``.  On a real cluster
the callback escalates to the job controller (restart from the last
atomic checkpoint, ``repro_torch.checkpoint``); in tests it is a plain hook.
The heartbeat is also mirrored to a file so an external supervisor can
watch a whole fleet of hosts with no RPC dependency.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

__all__ = ["Watchdog"]


class Watchdog:
    def __init__(self, *, timeout_s: float = 300.0,
                 on_stall: Optional[Callable[[int, float], None]] = None,
                 heartbeat_file: Optional[str] = None,
                 poll_s: float = 1.0):
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self.heartbeat_file = heartbeat_file
        self.poll_s = poll_s
        self._last = time.monotonic()
        self._step = 0
        self._stalled = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self, step: int):
        self._last = time.monotonic()
        self._step = step
        self._stalled = False
        if self.heartbeat_file:
            tmp = self.heartbeat_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {time.time()}")
            os.replace(tmp, self.heartbeat_file)

    @property
    def stalled(self) -> bool:
        return self._stalled

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            gap = time.monotonic() - self._last
            if gap > self.timeout_s and not self._stalled:
                self._stalled = True
                if self.on_stall:
                    self.on_stall(self._step, gap)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
