"""Asynchronous checkpointing: snapshot to host, write in background.

``save_async`` copies every tensor of the tree to host memory
synchronously (bounded by the card's copy to the host, not by the disk)
and hands the write to a single worker thread, so training resumes
while the previous step is still hitting disk.  At most one write is in
flight; a second request waits for the first (bounded memory).
``wait()`` drains it and raises the error of a write that failed — call
it before exiting or measuring.  A bfloat16 tensor is written as the
JAX package writes one (``store``: its raw bits, manifest dtype
``bfloat16``).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..utils import tree_map
from . import store

__all__ = ["AsyncCheckpointer"]


def _to_host(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


class AsyncCheckpointer:
    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None):
        self.wait()                              # one write in flight
        host_tree = tree_map(_to_host, tree)

        def work():
            try:
                store.save(self.root, step, host_tree, extra=extra)
                self._gc()
            except BaseException as e:          # surfaced on next wait()
                self._error = e

        t = threading.Thread(target=work, daemon=True)
        with self._lock:
            self._pending = t
        t.start()

    def wait(self):
        with self._lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = store.list_steps(self.root)
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.wait()
