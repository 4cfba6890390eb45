"""Step-atomic checkpointing (numpy container).

Layout:

    <root>/step_000123/
        manifest.json           # leaf paths/shapes/dtypes + ``extra``
        <leafpath>.npy          # one file per leaf
    <root>/LATEST                # atomic pointer, written last

Write protocol: serialize into ``step_xxxxx.tmp``, fsync files, rename
the directory, then rewrite LATEST — a crash leaves either the previous
complete checkpoint or a garbage .tmp that restore ignores, never a torn
state.

Trees are nested dicts, lists and tuples with numpy (or scalar) leaves;
``None`` holds no leaf.  Dict keys flatten in sorted order and a leaf's
path is its keys and indices joined by ``/`` — the layout and the path
format of the JAX package's store, so a directory written by either
package loads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils import leaves_with_paths

__all__ = ["save", "restore", "latest_step", "list_steps"]


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in order from
    ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(root: str, step: int, tree: Any, *, extra: Optional[Dict] = None):
    """Write one checkpoint atomically."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for path, leaf in leaves_with_paths(tree):
        arr = np.asarray(leaf)
        fn = path.replace("/", "__") + ".npy"
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"path": path, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_dir(root)
    latest = os.path.join(root, "LATEST")
    with open(latest + ".tmp", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest + ".tmp", latest)


def list_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    """The step LATEST points to, falling back to a directory scan (a
    crash between dir-rename and LATEST update is recoverable)."""
    steps = list_steps(root)
    ptr = os.path.join(root, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            s = int(f.read().strip())
        if s in steps:
            return s
    return steps[-1] if steps else None


def restore(root: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore a checkpoint into the structure of ``like``."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {m["path"]: m for m in manifest["leaves"]}

    leaves = []
    for path, leaf in leaves_with_paths(like):
        m = by_path.get(path)
        if m is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = np.load(os.path.join(d, m["file"]))
        want = tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != {want}")
        leaves.append(arr.astype(np.asarray(leaf).dtype)
                      if hasattr(leaf, "dtype") else arr)
    return _unflatten(like, iter(leaves)), manifest["extra"]
