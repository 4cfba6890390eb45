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

Trees are nested dicts, lists, tuples and NamedTuples with numpy,
scalar or ``torch.Tensor`` leaves; ``None`` holds no leaf.  Dict keys
flatten in sorted order, a NamedTuple's fields by name, and a leaf's
path is its keys, field names and indices joined by ``/`` — the layout
and the path format of the JAX package's store, so a directory written
by either package loads in the other.

A bfloat16 leaf is stored as the JAX package stores it: a ``|V2``
``.npy`` of its raw bits, with ``bfloat16`` as its manifest dtype.
``restore`` reads those bits back exactly, into a bfloat16 tensor or an
``ml_dtypes.bfloat16`` array (or converted to the target's dtype), so
no bfloat16 type is needed in numpy to write or read one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import leaves_with_paths, unflatten_like

__all__ = ["save", "restore", "latest_step", "list_steps"]


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """``(array, manifest dtype)`` of a leaf: a tensor through the host
    (bfloat16 as its raw bits, a ``|V2`` array), else ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _bf16_bits(arr: np.ndarray, dtype: str) -> bool:
    """Whether ``arr`` holds the raw bits of a bfloat16 leaf (``np.load``
    gives a ``|V2`` array for one without ``ml_dtypes``' dtype)."""
    return (dtype == "bfloat16" and arr.dtype.kind == "V"
            and arr.dtype.itemsize == 2)


def _restored(arr: np.ndarray, dtype: str, like: Any) -> Any:
    """``arr`` as ``like``'s kind of leaf: a tensor of its dtype on its
    device, an array of its dtype, or (for an untyped ``like``) as
    loaded."""
    bf16 = _bf16_bits(arr, dtype)
    if isinstance(like, torch.Tensor):
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if bf16 else torch.from_numpy(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if not hasattr(like, "dtype"):
        return arr
    want = np.asarray(like).dtype
    if bf16:
        if want.name == "bfloat16":          # ml_dtypes' type: the bits
            return arr.view(want)
        # bfloat16 is float32's upper half: exact through float32
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr.astype(want)


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
        arr, dtype = _host_array(leaf)
        fn = path.replace("/", "__") + ".npy"
        with open(os.path.join(tmp, fn), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({"path": path, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": dtype})
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
    """Restore a checkpoint into the structure of ``like``.  Each leaf
    takes the kind of ``like``'s leaf at its path: a tensor of that dtype
    on that device, an array of that dtype, or (for an untyped leaf) the
    array as stored."""
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
        want = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                     else np.shape(leaf))
        if tuple(arr.shape) != want:
            raise ValueError(f"{path}: checkpoint shape {arr.shape} != {want}")
        leaves.append(_restored(arr, m["dtype"], leaf))
    return unflatten_like(like, iter(leaves)), manifest["extra"]
