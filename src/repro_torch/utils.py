"""Device selection, host-to-device conversion and tree paths shared by
the package.

Every entry point takes a ``device`` argument.  ``None`` means the CUDA
card: an entry point runs on the CPU only when the caller asks for it
(``device="cpu"``), and raises where CUDA is absent rather than
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Tuple

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy", "keystr_path",
           "leaves_with_paths"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def from_numpy(arrays: Any, device=None) -> Any:
    """A numpy array, or a tuple or list of them (frames, GMM state), as
    tensors on ``device`` with their dtypes kept — so inputs made with
    numpy feed this package and another framework identically."""
    dev = resolve_device(device)
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(from_numpy(a, dev) for a in arrays)
    return torch.from_numpy(np.ascontiguousarray(arrays)).to(dev)


def keystr_path(keys: Iterable[Any]) -> str:
    """The JAX package's ``'a/b/0'`` path of a leaf from its dict keys and
    sequence indices, outermost first (what its ``keystr_path`` gives for
    a ``tree_flatten_with_path`` key path)."""
    return "/".join(str(k) for k in keys)


def leaves_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of nested dicts, lists and tuples in
    ``jax.tree_util``'s flattening order: dict keys sorted, sequences by
    index, ``None`` empty; paths by :func:`keystr_path`."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(keystr_path(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out.extend(leaves_with_paths(sub, prefix + (key,)))
    return out
