"""Device selection, host-to-device conversion and tree paths shared by
the package.

Every entry point takes a ``device`` argument.  ``None`` means the CUDA
card: an entry point runs on the CPU only when the caller asks for it
(``device="cpu"``), and raises where CUDA is absent rather than
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy", "keystr_path",
           "leaves_with_paths", "tree_leaves", "unflatten_like",
           "tree_map"]


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


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of nested dicts, lists, tuples and
    NamedTuples in ``jax.tree_util``'s flattening order: dict keys
    sorted, sequences by index, a NamedTuple's fields in order and by
    name (as ``GetAttrKey`` names them: ``opt/step``, ``opt/mu/a``),
    ``None`` empty; paths by :func:`keystr_path`.  Only a plain list or
    tuple is a sequence: an instance of another tuple subclass (a
    sharding spec) is a leaf, as in ``jax.tree_util``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif type(tree) in (list, tuple):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(keystr_path(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out.extend(leaves_with_paths(sub, prefix + (key,)))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`leaves_with_paths`' order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten_like(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (the inverse of :func:`tree_leaves`)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: unflatten_like(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(unflatten_like(v, leaves) for v in like))
    if type(like) in (list, tuple):
        return type(like)(unflatten_like(v, leaves) for v in like)
    return next(leaves)


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (of the same structure), in ``tree``'s structure."""
    others = [tree_leaves(t) for t in rest]
    return unflatten_like(tree, iter(
        [fn(leaf, *(o[i] for o in others))
         for i, leaf in enumerate(tree_leaves(tree))]))
