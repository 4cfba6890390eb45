"""Carrying parameters across frameworks as flat dicts of numpy arrays.

A flat dict maps each leaf's ``'a/b/0'`` path to its array — what
``jax.tree_util.tree_flatten_with_path`` over the JAX package's
parameter tree yields, keyed by its ``keystr_path``.  A model's
``state_dict`` key is the same path with ``.`` for ``/``, so the
mapping is one to one.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..utils import keystr_path

__all__ = ["params_from_numpy", "params_to_numpy"]


def _torch_path(path: str) -> str:
    return path.replace("/", ".")


def _np_path(name: str) -> str:
    return keystr_path(name.split("."))


@torch.no_grad()
def params_from_numpy(model: nn.Module, flat: Dict[str, np.ndarray]
                      ) -> nn.Module:
    """Load ``flat`` into ``model``'s parameters in place; returns it.

    Every parameter must have exactly one array of its shape and dtype
    (numpy's ``bfloat16`` of ``ml_dtypes`` for a bfloat16 parameter):
    raises ``KeyError`` on a missing or extra path, ``ValueError`` on a
    shape or dtype that differs."""
    own = dict(model.named_parameters())
    want = {_np_path(name) for name in own}
    missing = sorted(want - set(flat))
    extra = sorted(set(flat) - want)
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, "
                       f"extra {extra}")
    for path, arr in flat.items():
        p = own[_torch_path(path)]
        arr = np.asarray(arr)
        dtype = str(p.dtype).removeprefix("torch.")
        if tuple(arr.shape) != tuple(p.shape) or arr.dtype.name != dtype:
            raise ValueError(f"{path}: array {arr.shape} {arr.dtype.name}, "
                             f"parameter {tuple(p.shape)} {dtype}")
        if dtype == "bfloat16":         # exact through float32
            arr = arr.astype(np.float32)
        p.copy_(torch.from_numpy(np.array(arr, order="C")))
    return model


def params_to_numpy(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_numpy`: every parameter as a
    host array in its own dtype, by its ``'a/b/0'`` path."""
    out: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes    # numpy's bfloat16, as JAX's arrays carry it
            arr = t.float().numpy().astype(ml_dtypes.bfloat16)
        else:
            arr = t.numpy().copy()
        out[_np_path(name)] = arr
    return out
