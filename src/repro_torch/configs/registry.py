"""Architecture registry: name -> :class:`ModelConfig`.

Trimmed to the architectures the port's slices use: the fleet app prices
its attention stage as a gemma2-9b share and its SSD stage as a
mamba2-780m share.  The other architectures of the JAX package's
registry come with the LM substrate.
"""

from __future__ import annotations

from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeSpec
from .gemma2_9b import CONFIG as _gemma2_9b
from .mamba2_780m import CONFIG as _mamba2_780m

__all__ = ["ARCHS", "get_config", "get_shape", "list_archs", "cells"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_gemma2_9b, _mamba2_780m)
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; available: "
                   f"{[s.name for s in SHAPES]}")


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cells() -> List[tuple]:
    """Every registered (arch, shape) cell with its applicability
    verdict."""
    out = []
    for a in list_archs():
        cfg = ARCHS[a]
        for s in SHAPES:
            ok, why = s.applicable(cfg)
            out.append((a, s.name, ok, why))
    return out
