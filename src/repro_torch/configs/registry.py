"""Architecture registry: ``--arch <id>`` resolution for every launcher
(the JAX package's ten architectures, which :func:`list_archs` and
:func:`cells` enumerate, and the port's own configurations in
``PORT_ARCHS``, which ``get_config`` resolves too)."""

from __future__ import annotations

from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeSpec
from .gemma2_9b import CONFIG as _gemma2_9b
from .kimi_k2 import CONFIG as _kimi_k2
from .mamba2_780m import CONFIG as _mamba2_780m
from .nemotron4_15b import CONFIG as _nemotron4_15b
from .phi35_moe import CONFIG as _phi35_moe
from .qwen2_0_5b import CONFIG as _qwen2_0_5b
from .qwen2_vl_72b import CONFIG as _qwen2_vl_72b
from .starcoder2_7b import CONFIG as _starcoder2_7b
from .whisper_large_v3 import CONFIG as _whisper_large_v3
from .zamba2_2_7b import CONFIG as _zamba2_2_7b
from .zamba2_published import CONFIG as _zamba2_published

__all__ = ["ARCHS", "PORT_ARCHS", "get_config", "get_shape", "list_archs", "cells"]

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _qwen2_0_5b, _gemma2_9b, _starcoder2_7b, _nemotron4_15b,
        _kimi_k2, _phi35_moe, _whisper_large_v3, _mamba2_780m,
        _qwen2_vl_72b, _zamba2_2_7b,
    )
}

# configurations of the port alone (no JAX counterpart)
PORT_ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_zamba2_published,)
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in ARCHS:
        return ARCHS[name]
    if name in PORT_ARCHS:
        return PORT_ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; available: "
                   f"{sorted(ARCHS) + sorted(PORT_ARCHS)}")


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; available: "
                   f"{[s.name for s in SHAPES]}")


def list_archs() -> List[str]:
    return sorted(ARCHS)


def cells() -> List[tuple]:
    """All 40 (arch, shape) cells with applicability verdicts."""
    out = []
    for a in list_archs():
        cfg = ARCHS[a]
        for s in SHAPES:
            ok, why = s.applicable(cfg)
            out.append((a, s.name, ok, why))
    return out
