"""Architecture configs and the shape registry (the architectures the
port's slices use)."""

from .base import SHAPES, ModelConfig, ShapeSpec
from .registry import ARCHS, cells, get_config, get_shape, list_archs

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "get_config",
           "get_shape", "list_archs", "cells"]
