"""Architecture configs (one module per assigned arch) + shape registry."""

from .base import SHAPES, ModelConfig, ShapeSpec
from .registry import ARCHS, cells, get_config, get_shape, list_archs

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "get_config",
           "get_shape", "list_archs", "cells"]
