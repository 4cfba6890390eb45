"""Data pipeline: synthetic sources + sharded prefetching loader."""

from .pipeline import DataPipeline
from .synthetic import SyntheticLM

__all__ = ["SyntheticLM", "DataPipeline"]
