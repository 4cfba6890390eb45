"""Fault tolerance: watchdog, straggler detection, elastic re-planning."""

from .elastic import ElasticPlan, largest_pow2_leq, replan
from .straggler import StragglerDetector, StragglerReport
from .watchdog import Watchdog

__all__ = ["Watchdog", "StragglerDetector", "StragglerReport",
           "ElasticPlan", "replan", "largest_pow2_leq"]
