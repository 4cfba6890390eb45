"""Observability for the DSE engine: the metrics registry behind every
counter, and the per-point outcome partition the oracle ledger counts.

Every evaluated point carries one outcome from the four-way partition
``fresh | cache_hit | inflight_join | replay``
(:meth:`~repro_torch.core.oracle.OracleLedger.outcome_counts`).
"""

from .metrics import Counter, Histogram, LATENCY_BUCKETS_S, MetricsRegistry

__all__ = ["Counter", "Histogram", "MetricsRegistry", "LATENCY_BUCKETS_S",
           "OUTCOMES"]

#: the per-point outcome partition of an oracle ledger
OUTCOMES = ("fresh", "cache_hit", "inflight_join", "replay")
