"""Unified observability for the DSE engine and service, and for the
device work of the LM path.

Three small primitives — a span tracer and a metrics registry, threaded
through the DSE stack, and profiler ranges on the LM path:

  * :mod:`repro_torch.core.obs.trace` — ``Tracer.span(name, **attrs)``
    context-manager spans with parent/child nesting, an injectable
    clock (:class:`WallClock` live, :class:`LogicalClock` for
    byte-stable exports), newline-JSON and Chrome ``trace_event``
    exporters (Perfetto-openable);
  * :mod:`repro_torch.core.obs.metrics` — :class:`MetricsRegistry` with
    lock-consistent counters, gauges, and fixed-bucket latency
    histograms behind one ``snapshot()`` pull interface;
  * :mod:`repro_torch.core.obs.ranges` — ``device_range(name)``, a
    ``torch.profiler`` range around one module's forward, recompute and
    backward (backward through autograd hooks, on the thread that
    launches its kernels); a flag check and nothing else while no
    profiler records.  Opened by ``models/ssm.py::mamba_sequence``
    (``mamba.mixer``), the local body of ``models/ssm.py::_ssd_chunked``
    (``mamba.ssd``) and ``train/remat.py::maybe_remat`` around the
    re-run of a checkpointed layer body (``remat.recompute``);
  * :mod:`repro_torch.core.obs.schema` — the trace-artifact schema
    exports are validated against
    (``python -m repro_torch.core.obs.schema``).

Instrumented layers: :class:`~repro_torch.core.session.ExplorationSession`
phases, the oracle stack (:class:`~repro_torch.core.oracle.OracleLedger` /
:class:`~repro_torch.core.oracle.SharedOracle` — every evaluated point
carries an ``outcome`` tag from the four-way partition
``fresh | cache_hit | inflight_join | replay``),
:meth:`~repro_torch.core.plm.planner.PLMPlanner.plan_point` (certificate
tier chosen), whole-grid pricing
(:class:`~repro_torch.core.pricing.BatchPricer`), and the
:class:`~repro_torch.serve.dse_service.DSEService` query lifecycle
(submit -> queued -> dispatched -> done).  The benchmark's metric
readers (``perfbench/metrics/``) read the LM path's ranges by name from
a traced run.
"""

from .metrics import (Counter, Gauge, Histogram, LATENCY_BUCKETS_S,
                      MetricsRegistry)
from .ranges import device_range
from .trace import (Clock, LogicalClock, NULL_TRACER, NullTracer, OUTCOMES,
                    Span, Tracer, WallClock)

__all__ = [
    "Clock",
    "WallClock",
    "LogicalClock",
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_S",
    "OUTCOMES",
    "device_range",
    "validate_chrome",
    "validate_jsonl",
]

# schema is also a `python -m` entry point: importing it eagerly here
# would double-import it under runpy (same rule as core.analysis)
_SCHEMA_LAZY = {"validate_chrome", "validate_jsonl"}


def __getattr__(name):
    if name in _SCHEMA_LAZY:
        from . import schema
        return getattr(schema, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
