"""Span-based tracing for the DSE engine and service.

COSMOS's headline number is invocation *frugality* (Fig. 11), and the
multi-tenant service's is *coalescing* — both are claims about where
tool invocations came from and why some never happened.  This module
makes every such event a first-class, exportable record:

  * :class:`Span` — one timed, attributed unit of work with
    parent/child nesting (``session.characterize`` >
    ``session.component`` > ``oracle.point``);
  * :class:`Tracer` — the collector: ``tracer.span(name, **attrs)`` is
    a context manager, ``tracer.begin``/``Span.finish`` cover
    lifecycles that cross function boundaries (a service query from
    submit to completion), and ``tracer.instant`` records
    zero-duration marks (progress ticks);
  * two clocks — :class:`WallClock` for real runs and
    :class:`LogicalClock`, a deterministic tick counter, so trace
    exports are *byte-stable* across machines and runs;
  * two exporters — newline-JSON (:meth:`Tracer.export_jsonl`) for
    grep/jq pipelines, and the Chrome ``trace_event`` format
    (:meth:`Tracer.export_chrome`) so a service run opens directly in
    Perfetto / ``chrome://tracing``.

Tracing is opt-in and cheap when off: the module-level
:data:`NULL_TRACER` satisfies the same surface with reused no-op
objects, so instrumented hot paths (every oracle point) cost one method
call when no one is listening.  The span taxonomy and both export
formats are checked by :mod:`repro_torch.core.obs.schema`.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Protocol

__all__ = [
    "Clock",
    "WallClock",
    "LogicalClock",
    "OUTCOMES",
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
]

#: the per-point oracle outcome partition:
#: every evaluated knob point gets exactly one of these
OUTCOMES = ("fresh", "cache_hit", "inflight_join", "replay")


# ----------------------------------------------------------------------
# Clocks
# ----------------------------------------------------------------------
class Clock(Protocol):
    """Timestamps for spans.  ``now`` must be monotonic."""

    def now(self) -> float: ...


class WallClock:
    """Real elapsed time (``time.monotonic``) — what live runs use."""

    def now(self) -> float:
        return time.monotonic()


class LogicalClock:
    """A deterministic clock: every ``now()`` is the next integer tick.

    Two identical sequential runs observe identical tick sequences, so
    exported traces are byte-identical.
    Thread-safe: concurrent runs still get *unique, ordered* ticks,
    they just stop being reproducible when the interleaving is racy.
    """

    def __init__(self, start: int = 0):
        self._t = int(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            self._t += 1
            return float(self._t)


# ----------------------------------------------------------------------
# Spans
# ----------------------------------------------------------------------
class Span:
    """One unit of traced work: ``[start, end)`` + attributes.

    Use as a context manager (the common case), or finish explicitly
    via :meth:`finish` for lifecycles that cross function boundaries.
    An exception leaving the ``with`` body is recorded on the span
    (``status="error"``, ``error=<repr>``) and re-raised.
    """

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "tid",
                 "start", "end", "attrs", "status", "error", "_stacked")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: Optional[int], tid: int, start: float,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs
        self.status = "ok"
        self.error: Optional[str] = None
        self._stacked = False

    def set(self, key: str, value: Any) -> None:
        """Attach/overwrite one attribute (JSON-able values only)."""
        self.attrs[key] = value

    def finish(self, error: Optional[BaseException] = None) -> None:
        if self.end is not None:      # idempotent
            return
        if error is not None:
            self.status = "error"
            self.error = f"{type(error).__name__}: {error}"
        self._tracer._finish(self)

    # -- context manager ----------------------------------------------
    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._stacked = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._stacked:
            self._tracer._pop(self)
            self._stacked = False
        self.finish(exc)
        return False                   # never swallow

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": self.span_id, "name": self.name, "tid": self.tid,
            "start": self.start, "end": self.end, "status": self.status,
            "attrs": dict(self.attrs),
        }
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        if self.error is not None:
            out["error"] = self.error
        return out


class _NullSpan:
    """The no-op span: every mutator is a cheap pass.  One shared
    instance serves the whole process."""

    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = None
    attrs: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        pass

    def finish(self, error: Optional[BaseException] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


# ----------------------------------------------------------------------
# The tracer
# ----------------------------------------------------------------------
class Tracer:
    """Collects spans; exports newline-JSON and Chrome ``trace_event``.

    Parenting is implicit within a thread (a context-managed span
    becomes the parent of spans opened inside it, on the same thread)
    and explicit across threads (``parent=``): phase spans hand
    themselves to their fan-out workers.  Thread lanes (``tid``) are
    small ints assigned in order of each thread's first span — under a
    sequential drive every run assigns the same lanes, which keeps
    logical-clock exports byte-stable.
    """

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or WallClock()
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._next_id = 1
        self._tids: Dict[int, int] = {}
        self._local = threading.local()

    # -- span lifecycle ------------------------------------------------
    def span(self, name: str, *, parent: Optional[Span] = None,
             **attrs: Any) -> Span:
        """Open a span.  Use as ``with tracer.span(...) as sp:`` —
        entering pushes it onto this thread's parent stack."""
        return self.begin(name, parent=parent, **attrs)

    def begin(self, name: str, *, parent: Optional[Span] = None,
              **attrs: Any) -> Span:
        """Open a span without touching the parent stack (for
        lifecycles finished elsewhere via :meth:`Span.finish`)."""
        ident = threading.get_ident()
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            tid = self._tids.setdefault(ident, len(self._tids))
        if parent is None:
            stack = getattr(self._local, "stack", None)
            if stack:
                parent = stack[-1]
        parent_id = None if parent is None else parent.span_id
        return Span(self, name, span_id, parent_id, tid,
                    self.clock.now(), dict(attrs))

    def instant(self, name: str, *, parent: Optional[Span] = None,
                **attrs: Any) -> None:
        """Record a zero-duration mark (progress ticks, rejections)."""
        sp = self.begin(name, parent=parent, **attrs)
        sp.end = sp.start
        with self._lock:
            self._spans.append(sp)

    # internal: stack + completion
    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()

    def _finish(self, span: Span) -> None:
        span.end = self.clock.now()
        with self._lock:
            self._spans.append(span)

    def current(self) -> Optional[Span]:
        """This thread's innermost open span (None outside any)."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- reading back --------------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Finished spans in start order (optionally filtered by name)."""
        with self._lock:
            out = sorted(self._spans, key=lambda s: s.span_id)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def outcome_counts(self, name: str = "oracle.point",
                       by: str = "outcome") -> Dict[str, int]:
        """Histogram of one attribute over spans of ``name`` — the
        Fig. 11 reconciliation helper (fresh/cache_hit/... counts)."""
        out: Dict[str, int] = {}
        for s in self.spans(name):
            key = str(s.attrs.get(by, "?"))
            out[key] = out.get(key, 0) + 1
        return out

    # -- exporters -----------------------------------------------------
    def export_jsonl(self) -> str:
        """One JSON object per line, spans in start order.  Keys are
        sorted, so identical span streams give identical bytes."""
        return "\n".join(json.dumps(s.to_json(), sort_keys=True)
                         for s in self.spans()) + "\n"

    def export_chrome(self, *, time_unit_us: float = 1.0) -> Dict[str, Any]:
        """The Chrome ``trace_event`` document (JSON-able dict).

        Complete spans become ``ph="X"`` events, instants ``ph="i"``;
        ``ts``/``dur`` are microseconds (wall clocks report seconds, so
        they pass ``time_unit_us=1e6``; the logical clock's ticks map
        1:1).  Load the written file in Perfetto / ``chrome://tracing``.
        """
        events: List[Dict[str, Any]] = []
        for s in self.spans():
            cat = s.name.split(".", 1)[0]
            args = {k: s.attrs[k] for k in sorted(s.attrs)}
            if s.parent_id is not None:
                args["parent"] = s.parent_id
            if s.error is not None:
                args["error"] = s.error
            ev: Dict[str, Any] = {
                "name": s.name, "cat": cat, "pid": 1, "tid": s.tid,
                "ts": round(s.start * time_unit_us, 3), "args": args,
            }
            end = s.end if s.end is not None else s.start
            if end == s.start:
                ev["ph"] = "i"
                ev["s"] = "t"          # thread-scoped instant
            else:
                ev["ph"] = "X"
                ev["dur"] = round((end - s.start) * time_unit_us, 3)
            events.append(ev)
        return {"displayTimeUnit": "ms", "traceEvents": events}


class NullTracer(Tracer):
    """The disabled tracer: same surface, no recording, near-zero cost.

    The single module-level :data:`NULL_TRACER` is what every
    instrumented layer defaults to — ``tracer or NULL_TRACER`` — so
    un-traced runs never allocate spans."""

    def __init__(self):             # no clock, no lock, no storage
        pass

    def span(self, name: str, *, parent: Optional[Span] = None,
             **attrs: Any) -> _NullSpan:        # type: ignore[override]
        return _NULL_SPAN

    begin = span                                 # type: ignore[assignment]

    def instant(self, name: str, *, parent: Optional[Span] = None,
                **attrs: Any) -> None:
        pass

    def current(self) -> None:
        return None

    def spans(self, name: Optional[str] = None) -> List[Span]:
        return []

    def outcome_counts(self, name: str = "oracle.point",
                       by: str = "outcome") -> Dict[str, int]:
        return {}

    def export_jsonl(self) -> str:
        return "\n"

    def export_chrome(self, *, time_unit_us: float = 1.0) -> Dict[str, Any]:
        return {"displayTimeUnit": "ms", "traceEvents": []}


NULL_TRACER = NullTracer()
