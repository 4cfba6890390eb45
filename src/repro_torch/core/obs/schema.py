"""Trace-artifact schema: what an exported trace file must look like.

A run's tracer exports a Chrome ``trace_event`` document or span JSONL;
this module is the schema both are validated against, with no external
JSON-schema dependency — the schema is a declarative table below and
the validator walks it.

Two formats are covered:

  * **Chrome trace document** (``*.trace.json``) — ``validate_chrome``:
    top-level ``traceEvents`` list; every event needs ``name``/``cat``/
    ``ph``/``pid``/``tid``/``ts``(+``dur`` for ``ph="X"``); ``ph`` is
    ``X`` (complete span) or ``i`` (instant); every ``oracle.point`` /
    ``shared.point`` event must carry an ``args.outcome`` drawn from
    the four-way partition ``fresh | cache_hit | inflight_join |
    replay``.
  * **span JSONL** (:meth:`Tracer.export_jsonl` output) —
    ``validate_jsonl``: one object per line with ``id``/``name``/
    ``tid``/``start``/``end``/``status``/``attrs``; ``parent`` ids must
    resolve to an earlier span (ids are allocated in start order).

CLI::

    python -m repro_torch.core.obs.schema build/service.trace.json

exits 1 listing every violation, 0 when all files validate.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from .trace import OUTCOMES

__all__ = ["OUTCOMES", "validate_chrome", "validate_jsonl",
           "validate_file", "main"]

#: span names whose events must carry an outcome tag
_POINT_SPANS = ("oracle.point", "shared.point")

#: required event fields -> allowed types (the declarative schema)
_EVENT_FIELDS: Dict[str, tuple] = {
    "name": (str,),
    "cat": (str,),
    "ph": (str,),
    "pid": (int,),
    "tid": (int,),
    "ts": (int, float),
    "args": (dict,),
}

_SPAN_FIELDS: Dict[str, tuple] = {
    "id": (int,),
    "name": (str,),
    "tid": (int,),
    "start": (int, float),
    "end": (int, float),
    "status": (str,),
    "attrs": (dict,),
}


def _check_fields(obj: Dict[str, Any], fields: Dict[str, tuple],
                  where: str, errors: List[str]) -> bool:
    ok = True
    for key, types in fields.items():
        if key not in obj:
            errors.append(f"{where}: missing required field {key!r}")
            ok = False
        elif not isinstance(obj[key], types) or isinstance(obj[key], bool):
            errors.append(f"{where}: field {key!r} has type "
                          f"{type(obj[key]).__name__}, want "
                          f"{'/'.join(t.__name__ for t in types)}")
            ok = False
    return ok


def validate_chrome(doc: Any) -> List[str]:
    """Violations in a Chrome ``trace_event`` document (empty = valid)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"document: want a JSON object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["document: missing or non-list 'traceEvents'"]
    if not events:
        errors.append("document: empty 'traceEvents' (nothing was traced)")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: want an object")
            continue
        if not _check_fields(ev, _EVENT_FIELDS, where, errors):
            continue
        ph = ev["ph"]
        if ph not in ("X", "i"):
            errors.append(f"{where}: unknown phase {ph!r} (want 'X' or 'i')")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or dur < 0:
                errors.append(f"{where}: complete event needs a "
                              f"non-negative 'dur', got {dur!r}")
        if ev["ts"] < 0:
            errors.append(f"{where}: negative ts {ev['ts']!r}")
        if ev["name"].split(".", 1)[0] != ev["cat"]:
            errors.append(f"{where}: cat {ev['cat']!r} is not the first "
                          f"segment of name {ev['name']!r}")
        if ev["name"] in _POINT_SPANS:
            outcome = ev["args"].get("outcome")
            if outcome not in OUTCOMES:
                errors.append(
                    f"{where}: {ev['name']} event needs args.outcome in "
                    f"{list(OUTCOMES)}, got {outcome!r}")
    return errors


def validate_jsonl(text: str) -> List[str]:
    """Violations in a span-JSONL export (empty = valid)."""
    errors: List[str] = []
    seen: set = set()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        errors.append("jsonl: no spans")
    for i, line in enumerate(lines):
        where = f"line {i + 1}"
        try:
            span = json.loads(line)
        except ValueError as e:
            errors.append(f"{where}: invalid JSON: {e}")
            continue
        if not isinstance(span, dict):
            errors.append(f"{where}: want an object")
            continue
        if not _check_fields(span, _SPAN_FIELDS, where, errors):
            continue
        if span["status"] not in ("ok", "error"):
            errors.append(f"{where}: unknown status {span['status']!r}")
        if span["end"] < span["start"]:
            errors.append(f"{where}: end {span['end']} before start "
                          f"{span['start']}")
        parent = span.get("parent")
        if parent is not None and parent not in seen:
            errors.append(f"{where}: parent {parent} does not name an "
                          f"earlier span")
        if span["name"] in _POINT_SPANS and \
                span["attrs"].get("outcome") not in OUTCOMES:
            errors.append(f"{where}: {span['name']} span needs "
                          f"attrs.outcome in {list(OUTCOMES)}, got "
                          f"{span['attrs'].get('outcome')!r}")
        seen.add(span["id"])
    return errors


def validate_file(path: str) -> List[str]:
    """Dispatch on extension: ``*.jsonl`` as span lines, anything else
    as a Chrome trace document."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [f"unreadable: {e}"]
    if path.endswith(".jsonl"):
        return validate_jsonl(text)
    try:
        doc = json.loads(text)
    except ValueError as e:
        return [f"invalid JSON: {e}"]
    return validate_chrome(doc)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.obs.schema",
        description="validate trace artifacts (Chrome trace_event JSON "
                    "or span JSONL) against the documented schema")
    ap.add_argument("paths", nargs="+", help="trace files to validate")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.paths:
        errors = validate_file(path)
        if errors:
            bad += 1
            print(f"FAIL {path}: {len(errors)} violation(s)",
                  file=sys.stderr)
            for e in errors[:50]:
                print(f"  {e}", file=sys.stderr)
        else:
            print(f"ok   {path}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
