"""Benchmark harness: the registry-driven scenario-matrix runner.

    PYTHONPATH=src python -m repro_torch.bench.run                # the card
    PYTHONPATH=src python -m repro_torch.bench.run --device cpu   # no card
    PYTHONPATH=src python -m repro_torch.bench.run --list         # enumerate
    PYTHONPATH=src python -m repro_torch.bench.run --only fig10
    PYTHONPATH=src python -m repro_torch.bench.run --app wami --backend cuda
    PYTHONPATH=src python -m repro_torch.bench.run --cell fig10/wami-cuda-share_plm
    PYTHONPATH=src python -m repro_torch.bench.run --emit-docs    # docs/matrix_torch.md

The matrix is enumerated from each bench's ``SCENARIOS`` table expanded
against the port's App/Backend registry (:mod:`.scenarios`): every
registered app x backend x variant cell appears exactly once, and cells
that cannot run are *reported as skipped with a reason*, never silently
absent.  Unknown ``--only``/``--app``/``--backend``/``--cell`` names
exit non-zero and list what IS registered.

Cells that hold tensors (the ``cuda`` cells' kernel specs, the kernels
bench) put them on ``--device``: the CUDA card unless ``--device cpu``
is given.  The ``cuda`` cells of fig4, fig10 and fleet replay the card's
recordings; the kernels bench's ``cuda`` cells launch every registered
kernel on the card.

Each executed cell writes ``artifacts/bench_torch/<bench>/<app>-<backend>
[-variant].csv`` plus a machine-readable ``matrix.json`` summary beside
them; stdout carries one ``name,us_per_call,derived`` summary row per
measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from . import scenarios as S

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     ".."))
OUT_DIR = os.path.join(_REPO, "artifacts", "bench_torch")
DOCS_MD = os.path.join(_REPO, "docs", "matrix_torch.md")


class Report:
    """Flat report: ``write`` lands ``<out_dir>/<name>.csv``.  The
    standalone bench ``__main__`` blocks use it."""

    def __init__(self, out_dir: str = OUT_DIR):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.rows = []

    def _path(self, name: str) -> str:
        return os.path.join(self.out_dir, f"{name}.csv")

    def write(self, name: str, lines):
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def write_json(self, name: str, doc, *, kind: str = "plans") -> str:
        """Sidecar JSON artifact next to the cell's CSV (same basename,
        ``.<kind>.json`` extension) — e.g. the memory-plan records
        ``python -m repro_torch.core.analysis.verify`` re-proves.
        Deterministic bytes: sorted keys, fixed indent."""
        base, _ = os.path.splitext(self._path(name))
        path = f"{base}.{kind}.json"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def csv(self, name: str, us_per_call: float, derived: str):
        row = f"{name},{us_per_call:.1f},{derived}"
        self.rows.append(row)
        print(row, flush=True)


class PrintReport:
    """Prints what a bench writes instead of writing it (the standalone
    runs of fig11, kernels)."""

    def __init__(self):
        self.rows = []

    def write(self, name, lines):
        print("\n".join(lines))

    def csv(self, name, us, derived):
        row = f"{name},{us:.1f},{derived}"
        self.rows.append(row)
        print(row, flush=True)


class CellReport(Report):
    """Per-cell report: every ``write`` routes to the cell's artifact
    path ``<out_dir>/<bench>/<app>-<backend>[-variant].csv`` (the
    ``name`` argument does not pick the file)."""

    def __init__(self, cell: S.Cell, out_dir: str = OUT_DIR):
        super().__init__(out_dir)
        self.cell = cell

    def _path(self, name: str) -> str:
        return os.path.join(self.out_dir, self.cell.artifact)


_PLURAL = {"bench": "benches"}


def _unknown(kind: str, bad, valid) -> int:
    plural = _PLURAL.get(kind, kind + "s")
    print(f"unknown {kind} {sorted(bad)!r}; registered {plural}: "
          f"{sorted(valid)}", file=sys.stderr)
    return 2


def _split(values):
    out = []
    for v in values or ():
        out += [p for p in v.split(",") if p]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.run",
        description="registry-driven scenario-matrix bench runner")
    ap.add_argument("--list", action="store_true",
                    help="print the enumerated cell matrix (run/skip + "
                         "reason) without running anything")
    ap.add_argument("--only", action="append", default=None,
                    metavar="BENCH", help="run only these benches "
                    "(repeatable / comma-separated)")
    ap.add_argument("--app", action="append", default=None,
                    help="run only cells of these apps")
    ap.add_argument("--backend", action="append", default=None,
                    help="run only cells of these backends")
    ap.add_argument("--cell", action="append", default=None,
                    metavar="BENCH/APP-BACKEND[-VARIANT]",
                    help="run exactly these cells (repeatable)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="artifact root (default artifacts/bench_torch)")
    ap.add_argument("--device", default=None,
                    help="torch device of the cells' tensors (default: "
                         "the CUDA card)")
    ap.add_argument("--emit-docs", nargs="?", const=DOCS_MD, default=None,
                    metavar="PATH",
                    help="regenerate docs/matrix_torch.md from the "
                         "registry and exit")
    args = ap.parse_args(argv)

    cells = S.enumerate_matrix()

    # -- filter validation: unknown names are an error, not a no-op ----
    only = _split(args.only)
    bad = [b for b in only if b not in S.BENCH_MODULES]
    if bad:
        return _unknown("bench", bad, S.BENCH_MODULES)
    apps_f = _split(args.app)
    bad = [a for a in apps_f if a not in {sc.cell.app for sc in cells}]
    if bad:
        return _unknown("app", bad, {sc.cell.app for sc in cells})
    backends_f = _split(args.backend)
    bad = [b for b in backends_f
           if b not in {sc.cell.backend for sc in cells}]
    if bad:
        return _unknown("backend", bad,
                        {sc.cell.backend for sc in cells})
    cells_f = _split(args.cell)
    ids = {sc.cell.id for sc in cells}
    bad = [c for c in cells_f if c not in ids]
    if bad:
        return _unknown("cell", bad, ids)

    if args.emit_docs:
        # docs describe the whole matrix; filters don't apply here
        with open(args.emit_docs, "w") as f:
            f.write(S.render_matrix_md())
        print(f"emit-docs: wrote {os.path.relpath(args.emit_docs)} "
              f"({len(cells)} cells)")
        return 0

    def selected(sc: S.ScenarioCell) -> bool:
        c = sc.cell
        if only and c.bench not in only:
            return False
        if apps_f and c.app not in apps_f:
            return False
        if backends_f and c.backend not in backends_f:
            return False
        if cells_f and c.id not in cells_f:
            return False
        return True

    if args.list:
        subset = [sc for sc in cells if selected(sc)]
        print(S.render_list(subset))
        unexplained = [sc.cell.id for sc in subset if not sc.runnable
                       and not (sc.skip_reason or "").strip()]
        return 1 if unexplained else 0

    modules = S.bench_modules()
    out_dir = args.out_dir
    print("name,us_per_call,derived")
    failures = 0
    records = []
    for sc in cells:
        entry = {"bench": sc.cell.bench, "app": sc.cell.app,
                 "backend": sc.cell.backend, "variant": sc.cell.variant,
                 "id": sc.cell.id, "reason": sc.skip_reason}
        if not selected(sc):
            entry["status"] = "filtered"
        elif not sc.runnable:
            entry["status"] = "skip"
            if cells_f and sc.cell.id in cells_f:
                # a cell the caller named explicitly must actually run
                failures += 1
                print(f"{sc.cell.id},ERROR,requested cell cannot run: "
                      f"{sc.skip_reason}", flush=True)
            else:
                print(f"# skip {sc.cell.id}: {sc.skip_reason}", flush=True)
        else:
            report = CellReport(sc.cell, out_dir)
            t0 = time.perf_counter()
            try:
                modules[sc.cell.bench].run(report, sc.cell,
                                           device=args.device)
                entry["status"] = "run"
                entry["artifact"] = sc.cell.artifact
                entry["summary"] = list(report.rows)
            except Exception as e:  # noqa: BLE001
                failures += 1
                entry["status"] = "error"
                entry["reason"] = f"{type(e).__name__}:{e}"
                print(f"{sc.cell.id},ERROR,{type(e).__name__}:{e}",
                      flush=True)
                traceback.print_exc()
            entry["seconds"] = time.perf_counter() - t0
        records.append(entry)

    counts = {}
    for entry in records:
        counts[entry["status"]] = counts.get(entry["status"], 0) + 1
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "matrix.json"), "w") as f:
        json.dump({"version": 1,
                   "generated_by": "python -m repro_torch.bench.run",
                   "counts": counts, "cells": records},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# matrix: " + " ".join(f"{k}={v}"
                                   for k, v in sorted(counts.items())),
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
