"""Repo-wide static lint: registry, kernel specs, knob spaces.

``python -m repro_torch.core.analysis.lint`` checks every app of the
package's registry *without compiling or timing a single kernel*, and
without a card — everything here is derivable from the registry
records, the knob-space declarations, the kernel specs' closed-form
cost models, and the committed measurement JSON (the kernel specs and
parity cases are built with their inputs on the CPU and never run).
Each finding carries a stable rule ID (the table lives in
docs/analysis.md):

========  ==============================================================
REG001    app factory (tmg / knob_spaces / analytical) raises
REG002    ``parity_cases`` unresolvable or malformed
REG003    declared recording missing on disk
REG004    measurement JSON invalid (version / key / value schema)
REG005    tile capability metadata inconsistent (default/native tiles)
REG006    TMG transition without a knob space (and not fixed)
SPEC001   kernel spec names a component the TMG does not have
SPEC002   no divisible (ports, unrolls) point in the knob space
SPEC003   no knob point fits the double-buffered shared-memory budget
          (an H100's opt-in shared memory per block,
          ``cuda_oracle.H100_SMEM_OPTIN_BYTES``)
SPEC004   static cost model broken (non-positive vmem/grid numbers)
KNOB001   empty knob axis (no power-of-two port in [min, max])
KNOB002   duplicate values on an axis (tile axis walked twice)
KNOB003   non-positive tile size
OBS001    an ``evaluate_batch`` implementation does not report per-point
          outcomes to the tracer (no ``tracer``-rooted ``.span`` call
          anywhere in the class — see docs/observability.md)
SOC001    a committed ``*.composition.json`` artifact lacks budget or
          traffic-mix provenance (the independent re-checker
          ``python -m repro_torch.core.soc.verify`` needs both —
          docs/soc.md)
========  ==============================================================

Exit status: 0 when every check passes, 1 otherwise (one line per
finding).  REG003 holds every declared recording to a file on disk: the
card's recordings (``artifacts/measurements/*cuda*.json``) are made by a
record-mode drive on the card, and until they are committed the lint
reports one REG003 per declared tile.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["LintFinding", "lint_app", "lint_all", "main"]


@dataclass(frozen=True)
class LintFinding:
    """One violated lint rule."""

    rule: str
    app: str
    subject: str          # component / tile / axis the finding is about
    detail: str

    def __str__(self) -> str:
        return f"{self.rule} {self.app}/{self.subject}: {self.detail}"


def _call(factory: Callable[..., Any], what: str, app_name: str,
          findings: List[LintFinding], rule: str = "REG001") -> Any:
    try:
        return factory()
    except Exception as e:            # noqa: BLE001 — lint reports, never dies
        findings.append(LintFinding(rule, app_name, what,
                                    f"factory raised {type(e).__name__}: {e}"))
        return None


# ----------------------------------------------------------------------
# registry consistency
# ----------------------------------------------------------------------
def _lint_registry(app, findings: List[LintFinding]) -> None:
    tmg = _call(app.tmg, "tmg", app.name, findings)
    spaces = _call(app.knob_spaces, "knob_spaces", app.name, findings)
    _call(app.analytical, "analytical", app.name, findings)

    if tmg is not None and spaces is not None:
        names = {t.name for t in tmg.transitions}
        for n in sorted((names - set(app.fixed)) - set(spaces)):
            findings.append(LintFinding(
                "REG006", app.name, n,
                "TMG transition has no knob space and no fixed latency"))
        for n in sorted(set(app.fixed) - names):
            findings.append(LintFinding(
                "REG006", app.name, n,
                "fixed latency for a transition the TMG does not have"))

    if app.parity_cases is not None:
        try:
            # the cases' inputs on the CPU: the lint reads their
            # structure and launches nothing
            cases = app.parity_cases(device="cpu")
        except Exception as e:        # noqa: BLE001
            findings.append(LintFinding(
                "REG002", app.name, "parity_cases",
                f"factory raised {type(e).__name__}: {e}"))
            cases = None
        if cases is not None:
            if not cases:
                findings.append(LintFinding("REG002", app.name,
                                            "parity_cases", "empty case list"))
            for i, case in enumerate(cases or ()):
                ok = (isinstance(case, (tuple, list)) and len(case) == 4
                      and isinstance(case[0], str) and callable(case[1])
                      and callable(case[2])
                      and isinstance(case[3], (tuple, list)))
                if not ok:
                    findings.append(LintFinding(
                        "REG002", app.name, f"parity_cases[{i}]",
                        "expected (name, fn, oracle_fn, args) with "
                        "callable fn/oracle"))

    # recordings: declared tiles resolve to valid JSON stores on disk
    if app.measurement_path is not None:
        for tile in app.recorded_tiles:
            path = app.measurement_path(tile)
            if not os.path.exists(path):
                findings.append(LintFinding(
                    "REG003", app.name, f"tile={tile}",
                    f"declared recording missing: {path}"))
                continue
            _lint_measurement_json(app.name, tile, path, findings)
        for tile in app.default_tiles:
            if tile not in app.recorded_tiles:
                findings.append(LintFinding(
                    "REG005", app.name, f"tile={tile}",
                    "default tile is not a declared recorded tile"))
        if app.kernel_specs is not None and app.recorded_tiles and \
                app.native_tile not in app.recorded_tiles:
            findings.append(LintFinding(
                "REG005", app.name, f"tile={app.native_tile}",
                "native tile has no declared recording"))


def _lint_measurement_json(app_name: str, tile: int, path: str,
                           findings: List[LintFinding]) -> None:
    """REG004: the committed store must parse under the documented
    schema — version 1, ``comp:pN:uM`` keys, positive float walls."""
    subject = f"tile={tile}"
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        findings.append(LintFinding("REG004", app_name, subject,
                                    f"unreadable JSON {path}: {e}"))
        return
    if doc.get("version") != 1:
        findings.append(LintFinding(
            "REG004", app_name, subject,
            f"unknown store version {doc.get('version')!r} in {path}"))
        return
    entries = doc.get("entries")
    if not isinstance(entries, dict) or not entries:
        findings.append(LintFinding(
            "REG004", app_name, subject,
            f"empty or non-dict 'entries' in {path}"))
        return
    for key, wall in entries.items():
        parts = key.rsplit(":", 2)
        bad_key = (len(parts) != 3 or not parts[1].startswith("p")
                   or not parts[2].startswith("u")
                   or not parts[1][1:].isdigit()
                   or not parts[2][1:].isdigit())
        if bad_key:
            findings.append(LintFinding(
                "REG004", app_name, subject,
                f"malformed entry key {key!r} (want 'comp:pN:uM')"))
        elif not isinstance(wall, (int, float)) or not wall > 0:
            findings.append(LintFinding(
                "REG004", app_name, subject,
                f"non-positive wall {wall!r} for entry {key!r}"))


# ----------------------------------------------------------------------
# kernel-spec static feasibility
# ----------------------------------------------------------------------
def _lint_kernel_specs(app, findings: List[LintFinding]) -> None:
    if app.kernel_specs is None:
        return
    from ..cuda_oracle import H100_SMEM_OPTIN_BYTES as budget
    try:
        specs = app.kernel_specs(app.native_tile, device="cpu")
    except Exception as e:            # noqa: BLE001
        findings.append(LintFinding(
            "SPEC001", app.name, "kernel_specs",
            f"factory raised {type(e).__name__}: {e}"))
        return
    tmg = _call(app.tmg, "tmg", app.name, findings)
    spaces = _call(app.knob_spaces, "knob_spaces", app.name, findings)
    if tmg is None or spaces is None:
        return
    names = {t.name for t in tmg.transitions}
    for comp in sorted(set(specs) - names):
        findings.append(LintFinding(
            "SPEC001", app.name, comp,
            "kernel spec for a component the TMG does not have"))
    for comp in sorted(set(specs) & names):
        spec, space = specs[comp], spaces.get(comp)
        if space is None:
            continue                  # REG006 already reported it
        feasible = False
        fits_smem = False
        for ports in space.ports():
            for unrolls in range(1, space.max_unrolls + 1):
                if not spec.divisible(ports, unrolls):
                    continue
                feasible = True
                H, W = spec.shape
                try:
                    step = spec.vmem_bytes(H, W, ports=ports,
                                           unrolls=unrolls)
                    grid = spec.grid_steps(H, W, ports=ports,
                                           unrolls=unrolls)
                except Exception as e:    # noqa: BLE001
                    findings.append(LintFinding(
                        "SPEC004", app.name, comp,
                        f"cost model raised at (p={ports}, u={unrolls}): "
                        f"{type(e).__name__}: {e}"))
                    continue
                if step <= 0 or grid <= 0:
                    findings.append(LintFinding(
                        "SPEC004", app.name, comp,
                        f"non-positive cost model output at "
                        f"(p={ports}, u={unrolls}): vmem={step}, "
                        f"grid={grid}"))
                    continue
                if 2 * step <= budget:
                    fits_smem = True
        if not feasible:
            findings.append(LintFinding(
                "SPEC002", app.name, comp,
                f"no (ports, unrolls) point in the knob space divides "
                f"shape {spec.shape}"))
        elif not fits_smem:
            findings.append(LintFinding(
                "SPEC003", app.name, comp,
                f"no divisible knob point fits the double-buffered "
                f"shared-memory budget ({budget} bytes)"))


# ----------------------------------------------------------------------
# knob-space sanity
# ----------------------------------------------------------------------
def _lint_knob_spaces(app, findings: List[LintFinding]) -> None:
    spaces = _call(app.knob_spaces, "knob_spaces", app.name, findings)
    if spaces is None:
        return
    for comp in sorted(spaces):
        space = spaces[comp]
        if not space.ports():
            findings.append(LintFinding(
                "KNOB001", app.name, comp,
                f"no power-of-two port count in "
                f"[{space.min_ports}, {space.max_ports}]"))
        tiles = tuple(space.tile_sizes)
        if len(set(tiles)) != len(tiles):
            findings.append(LintFinding(
                "KNOB002", app.name, comp,
                f"duplicate tile sizes {list(tiles)} — the axis would "
                f"be characterized twice"))
        for t in tiles:
            if t <= 0:
                findings.append(LintFinding(
                    "KNOB003", app.name, comp,
                    f"non-positive tile size {t}"))


# ----------------------------------------------------------------------
# observability: oracles must be traceable
# ----------------------------------------------------------------------
#: the modules whose classes implement ``Oracle.evaluate_batch`` — every
#: such class must thread its points through the tracer so the per-point
#: outcome partition (docs/observability.md) stays reconstructible
#: (``core.autotune`` holds the pricing half only, no ``evaluate_batch``
#: yet; it is walked so an oracle added there is linted)
_OBS_ORACLE_MODULES = ("repro_torch.core.oracle",
                       "repro_torch.core.autotune")


def _mentions_tracer(node) -> bool:
    import ast
    if isinstance(node, ast.Attribute):
        return "tracer" in node.attr.lower() or _mentions_tracer(node.value)
    if isinstance(node, ast.Name):
        return "tracer" in node.id.lower()
    if isinstance(node, ast.Call):
        return _mentions_tracer(node.func)
    return False


def _lint_observability(findings: List[LintFinding]) -> None:
    """OBS001: structurally verify that every class defining
    ``evaluate_batch`` in the oracle modules reports its work to the
    tracer — some ``<tracer>.span(...)`` (or ``.instant``/``.begin``)
    call must appear in the class body, where ``<tracer>`` is an
    expression rooted in a name containing "tracer" (``self.tracer``,
    ``self._tracer()``, a ``tracer`` local)."""
    import ast
    import importlib
    for modname in _OBS_ORACLE_MODULES:
        try:
            mod = importlib.import_module(modname)
            with open(mod.__file__) as f:
                tree = ast.parse(f.read(), filename=mod.__file__)
        except Exception as e:        # noqa: BLE001 — lint reports, never dies
            findings.append(LintFinding(
                "OBS001", "repo", modname,
                f"could not parse module: {type(e).__name__}: {e}"))
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            # Protocol classes declare the signature, they don't do work
            protocol = any(isinstance(b, ast.Name) and b.id == "Protocol"
                           for b in node.bases)
            if protocol:
                continue
            defines = any(isinstance(b, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                          and b.name == "evaluate_batch"
                          for b in node.body)
            if not defines:
                continue
            traced = any(
                isinstance(n, ast.Attribute)
                and n.attr in ("span", "instant", "begin")
                and _mentions_tracer(n.value)
                for n in ast.walk(node))
            if not traced:
                findings.append(LintFinding(
                    "OBS001", "repo", f"{modname}.{node.name}",
                    "evaluate_batch implementation never reports to the "
                    "tracer (expected a tracer-rooted .span/.instant "
                    "call somewhere in the class)"))


# ----------------------------------------------------------------------
# SoC composition artifacts: provenance must be embedded
# ----------------------------------------------------------------------
#: the keys a composition's budget / mix provenance blocks must carry
#: for ``python -m repro_torch.core.soc.verify`` to re-prove it
#: standalone
_SOC_BUDGET_KEYS = ("name", "area_mm2", "power_w", "bw_gbps", "tech_nm")
_SOC_MIX_KEYS = ("name", "demands")


def _lint_soc_artifacts(findings: List[LintFinding],
                        root: str = "artifacts/bench_torch") -> None:
    """SOC001: every committed ``*.composition.json`` must embed the
    budget and traffic-mix provenance it was composed under — the
    artifact is the cross-environment source of truth, so a composition
    whose envelopes or demands live only in the process that wrote it
    cannot be independently re-proved."""
    import glob
    pattern = os.path.join(root, "**", "*.composition.json")
    for path in sorted(glob.glob(pattern, recursive=True)):
        subject = os.path.relpath(path, root)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            findings.append(LintFinding(
                "SOC001", "repo", subject,
                f"unreadable composition JSON: {e}"))
            continue
        budget = doc.get("budget")
        if not isinstance(budget, dict):
            findings.append(LintFinding(
                "SOC001", "repo", subject,
                "no 'budget' provenance block (dict expected)"))
        else:
            for key in _SOC_BUDGET_KEYS:
                if key not in budget:
                    findings.append(LintFinding(
                        "SOC001", "repo", subject,
                        f"budget provenance lacks {key!r}"))
        mix = doc.get("mix")
        if not isinstance(mix, dict):
            findings.append(LintFinding(
                "SOC001", "repo", subject,
                "no 'mix' provenance block (dict expected)"))
        else:
            for key in _SOC_MIX_KEYS:
                if key not in mix:
                    findings.append(LintFinding(
                        "SOC001", "repo", subject,
                        f"mix provenance lacks {key!r}"))
            if not mix.get("demands"):
                findings.append(LintFinding(
                    "SOC001", "repo", subject,
                    "mix provenance has no demands — a composition of "
                    "nothing proves nothing"))


# ----------------------------------------------------------------------
# driver
# ----------------------------------------------------------------------
def lint_app(app) -> List[LintFinding]:
    """All findings for one registered app (empty = clean)."""
    findings: List[LintFinding] = []
    _lint_registry(app, findings)
    _lint_kernel_specs(app, findings)
    _lint_knob_spaces(app, findings)
    return findings


def lint_all(apps=None) -> List[LintFinding]:
    """Lint ``apps`` (default: every app of the package's registry),
    deterministically ordered by (app, rule, subject)."""
    if apps is None:
        from ..registry import list_apps
        apps = list_apps()
    findings: List[LintFinding] = []
    for app in apps:
        findings.extend(lint_app(app))
    _lint_observability(findings)     # repo-level, app-independent
    _lint_soc_artifacts(findings)     # repo-level, artifact provenance
    return sorted(findings, key=lambda f: (f.app, f.rule, f.subject,
                                           f.detail))


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.analysis.lint",
        description="static lint over the registry, kernel specs, and "
                    "knob spaces (no kernel is compiled)")
    ap.add_argument("--app", action="append", default=None,
                    help="lint only this app (repeatable; default: all)")
    args = ap.parse_args(argv)
    from ..registry import get_app, list_apps
    apps = ([get_app(a) for a in args.app] if args.app else list_apps())
    findings = lint_all(apps)
    for f in findings:
        print(f, file=sys.stderr)
    checked = ", ".join(a.name for a in apps)
    if findings:
        print(f"lint: {len(findings)} finding(s) across [{checked}]",
              file=sys.stderr)
        return 1
    print(f"lint ok: [{checked}] — registry, kernel specs, and knob "
          f"spaces are statically clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
