"""The scenario matrix: every bench x app x backend x variant cell.

Each bench module declares a ``SCENARIOS`` table saying which axes it
spans::

    SCENARIOS = {"apps": ("wami",), "backends": "*",
                 "variants": ("", "share_plm")}       # fig10
    SCENARIOS = {"apps": "*", "backends": ("analytical", "cuda")}
    SCENARIOS = {"pairs": (("zoo", "dryrun"),)}       # fixed pseudo-cell

``"*"`` expands against the live registry (``list_apps`` /
``list_backends`` of :mod:`repro_torch.core.registry`), so a newly
registered app joins every wildcard bench without editing this package.
:func:`enumerate_matrix` expands the tables into :class:`ScenarioCell`s;
a cell that cannot run (backend does not support the app, no recording
on disk, no PLM planner for the ``share_plm`` variant, no CUDA device
for a cell that launches kernels) is enumerated anyway with a non-empty
``skip_reason``.

A bench may *replace* the default capability check by exporting
``cell_skip_reason(app: App, backend: Backend, variant: str)``.  A hook
that only wants to tighten the default should call
:func:`default_skip_reason` itself first.

Cells whose app is not a registered
:class:`~repro_torch.core.registry.App` (the ``zoo`` pseudo-app: the LLM
config zoo under ``repro_torch.configs``) are fixed cells and run
unconditionally.
"""

from __future__ import annotations

import contextlib
import importlib
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["BENCH_MODULES", "Cell", "ScenarioCell", "bench_modules",
           "enumerate_matrix", "default_skip_reason", "cuda_host",
           "assume_card", "render_list", "render_matrix_md"]

#: bench key -> module, in canonical (paper-figure) order
BENCH_MODULES: Dict[str, str] = {
    "fig4": "fig4_motivational",
    "table1": "table1_characterization",
    "fig10": "fig10_pareto",
    "fig11": "fig11_invocations",
    "roofline": "roofline_table",
    "kernels": "kernels_micro",
    "autoshard": "autoshard_llm",
    "fleet": "fleet_dse",
    "soc": "soc_compose",
}


@dataclass(frozen=True, order=True)
class Cell:
    """One runnable scenario: (bench, app, backend, variant)."""

    bench: str
    app: str
    backend: str
    variant: str = ""

    @property
    def id(self) -> str:
        tail = f"-{self.variant}" if self.variant else ""
        return f"{self.bench}/{self.app}-{self.backend}{tail}"

    @property
    def artifact(self) -> str:
        """Artifact path relative to ``artifacts/bench_torch/``."""
        tail = f"-{self.variant}" if self.variant else ""
        return os.path.join(self.bench,
                            f"{self.app}-{self.backend}{tail}.csv")


@dataclass(frozen=True)
class ScenarioCell:
    """An enumerated cell: runnable, or skipped with a reason."""

    cell: Cell
    skip_reason: Optional[str] = None

    @property
    def runnable(self) -> bool:
        return self.skip_reason is None


def bench_modules() -> Dict[str, Any]:
    """Import every bench module, keyed by bench name."""
    pkg = __name__.rsplit(".", 1)[0]
    return {key: importlib.import_module(f".{name}", pkg)
            for key, name in BENCH_MODULES.items()}


# whether this host has a CUDA device; None asks torch
_CARD: Optional[bool] = None


def cuda_host() -> bool:
    """True where a cell may launch kernels on a CUDA card."""
    if _CARD is not None:
        return _CARD
    import torch
    return torch.cuda.is_available()


@contextlib.contextmanager
def assume_card(present: bool = True) -> Iterator[None]:
    """Enumerate as on a host with (or without) a CUDA card: the
    generated docs describe the matrix as the card runs it, whatever
    host writes them."""
    global _CARD
    old, _CARD = _CARD, present
    try:
        yield
    finally:
        _CARD = old


def default_skip_reason(app: Any, backend: Any, variant: str
                        ) -> Optional[str]:
    """The registry-derived capability check benches get for free:
    backend support (``Backend.skip_reason``) plus per-variant needs."""
    reason = backend.skip_reason(app)
    if reason:
        return reason
    if variant == "share_plm" and app.plm_planner is None:
        return (f"app {app.name!r} registers no PLM planner "
                f"(share_plm variant needs one)")
    return None


def _expand_pairs(spec: Dict[str, Any], app_names: List[str],
                  backend_names: List[str]) -> List[Tuple[str, str]]:
    if "pairs" in spec:
        return [tuple(p) for p in spec["pairs"]]
    apps = (app_names if spec.get("apps") == "*"
            else list(spec.get("apps", ())))
    backends = (backend_names if spec.get("backends") == "*"
                else list(spec.get("backends", ())))
    return [(a, b) for a in apps for b in backends]


def enumerate_matrix(modules: Optional[Dict[str, Any]] = None
                     ) -> List[ScenarioCell]:
    """Expand every bench's ``SCENARIOS`` table against the registry.

    Deterministic: benches in ``BENCH_MODULES`` order, apps and
    backends sorted by name, variants in declared order.  Every
    declared cell appears exactly once — unsupported ones carry a
    non-empty ``skip_reason`` instead of being silently absent.
    """
    from ..core.registry import list_apps, list_backends
    modules = modules if modules is not None else bench_modules()
    apps = {a.name: a for a in list_apps()}
    backends = {b.name: b for b in list_backends()}
    out: List[ScenarioCell] = []
    for bench, mod in modules.items():
        spec = getattr(mod, "SCENARIOS", None)
        if spec is None:
            raise RuntimeError(f"bench module {mod.__name__!r} declares "
                               f"no SCENARIOS table")
        hook = getattr(mod, "cell_skip_reason", None)
        pairs = _expand_pairs(spec, sorted(apps), sorted(backends))
        for app_name, backend_name in pairs:
            for variant in spec.get("variants", ("",)):
                reason = None
                if app_name in apps and backend_name in backends:
                    check = hook or default_skip_reason
                    reason = check(apps[app_name], backends[backend_name],
                                   variant)
                out.append(ScenarioCell(Cell(bench, app_name, backend_name,
                                             variant), reason))
    return out


def render_list(cells: List[ScenarioCell]) -> str:
    """The ``--list`` printout: one CSV row per cell plus a summary
    line.  Byte-stable across runs."""
    lines = ["cell,status,reason"]
    unexplained = 0
    for sc in cells:
        status = "run" if sc.runnable else "skip"
        reason = sc.skip_reason or ""
        if status == "skip" and not reason.strip():
            unexplained += 1
        lines.append(f"{sc.cell.id},{status},{reason}")
    n_run = sum(sc.runnable for sc in cells)
    lines.append(f"# matrix: {len(cells)} cells, {n_run} runnable, "
                 f"{len(cells) - n_run} skipped, {unexplained} unexplained")
    return "\n".join(lines)


# ----------------------------------------------------------------------
# docs generation (docs/matrix_torch.md)
# ----------------------------------------------------------------------
def render_matrix_md() -> str:
    """docs/matrix_torch.md, generated from the registry — the support
    matrix, recording availability, and the full bench cell matrix as a
    host with a CUDA card enumerates it.  Deterministic (no timestamps,
    basenames only): ``tests/test_torch_bench_matrix.py`` regenerates it
    and fails on any diff."""
    from ..core.registry import list_apps, list_backends
    with assume_card(True):
        cells = enumerate_matrix()
    with assume_card(False):
        off_card = {sc.cell.id: sc.skip_reason
                    for sc in enumerate_matrix()}
    apps = list_apps()
    backends = list_backends()

    L: List[str] = []
    L.append("# The port's scenario matrix")
    L.append("")
    L.append("> **GENERATED** from the registry of `repro_torch` by "
             "`python -m repro_torch.bench.run --emit-docs` — do not edit "
             "by hand.  `tests/test_torch_bench_matrix.py` regenerates "
             "this file and fails on any diff.")
    L.append("")
    L.append("Every registered app x backend (x variant) cell the port's "
             "bench harness (`src/repro_torch/bench/`) enumerates, with "
             "the capability facts behind each run/skip decision.  The "
             "JAX package's matrix is [matrix.md](matrix.md).")

    L.append("")
    L.append("## Registered apps")
    L.append("")
    for app in apps:
        d = app.describe()
        L.append(f"### `{d['name']}`")
        L.append("")
        L.append(d["description"] + ".")
        L.append("")
        L.append(f"* components: {len(d['components'])} "
                 f"({', '.join('`%s`' % c for c in d['components'])})")
        fixed = (", ".join("`%s`" % f for f in d["fixed"])
                 if d["fixed"] else "none")
        L.append(f"* fixed (software) stages: {fixed}; delta "
                 f"{d['delta']}")
        L.append(f"* measured surface: "
                 f"{'yes' if d['measured'] else 'no'}"
                 + (f" (native tile {d['native_tile']})"
                    if d["measured"] else ""))
        L.append(f"* PLM planner: {'yes' if d['plm_planner'] else 'no'}"
                 + (f"; analytical tile axis {d['plm_tile_sizes']}, "
                    f"measured-drive axis {d['plm_tile_sizes_measured']}"
                    if d["plm_tile_sizes"] else ""))
        L.append(f"* parity cases: "
                 f"{'yes' if d['parity_cases'] else 'no'}")
        L.append("")

    L.append("## Apps x backends support matrix")
    L.append("")
    header = "| app | " + " | ".join(f"`{b.name}`" for b in backends) + " |"
    L.append(header)
    L.append("|---" * (len(backends) + 1) + "|")
    for app in apps:
        row = [f"`{app.name}`"]
        for b in backends:
            reason = b.skip_reason(app)
            if reason is not None:
                row.append(f"no — {reason}")
            else:
                tiles = b.supported_tiles(app)
                row.append("yes" + (f" (tiles {list(tiles)})"
                                    if tiles else ""))
        L.append("| " + " | ".join(row) + " |")

    L.append("")
    L.append("## Recordings on disk")
    L.append("")
    L.append("The `(tile, device_kind)` keys the measured backend can "
             "replay, per app — the `MeasurementSet` routing keys under "
             "`artifacts/measurements/`.")
    L.append("")
    L.append("| app | tile | device_kind | points | file |")
    L.append("|---|---|---|---|---|")
    any_rec = False
    for app in apps:
        for tile, kind, name, points in app.recording_keys():
            any_rec = True
            L.append(f"| `{app.name}` | {tile} | {kind} | {points} | "
                     f"`{name}` |")
    if not any_rec:
        L.append("| — | — | — | — | — |")

    L.append("")
    L.append("## The bench cell matrix")
    L.append("")
    n_run = sum(sc.runnable for sc in cells)
    L.append(f"{len(cells)} cells, {n_run} runnable, "
             f"{len(cells) - n_run} skipped on a host with a CUDA card.  "
             f"Run one with `python -m repro_torch.bench.run --cell "
             f"<cell>` (add `--device cpu` off the card); the artifact "
             f"lands in `artifacts/bench_torch/<bench>/<app>-<backend>"
             f"[-variant].csv`.")
    L.append("")
    L.append("| cell | status | skip reason | off the card |")
    L.append("|---|---|---|---|")
    for sc in cells:
        status = "run" if sc.runnable else "skip"
        off = off_card[sc.cell.id]
        L.append(f"| `{sc.cell.id}` | {status} | "
                 f"{sc.skip_reason or ''} | "
                 f"{'skip: ' + off if off and not sc.skip_reason else ''} |")
    L.append("")
    return "\n".join(L)
