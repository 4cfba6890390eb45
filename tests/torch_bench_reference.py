"""What the bench tests share: one cell of each package run into a
directory, and the two packages pointed at the same inputs.

  * :func:`reference_on_card_recordings` points the JAX package's
    ``pallas`` backend at the card's recordings
    (``artifacts/measurements/*cuda*.json``), as
    ``tests/test_torch_card_recordings.py`` builds its replays: the WAMI
    and fleet apps' recording paths and calibrated fallbacks read the
    card's files, and the oracles price under the card's device kind and
    shared-memory budget.  Nothing in ``benchmarks/`` or the JAX package
    changes: the names are swapped while a test runs.
  * :func:`port_on_reference_chip` gives the port's fleet app the JAX
    package's TPU constants (its analytical tool and its calibrated
    fallback), as ``tests/test_torch_soc.py`` does, so that fleet fronts
    compare.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import run as ref_run                     # noqa: E402
from benchmarks.scenarios import Cell as RefCell          # noqa: E402
import repro.apps.fleet.pipeline as JF                    # noqa: E402
import repro.apps.wami.pallas as JW                       # noqa: E402
import repro.apps.wami.pipeline as JP                     # noqa: E402
from repro.core import MeasurementStore as JStore         # noqa: E402
from repro.core import PallasOracle                       # noqa: E402
from repro.core import autotune as JA                     # noqa: E402
from repro.core import registry as JR                     # noqa: E402
from repro.core import xlatool as JX                      # noqa: E402
import repro_torch.apps.fleet.pipeline as TF              # noqa: E402
from repro_torch.bench import run as port_run             # noqa: E402
from repro_torch.bench.scenarios import Cell              # noqa: E402
from repro_torch.core import registry as TR               # noqa: E402
from repro_torch.core.chips import ChipSpec               # noqa: E402

MEASUREMENTS = os.path.join(REPO, "artifacts", "measurements")
CARD = "NVIDIA H100 80GB HBM3"      # the recordings' device kind
SMEM_H100 = 232448                  # and the budget they carry
FLEET_CARD = os.path.join(MEASUREMENTS, "fleet_cuda.json")
REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)


def card_path(tile: int = 128) -> str:
    return os.path.join(MEASUREMENTS, f"wami_cuda_tile{tile}.json")


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def run_reference(module, cell, out_dir):
    """The JAX package's bench cell ``(bench, app, backend[, variant])``
    with its backend named ``pallas``; returns (report, CSV lines)."""
    bench, app, backend, *variant = cell
    c = RefCell(bench, app, "pallas" if backend == "cuda" else backend,
                *variant)
    report = ref_run.CellReport(c, str(out_dir))
    module.run(report, c)
    return report, _lines(os.path.join(str(out_dir), c.artifact))


def run_port(module, cell, out_dir):
    """The port's bench cell, its tensors on the CPU; returns (report,
    CSV lines)."""
    c = Cell(*cell)
    report = port_run.CellReport(c, str(out_dir))
    module.run(report, c, device="cpu")
    return report, _lines(os.path.join(str(out_dir), c.artifact))


def as_port(lines) -> list:
    """Reference lines with the backend's name as the port's."""
    return [ln.replace("pallas", "cuda") for ln in lines]


@contextlib.contextmanager
def reference_on_card_recordings():
    wami = JR.get_app("wami")
    fleet = JR.get_app("fleet")
    pallas = JR.get_backend("pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JR._APPS, "wami", dataclasses.replace(
            wami, measurement_path=card_path,
            calibrated_fallback=lambda store=None: JW.wami_unit_system(
                store=store or JStore.load(card_path())).calibrated(
                    JP.wami_hls_tool())))
        mp.setitem(JR._APPS, "fleet", dataclasses.replace(
            fleet, measurement_path=lambda _t: FLEET_CARD,
            calibrated_fallback=lambda store=None: JF.fleet_calibrated_tool(
                store or JStore.load(FLEET_CARD))))
        mp.setitem(JR._BACKENDS, "pallas", dataclasses.replace(
            pallas, make_tool=functools.partial(
                JR._pallas_tool, device_kind=CARD, vmem_budget=SMEM_H100)))
        # the share-PLM drive builds its own oracle over these names
        mp.setattr(JW, "default_measurement_path", card_path)
        mp.setattr(JW, "PallasOracle", functools.partial(
            PallasOracle, device_kind=CARD, vmem_budget=SMEM_H100))
        yield


@contextlib.contextmanager
def port_on_reference_chip():
    fleet = TR.get_app("fleet")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(TR._APPS, "fleet", dataclasses.replace(
            fleet, analytical=lambda: TF.fleet_xla_tool(chip=REF_CHIP),
            calibrated_fallback=lambda store=None: TF.fleet_calibrated_tool(
                store, chip=REF_CHIP)))
        yield
