"""The port's WAMI bench cells (``repro_torch.bench``: fig4, table1,
fig10, fig11) on the CPU, each against the JAX package's live cell of
the same name (``benchmarks/``), both writing under a temporary
directory.

The ``cuda`` cells replay the card's recordings
(``artifacts/measurements/wami_cuda_tile*.json``); their reference is
the JAX package's ``pallas`` cell pointed at the same files
(``torch_bench_reference.reference_on_card_recordings``).  Each
reference cell runs once a module.

  * fig11: the CSV is byte-equal;
  * fig10 (analytical and cuda, every variant) and fig4: the CSVs are
    equal once the reference's tokens are renamed by :data:`RENAMED`
    (the only differences: the backend's name, and the cost unit a card
    recording prices in), and the share-PLM cells' plan sidecars are
    equal;
  * table1: the CSV and the deterministic half of ``BENCH_pricing.json``
    are equal; its ``timing`` half and every report row's microseconds
    are host times, left out.
"""

import json
import os

import pytest

from torch_bench_reference import (as_port, reference_on_card_recordings,
                                   run_port, run_reference)
from benchmarks import (fig4_motivational as R4, fig10_pareto as R10,
                        fig11_invocations as R11,
                        table1_characterization as RT1)
from repro_torch.bench.scenarios import Cell
from repro_torch.bench import (fig4_motivational as P4, fig10_pareto as P10,
                               fig11_invocations as P11,
                               table1_characterization as PT1)

# every token the port's cells rename, reference -> port
RENAMED = {
    "pallas": "cuda",                         # the measured backend
    "vmem_bytes": "smem_bytes",               # a card recording's cost unit
    "# TPU analogue": "# H100 analogue",      # fig4's kernel geometry lines
}

CELLS = {
    "fig4/wami-analytical": (R4, P4, ("fig4", "wami", "analytical")),
    "fig4/wami-cuda": (R4, P4, ("fig4", "wami", "cuda")),
    "table1/wami-analytical": (RT1, PT1, ("table1", "wami", "analytical")),
    "fig10/wami-analytical": (R10, P10, ("fig10", "wami", "analytical")),
    "fig10/wami-analytical-share_plm": (
        R10, P10, ("fig10", "wami", "analytical", "share_plm")),
    "fig10/wami-analytical-workers1": (
        R10, P10, ("fig10", "wami", "analytical", "workers1")),
    "fig10/wami-cuda": (R10, P10, ("fig10", "wami", "cuda")),
    "fig10/wami-cuda-share_plm": (
        R10, P10, ("fig10", "wami", "cuda", "share_plm")),
    "fig10/wami-cuda-tiles": (R10, P10, ("fig10", "wami", "cuda", "tiles")),
    "fig10/wami-cuda-workers1": (
        R10, P10, ("fig10", "wami", "cuda", "workers1")),
    "fig11/wami-analytical": (R11, P11, ("fig11", "wami", "analytical")),
}


def _renamed(lines):
    out = []
    for ln in lines:
        for old, new in RENAMED.items():
            ln = ln.replace(old, new)
        out.append(ln)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every reference cell of this module, run once: id -> (report,
    lines, its directory)."""
    out = {}
    with reference_on_card_recordings():
        for cid, (ref_mod, _, cell) in CELLS.items():
            d = tmp_path_factory.mktemp("ref")
            report, lines = run_reference(ref_mod, cell, d)
            out[cid] = (report, lines, d)
    return out


def _port(cid, tmp_path):
    _, port_mod, cell = CELLS[cid]
    return run_port(port_mod, cell, tmp_path)


def test_the_module_covers_every_runnable_wami_cell():
    from repro_torch.bench.scenarios import enumerate_matrix
    runnable = {sc.cell.id for sc in enumerate_matrix()
                if sc.runnable and sc.cell.bench in ("fig4", "table1",
                                                     "fig10", "fig11")}
    assert runnable == set(CELLS)


def test_fig11_cell_is_byte_equal(reference, tmp_path):
    _, lines = _port("fig11/wami-analytical", tmp_path)
    assert lines == reference["fig11/wami-analytical"][1]
    assert lines[-3] == "# ours: 6.7x average, up to 9.6x"


@pytest.mark.parametrize("cid", [c for c in CELLS if c.startswith("fig10/")])
def test_fig10_cell_equals_reference(cid, reference, tmp_path):
    report, lines = _port(cid, tmp_path)
    ref_report, ref_lines, ref_dir = reference[cid]
    assert lines == _renamed(ref_lines)
    assert len(report.rows) == len(ref_report.rows) == 1
    assert (report.rows[0].split(",")[2]
            == as_port(ref_report.rows)[0].split(",")[2])
    if cid.endswith("share_plm"):
        sidecar = _plans(cid)
        with open(os.path.join(str(tmp_path), sidecar)) as f:
            port_plans = json.load(f)
        with open(os.path.join(str(ref_dir),
                               sidecar.replace("cuda", "pallas"))) as f:
            assert port_plans == json.load(f)
        assert port_plans["points"]


def _plans(cid):
    """The share-PLM cell's plan sidecar, beside its CSV."""
    return os.path.splitext(Cell(*CELLS[cid][2]).artifact)[0] + ".plans.json"


def test_fig10_cuda_cell_reads_the_card_front(tmp_path):
    """The cuda cell's mapped points are the card's tile-128 recording's
    (10 mapped, theta 56.49-336.98 frames/s, as the recorder printed)."""
    _, lines = _port("fig10/wami-cuda", tmp_path)
    assert lines[1].startswith("theta_planned_fps,cost_planned_smem_bytes")
    assert lines[-2] == ("# theta range [56.49, 336.98] frames/s, "
                         "10 points, delta=0.25")


@pytest.mark.parametrize("cid", ["fig4/wami-analytical", "fig4/wami-cuda"])
def test_fig4_cell_equals_reference(cid, reference, tmp_path):
    _, lines = _port(cid, tmp_path)
    want = _renamed(reference[cid][1])
    assert lines == want
    assert "# H100 analogue (wami_gradient kernel, 512x512 frame):" in lines


def test_table1_cell_equals_reference(reference, tmp_path):
    report, lines = _port("table1/wami-analytical", tmp_path)
    ref_report, ref_lines, ref_dir = reference["table1/wami-analytical"]
    assert lines == ref_lines
    with open(tmp_path / "BENCH_pricing.json") as f:
        port_doc = json.load(f)
    with open(ref_dir / "BENCH_pricing.json") as f:
        ref_doc = json.load(f)
    assert port_doc["deterministic"] == ref_doc["deterministic"]
    # host times: the timing subtree and the rows' microseconds
    assert set(port_doc["timing"]) == set(ref_doc["timing"])
    assert port_doc["generated_by"] == ("python -m repro_torch.bench.run "
                                        "--cell table1/wami-analytical")
    assert ([r.split(",")[0] for r in report.rows]
            == [r.split(",")[0] for r in ref_report.rows])
    assert report.rows[0].split(",")[2] == ref_report.rows[0].split(",")[2]
    # nothing lands outside the cell's directory
    assert sorted(p.name for p in tmp_path.iterdir()) == ["BENCH_pricing.json",
                                                          "table1"]
