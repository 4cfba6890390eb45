"""The port's system bench cells (``repro_torch.bench``: roofline,
kernels, autoshard, fleet, soc) on the CPU, each against the JAX
package's live cell of the same name (``benchmarks/``), both writing
under a temporary directory; and the standalone gates chip_smoke.py
runs on the card (fig11, fig10 and fleet ``--smoke``).

The port's fleet app prices on the H100 chip table; for these
comparisons it is given the reference's TPU constants
(``torch_bench_reference.port_on_reference_chip``), and the reference's
``pallas`` cells replay the card's recordings
(``reference_on_card_recordings``).  Each reference cell runs once a
module.  Compared, and left out:

  * fleet (both backends): the CSV, once :data:`RENAMED` is applied;
  * soc (both mixes): the CSV (renamed), the composition sidecar, and
    ``BENCH_soc.json`` but for its ``generated_by``;
  * autoshard: the zoo rows, the planner on the reference's 16 GiB chip
    (``autoshard_llm.CHIP``; the header names the chip and its budget);
    the soak's tenant rows (invocations, identical fronts and
    attributions) and its shared and attributed invocation totals, but
    not the split of the saved ones into cache hits and in-flight joins,
    which depends on thread timing; the trace cell's CSV and its trace;
  * kernels (analytical): the kernels timed, in order; every other
    column is a host time;
  * roofline: the rows made from one hand-written dry-run record given
    to both ``run``s; only the header (the chip table) and the fits
    threshold differ.
"""

import json
import os

import pytest

from torch_bench_reference import (REF_CHIP, as_port, card_path,
                                   port_on_reference_chip,
                                   reference_on_card_recordings, run_port,
                                   run_reference)
from benchmarks import (autoshard_llm as RA, fig10_pareto as R10,
                        fig11_invocations as R11, fleet_dse as RF,
                        kernels_micro as RK, roofline_table as RR,
                        soc_compose as RS)
from repro_torch.bench import (autoshard_llm as PA, fig10_pareto as P10,
                               fig11_invocations as P11, fleet_dse as PF,
                               kernels_micro as PK, roofline_table as PR,
                               soc_compose as PS)

# every token the port's cells rename, reference -> port
RENAMED = {
    "pallas": "cuda",                                 # the measured backend
    "vmem_bytes": "smem_bytes",                       # a recording's unit
    "repro.core.soc.verify": "repro_torch.core.soc.verify",   # the verifier
}

CELLS = {
    "kernels/fleet-analytical": (RK, PK, ("kernels", "fleet", "analytical")),
    "kernels/wami-analytical": (RK, PK, ("kernels", "wami", "analytical")),
    "autoshard/zoo-analytical": (RA, PA, ("autoshard", "zoo", "analytical")),
    "autoshard/service-soak": (RA, PA, ("autoshard", "service", "soak")),
    "autoshard/service-trace": (RA, PA, ("autoshard", "service", "trace")),
    "fleet/fleet-analytical": (RF, PF, ("fleet", "fleet", "analytical")),
    "fleet/fleet-cuda": (RF, PF, ("fleet", "fleet", "cuda")),
    "soc/soc-analytical-wami60_fleet40": (
        RS, PS, ("soc", "soc", "analytical", "wami60_fleet40")),
    "soc/soc-analytical-wami90_fleet10": (
        RS, PS, ("soc", "soc", "analytical", "wami90_fleet10")),
}


def _renamed(lines):
    out = []
    for ln in lines:
        for old, new in RENAMED.items():
            ln = ln.replace(old, new)
        out.append(ln)
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


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


@pytest.fixture
def port(tmp_path, monkeypatch):
    """Runs a port cell on the reference's chip constants."""
    monkeypatch.setattr(PA, "CHIP", REF_CHIP)

    def go(cid):
        _, port_mod, cell = CELLS[cid]
        with port_on_reference_chip():
            return run_port(port_mod, cell, tmp_path)
    yield go


def test_the_module_covers_every_runnable_system_cell():
    from repro_torch.bench.scenarios import enumerate_matrix
    runnable = {sc.cell.id for sc in enumerate_matrix()
                if sc.runnable and sc.cell.bench in (
                    "kernels", "autoshard", "fleet", "soc")}
    assert runnable == set(CELLS)


@pytest.mark.parametrize("cid", ["fleet/fleet-analytical",
                                 "fleet/fleet-cuda"])
def test_fleet_cell_equals_reference(cid, reference, port):
    _, lines = port(cid)
    assert lines == _renamed(reference[cid][1])
    assert len(lines) > 3


@pytest.fixture(scope="module")
def port_soc(tmp_path_factory):
    """Both SoC cells of the port, run once in the runner's order (the
    first mix's cell resolves the fronts the second's reuses:
    ``_FRONT_CACHE``), on the reference's chip constants."""
    out = tmp_path_factory.mktemp("port")
    PS._FRONT_CACHE.clear()
    lines = {}
    with port_on_reference_chip():
        for mix in PS.MIXES:
            lines[mix] = run_port(PS, ("soc", "soc", "analytical", mix),
                                  out)[1]
    PS._FRONT_CACHE.clear()
    return out, lines


@pytest.mark.parametrize("mix", ["wami60_fleet40", "wami90_fleet10"])
def test_soc_cell_equals_reference(mix, reference, port_soc):
    cid = f"soc/soc-analytical-{mix}"
    out, lines = port_soc
    _, ref_lines, ref_dir = reference[cid]
    assert lines[mix] == _renamed(ref_lines)
    name = os.path.join("soc", f"soc-analytical-{mix}.composition.json")
    assert _json(out / name) == _json(ref_dir / name)
    if mix == PS.PRIMARY:
        got = _json(out / "BENCH_soc.json")
        want = _json(ref_dir / "BENCH_soc.json")
        assert got.pop("generated_by").startswith("python -m repro_torch.")
        want.pop("generated_by")
        assert got == want
    assert (PS.GATE_MAX_GAP, PS.GATE_BUDGET) == (RS.GATE_MAX_GAP,
                                                  RS.GATE_BUDGET)


def test_autoshard_zoo_cell_equals_reference_at_16gib(reference, port):
    _, lines = port("autoshard/zoo-analytical")
    ref_lines = reference["autoshard/zoo-analytical"][1]
    assert lines[1:-1] == ref_lines[1:-1]
    assert len(lines) == 13
    assert "reference" in lines[0]


def test_autoshard_zoo_cell_plans_at_80gb(tmp_path):
    """The cell as it runs: every arch fits the chip table's 80 GB."""
    _, lines = run_port(PA, ("autoshard", "zoo", "analytical"), tmp_path)
    assert "NVIDIA H100 SXM, 80 GB budget" in lines[0]
    assert all(row.split(",")[5] == "Y" for row in lines[2:-1])


def test_autoshard_soak_cell_equals_reference(reference, port, tmp_path):
    _, lines = port("autoshard/service-soak")
    _, ref_lines, ref_dir = reference["autoshard/service-soak"]
    tenants = [ln for ln in lines if not ln.startswith("#")]
    assert tenants == as_port([ln for ln in ref_lines
                               if not ln.startswith("#")])
    assert len(tenants) == 5 and "t2,wami,cuda,True" in tenants[3]
    got = _json(tmp_path / "BENCH_serve.json")
    want = _json(ref_dir / "BENCH_serve.json")
    for key in ("tenants", "tenant_invocations", "shared_invocations",
                "saved_invocations"):
        assert got[key] == want[key], key
    assert ({s.replace("cuda", "pallas"): p["invocations"]
             for s, p in got["pools"].items()}
            == {s: p["invocations"] for s, p in want["pools"].items()})


def test_autoshard_trace_cell_equals_reference(reference, port, tmp_path):
    _, lines = port("autoshard/service-trace")
    _, ref_lines, ref_dir = reference["autoshard/service-trace"]
    assert lines == ref_lines
    name = os.path.join("autoshard", "service-trace.trace.json")
    assert _json(tmp_path / name) == _json(ref_dir / name)


@pytest.mark.parametrize("app", ["fleet", "wami"])
def test_kernels_analytical_cell_times_the_reference_s_cases(
        app, reference, port):
    _, lines = port(f"kernels/{app}-analytical")
    ref_lines = reference[f"kernels/{app}-analytical"][1]
    assert ([ln.split(",")[0] for ln in lines[1:]]
            == [ln.split(",")[0] for ln in ref_lines[1:]])
    assert lines[1] == "kernel,us_per_call_ref"
    assert all(float(ln.split(",")[1]) > 0 for ln in lines[2:])


def test_kernels_cuda_cell_refuses_the_cpu(tmp_path):
    from repro_torch.bench.run import CellReport
    from repro_torch.bench.scenarios import Cell
    cell = Cell("kernels", "wami", "cuda")
    with pytest.raises(RuntimeError, match="CUDA card"):
        PK.run(CellReport(cell, str(tmp_path)), cell, device="cpu")


# a dry-run record as the port's dry run writes it (the keys both
# packages' records share), one that skipped and one that failed
_RECORD = {
    "status": "ok", "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "pod",
    "devices": 256,
    "cost": {"flops_per_device": 3.1e15},
    "memory": {"argument_bytes": 5.5e9, "temp_bytes": 7.25e9,
               "output_bytes": 1.0e9},
    "roofline": {"t_compute_s": 0.01234, "t_memory_s": 0.0456,
                 "t_collective_s": 0.00789, "t_bound_s": 0.0456,
                 "bound": "memory"},
}


def _roofline_records(root):
    os.makedirs(root, exist_ok=True)
    big = dict(_RECORD, shape="prefill_32k", mesh="multipod",
               memory={"argument_bytes": 12e9, "temp_bytes": 9e9,
                       "output_bytes": 0.5e9})
    records = {"a.json": _RECORD, "b.json": big,
               "c.json": {"status": "skip", "arch": "kimi-k2-1t-a32b",
                          "shape": "decode_32k", "mesh": "pod",
                          "skip_reason": "does not divide " * 8},
               "d.json": {"status": "error", "arch": "gemma2-9b",
                          "shape": "train_4k", "mesh": "pod"},
               "e__tuned.json": _RECORD}
    for name, rec in records.items():
        with open(os.path.join(root, name), "w") as f:
            json.dump(rec, f)


def test_roofline_rows_equal_reference_on_one_record(tmp_path, monkeypatch):
    art = str(tmp_path / "dryrun")
    _roofline_records(art)
    monkeypatch.setattr(RR, "ART", art)
    monkeypatch.setattr(PR, "ART", art)
    _, ref_lines = run_reference(RR, ("roofline", "zoo", "dryrun"),
                                 tmp_path / "ref")
    report, lines = run_port(PR, ("roofline", "zoo", "dryrun"),
                             tmp_path / "port")
    assert lines[0] == ("# Roofline table (per device; NVIDIA H100 SXM: "
                        "989TF bf16, 3350GB/s HBM, 450GB/s link)")
    assert lines[1].endswith(",hbm_gb,fits_80g")
    assert lines[1].rsplit(",", 1)[0] == ref_lines[1].rsplit(",", 1)[0]
    assert len(lines) == len(ref_lines) == 6
    # the 21.5 GB record fits the card's 80 GB, not the reference's 16
    for got, want in zip(lines[2:], ref_lines[2:]):
        if got.startswith("qwen2-0.5b,prefill_32k"):
            assert (got[-1], want[-1]) == ("Y", "N")
            got, want = got[:-1], want[:-1]
        assert got == want
    assert report.rows[0].endswith("cells=2_slowest=qwen2-0.5b/train_4k/pod")


def test_roofline_reads_the_port_s_dry_run_records(tmp_path, monkeypatch):
    """The cell reads ``artifacts/dryrun_torch/`` (the port's dry run's
    directory); with no record there it prints the header only."""
    from repro_torch.launch import dryrun
    assert os.path.realpath(PR.ART) == os.path.realpath(dryrun.ARTIFACTS)
    assert os.path.basename(os.path.normpath(PR.ART)) == "dryrun_torch"
    monkeypatch.setattr(PR, "ART", str(tmp_path / "none"))
    _, lines = run_port(PR, ("roofline", "zoo", "dryrun"), tmp_path)
    assert len(lines) == 2


# ----------------------------------------------------------------------
# the standalone gates chip_smoke.py runs on the card
# ----------------------------------------------------------------------
def test_fig11_smoke_equals_reference(capsys):
    assert P11.smoke() == 0
    got = capsys.readouterr().out.split("(")[0]
    assert R11.smoke() == 0
    assert got == capsys.readouterr().out.split("(")[0]
    assert "ratio=" in got


def test_fig10_smoke_on_the_card_s_recordings_equals_reference(capsys):
    assert P10.smoke("cuda", device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    with reference_on_card_recordings():
        assert R10.smoke("pallas") == 0
    want = capsys.readouterr().out.splitlines()
    assert got == [ln.replace("pallas", "cuda") for ln in want]
    assert got[0] == "fig10-smoke backend=cuda share-plm points=10"
    assert os.path.exists(card_path(128))


@pytest.mark.parametrize("backend", ["analytical", "cuda"])
def test_fleet_smoke_equals_reference(backend, capsys):
    with port_on_reference_chip():
        assert PF.smoke(backend, device="cpu") == 0
    got = capsys.readouterr().out.split("(")[0]
    with reference_on_card_recordings():
        assert RF.smoke("pallas" if backend == "cuda" else backend) == 0
    want = capsys.readouterr().out.split("(")[0]
    assert got == want.replace("pallas", "cuda")
