"""The port's front doors (``repro_torch.examples``) on the CPU, against
the JAX package's ``examples/`` scripts.

  * ``wami_dse``: the deterministic lines (``[table1]``, ``[fig11]`` and
    the ``[fig10]`` curve) equal the reference script's, run by
    ``runpy`` with its stdout captured;
  * ``wami_plm``: every line equals the reference script's when that
    script is pointed at the same card recordings (its module's
    recording path, its oracle's device kind and budget and its drive's
    measured tiles set here, in the test: nothing in ``examples/`` or
    the JAX package changes); the unit the port names is shared-memory
    bytes where the reference names VMEM bytes;
  * ``wami_cuda`` and ``fleet_cuda`` replay the committed card
    recordings and print the JAX package's replay fronts of the same
    files; ``--record`` off the card exits non-zero;
  * ``autoshard`` prints the reference's walk at the card's 80 GB;
  * ``quickstart``, ``serve_lm`` and ``train_lm`` run at reduced sizes
    (``train_lm``'s config shrunk here), and quickstart's COSMOS line
    equals the reference script's.
"""

import dataclasses
import functools
import os
import runpy
import sys

import pytest

import repro.apps.fleet.pipeline as JF
import repro.apps.wami.pallas as JW
import repro.apps.wami.pipeline as JP
from repro.core import (MeasurementSet as JSet, MeasurementStore as JStore,
                        PallasOracle)
from repro.core import autotune as JA
from repro.core.oracle import OracleLedger as JLedger
from repro.core.registry import build_session as j_build_session
from repro.configs import get_config as j_get_config
from repro_torch.configs import SHAPES, list_archs
from repro_torch.examples import (autoshard, fleet_cuda, quickstart,
                                  serve_lm, train_lm, wami_cuda, wami_dse,
                                  wami_plm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASUREMENTS = os.path.join(REPO, "artifacts", "measurements")
SMEM_H100 = 232448                  # the budget the recordings carry
CARD = "NVIDIA H100 80GB HBM3"      # their device kind


def _cuda_path(tile=128):
    return os.path.join(MEASUREMENTS, f"wami_cuda_tile{tile}.json")


FLEET_PATH = os.path.join(MEASUREMENTS, "fleet_cuda.json")


def _reference_script(name, capsys, argv=()):
    """The stdout lines of ``examples/<name>.py`` run as a script."""
    capsys.readouterr()
    old = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    return capsys.readouterr().out.splitlines()


def _port_main(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def _fig10_block(lines):
    start = next(i for i, ln in enumerate(lines) if ln.startswith("[fig10]"))
    block = [lines[start]]
    for ln in lines[start + 1:]:
        if not ln.startswith("   theta"):
            break
        block.append(ln)
    return block


def test_wami_dse_prints_the_reference_s_table1_fig11_fig10(capsys):
    ref = _reference_script("wami_dse", capsys)
    port = _port_main(wami_dse.main, ["--device", "cpu"], capsys)
    for tag in ("[table1]", "[fig11]"):
        want = [ln for ln in ref if ln.startswith(tag)]
        assert want and [ln for ln in port if ln.startswith(tag)] == want
    assert _fig10_block(port) == _fig10_block(ref)
    assert len(_fig10_block(port)) == 10
    # the functional run moved the 8 x 8 block into the foreground
    wami = [ln for ln in port if ln.startswith("[wami]")]
    assert len(wami) == 1 and "100% inside" in wami[0]


def test_wami_plm_prints_the_reference_script_s_lines(capsys, monkeypatch):
    monkeypatch.setattr(JW, "default_measurement_path", _cuda_path)
    monkeypatch.setattr(JW, "PallasOracle", functools.partial(
        PallasOracle, device_kind=CARD, vmem_budget=SMEM_H100))
    monkeypatch.setattr(JW, "wami_plm_session", functools.partial(
        JW.wami_plm_session, measured_tiles=wami_plm.MEASURED_TILES))
    ref = _reference_script("wami_plm", capsys)
    port = _port_main(wami_plm.main, ["--device", "cpu"], capsys)
    assert port == [ln.replace("VMEM bytes", "shared-memory bytes")
                    for ln in ref]
    assert port[-1] == ("[front] shared-PLM front dominates or equals the "
                        "naive sum at every point")
    assert any(ln.startswith("[compat] mutually exclusive") for ln in port)


def _ref_wami_replay(tile):
    oracle = PallasOracle(
        JW.wami_pallas_components(tile), mode="replay",
        measurements=JSet.from_store(JStore.load(_cuda_path(tile)),
                                     tile=tile),
        components_factory=JW.wami_pallas_components,
        fallback=JP.wami_hls_tool(), native_tile=tile, device_kind=CARD,
        vmem_budget=SMEM_H100)
    session = JW.wami_pallas_session(0.25, oracle=oracle, workers=8)
    return session, session.run()


@pytest.mark.parametrize("argv,tile", [
    ([], 128), (["--tile", "64"], 64), (["--tile", "256"], 256),
    (["--recording", _cuda_path(256)], 256)])
def test_wami_cuda_replay_prints_the_reference_s_front(argv, tile, capsys):
    port = _port_main(wami_cuda.main, ["--device", "cpu", *argv], capsys)
    session, res = _ref_wami_replay(tile)
    front = [f"   theta {pt.perf:8.2f} fps   cost {pt.cost:12.1f}"
             for pt in res.pareto()]
    at = port.index(next(ln for ln in port
                         if ln.startswith("[cuda] Pareto front")))
    assert port[at + 1:at + 1 + len(front)] == front
    assert port[at].startswith(f"[cuda] Pareto front (theta in "
                               f"[{res.theta_min:.2f}, {res.theta_max:.2f}]")
    assert port[0].startswith(f"[cuda] replay drive: "
                              f"{res.total_invocations} oracle invocations, "
                              f"{len(res.mapped)} mapped points")
    assert ("[cuda] invocations by phase: " + ", ".join(
        f"{k}={v}" for k, v in sorted(
            session.ledger.records_by_phase().items()))) in port
    assert f"device_kind {CARD}" in port[1]
    assert port[-1].startswith("[calibrate] theta range, calibrated "
                               "analytical: ")


def test_wami_cuda_refuses_a_tile_the_recording_was_not_made_at(capsys):
    with pytest.raises(SystemExit) as e:
        wami_cuda.main(["--device", "cpu", "--tile", "64", "--recording",
                        _cuda_path(128)])
    assert e.value.code != 0
    assert "recorded at tile 128" in capsys.readouterr().err


def test_fleet_cuda_replay_prints_the_reference_s_front(capsys):
    port = _port_main(fleet_cuda.main, ["--device", "cpu"], capsys)
    oracle = PallasOracle(
        JF.fleet_kernel_specs(), mode="replay",
        measurements=JSet.from_store(JStore.load(FLEET_PATH), tile=0),
        device_kind=CARD, vmem_budget=SMEM_H100)
    session = j_build_session("fleet", "pallas", tool=oracle, workers=4)
    res = session.run()
    rows = []
    for m in res.mapped:
        knobs = {o.component: (o.synthesis.ports, o.synthesis.unrolls)
                 for o in m.outcomes}
        fa, ss = knobs["flash_attention"], knobs["ssd_scan"]
        rows.append(f"{m.theta_actual:.3f},{m.cost_actual:.3f},"
                    f"{fa[0]},{fa[1]},{ss[0]},{ss[1]}")
    header = port.index("theta_per_s,total_cost_smem_bytes,flash_ports,"
                        "flash_unrolls,ssd_ports,ssd_unrolls")
    assert port[header + 1:] == rows and rows
    assert port[0].startswith(f"[fleet] replay drive: "
                              f"{res.total_invocations} oracle invocations")


@pytest.mark.parametrize("main", [wami_cuda.main, fleet_cuda.main])
def test_record_off_the_card_fails_loudly(main, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main(["--record", "--device", "cpu", "--out-dir", str(tmp_path)])
    assert e.value.code != 0
    assert "CUDA card" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_autoshard_prints_the_reference_s_walk_at_80_gb(capsys):
    port = _port_main(autoshard.main, [], capsys)
    shape, mesh = SHAPES[0], {"data": 16, "model": 16}
    led = JLedger(JA.XLAOracle())
    want = []
    for arch in list_archs():
        p = JA.choose_train_knobs(j_get_config(arch), shape, mesh,
                                  ledger=led, budget=80e9)
        fit = "Y" if p.est_bytes <= 80e9 else "N"
        want.append(f"{arch:24s} {p.microbatches:3d} {p.remat:6s} "
                    f"{p.accum_dtype:9s} {p.est_bytes / 1e9:8.1f} {fit}")
    assert port[1:1 + len(want)] == want
    assert port[1 + len(want)] == (
        f"-- {led.total()} priced invocations across "
        f"{len(led.invocations)} stages (ladder walk, batched) --")
    assert port[-1] == "unchanged-stage re-plan: 0 new invocations (cache)"


def test_quickstart_trains_generates_and_explores(capsys):
    ref_cosmos = [ln for ln in _reference_script("quickstart", capsys)
                  if ln.startswith("cosmos:")]
    port = _port_main(quickstart.main, ["--device", "cpu"], capsys)
    assert port[0].startswith("available archs: ")
    losses = [float(ln.split()[-1]) for ln in port if ln.startswith("step")]
    assert len(losses) == 3 and all(x == x for x in losses)
    assert any(ln.startswith("generated: [") for ln in port)
    assert [ln for ln in port if ln.startswith("cosmos:")] == ref_cosmos
    assert len(ref_cosmos) == 1


def test_serve_lm_serves_both_smoke_archs(capsys):
    port = _port_main(serve_lm.main, ["--device", "cpu"], capsys)
    served = [ln for ln in port if " tok/s " in ln]
    assert [ln.split()[1] for ln in served] == ["zamba2-2.7b-smoke",
                                                "qwen2-0.5b-smoke"]
    assert "12 requests x 12 tokens" in served[0]
    assert "16 requests x 16 tokens" in served[1]


def test_train_lm_config_is_the_reference_script_s():
    """The reference script's ~90M qwen2 (it builds it inside ``main``)."""
    want = dataclasses.replace(
        j_get_config("qwen2-0.5b"), name="qwen2-110m", n_layers=12,
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab=4096,
        dtype="float32", param_dtype="float32")
    assert dataclasses.asdict(train_lm.qwen2_110m()) == \
        dataclasses.asdict(want)


def test_train_lm_trains_a_reduced_config(capsys, monkeypatch, tmp_path):
    small = dataclasses.replace(
        train_lm.qwen2_110m(), n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256)
    monkeypatch.setattr(train_lm, "qwen2_110m", lambda: small)
    port = _port_main(train_lm.main, ["--device", "cpu", "--steps", "3",
                                      "--ckpt-dir", str(tmp_path)], capsys)
    assert port[0].startswith(f"[train] {train_lm.NAME}: ")
    assert port[-1].startswith("loss drop over 3 steps: ")
    # the run's config is registered for the run only
    assert train_lm.NAME not in list_archs() and len(list_archs()) == 10
