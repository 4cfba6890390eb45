"""The card's committed recordings, replayed on the CPU against the JAX
package's replay of the same files, byte for byte.

``artifacts/measurements/wami_cuda_tile{64,128,256}.json`` and
``fleet_cuda.json`` were made in one call on an NVIDIA H100 80GB HBM3 at
its 700.00 W power limit by ``python3 -m repro_torch.examples.wami_cuda
--record --tile T`` (T = 128, 64, 256) and ``python3 -m
repro_torch.examples.fleet_cuda --record``, into an empty directory.

  * provenance: each file loads in both packages and carries the card's
    name, power limit and shared-memory budget, its tile, and entries
    for every measured stage;
  * parity: the port's replay (``device="cpu"``: the device kind and the
    budget come from the recording) and the JAX package's
    ``PallasOracle`` replay (``device_kind`` the card's,
    ``vmem_budget=232448``) give the same ``repr(mapped)``, invocations
    and ``records_by_phase()``; so does the share-PLM drive over tiles
    64 and 128 against the JAX package's registry drive;
  * coverage: a replay equals a fresh record-mode drive whose timer
    returns the recorded wall of each point (the JAX package's replay ==
    record gate), and that drive times exactly the recorded points;
  * calibration: ``calibrate_to_records`` and the unit fits equal the
    JAX package's on the same records;
  * the card's numbers: each replay gives what the recording call
    printed (``PRINTED``).
"""

import dataclasses
import os

import pytest

import repro.apps.fleet.pipeline as JF
import repro.apps.wami.pallas as JW
import repro.apps.wami.pipeline as JP
from repro.core import (MeasurementSet as JSet, MeasurementStore as JStore,
                        PallasOracle, calibrate_to_records as j_calibrate)
from repro.core import autotune as JA
from repro.core.analysis import lint as JL
from repro.core import registry as JR
from repro.core import xlatool as JX
import repro_torch.apps.fleet.pipeline as TF
import repro_torch.apps.wami.cuda as TC
import repro_torch.apps.wami.pipeline as TP
from repro_torch.core import MeasurementStore, build_session
from repro_torch.core import calibrate_to_records
from repro_torch.core.analysis import lint as TL
from repro_torch.core.chips import ChipSpec
from repro_torch.core.cuda_oracle import H100_SMEM_OPTIN_BYTES
from repro_torch.examples import fleet_cuda, wami_cuda, wami_plm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASUREMENTS = os.path.join(REPO, "artifacts", "measurements")
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"
SMEM_H100 = 232448
TILES = (64, 128, 256)
FLEET = "fleet_cuda.json"
REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)


def _wami(tile):
    return f"wami_cuda_tile{tile}.json"


def _path(name):
    return os.path.join(MEASUREMENTS, name)


_MATRIX = dict(matrix_sub=11, sd_update=14, matrix_mul=7, matrix_add=8,
               matrix_resh=6)
# What the recording call printed for each drive (on the card above):
# invocations by component and by phase, mapped points, front size,
# theta range (the fleet's recorder prints its mapped rows instead), the
# infeasible invocations of each kernel stage, the points recorded, and
# the front (theta, cost) as printed.
PRINTED = {
    _wami(128): dict(
        invocations=dict(debayer=26, grayscale=10, gradient=10,
                         steep_descent=8, hessian=11, warp=8, **_MATRIX,
                         change_det=16),
        by_phase=dict(characterize=125, map=10), mapped=10, front=7,
        theta=("56.49", "336.98"), failed=dict(debayer=16, change_det=8),
        points=65,
        front_points=[("101.66", "182561.6"), ("116.26", "182561.6"),
                      ("178.25", "182562.0"), ("216.13", "182562.4"),
                      ("270.78", "182562.6"), ("336.85", "182563.2"),
                      ("336.98", "250147.2")]),
    _wami(64): dict(
        invocations=dict(debayer=10, grayscale=10, gradient=10,
                         steep_descent=8, hessian=11, warp=8, **_MATRIX,
                         change_det=8),
        by_phase=dict(characterize=101, map=10), mapped=10, front=7,
        theta=("56.49", "336.98"), failed={}, points=64,
        front_points=[("101.66", "114977.6"), ("116.26", "114977.6"),
                      ("178.26", "114978.0"), ("216.13", "114978.4"),
                      ("270.78", "114978.6"), ("336.85", "114979.2"),
                      ("336.98", "189731.2")]),
    _wami(256): dict(
        invocations=dict(debayer=50, grayscale=26, gradient=26,
                         steep_descent=16, hessian=27, warp=8, **_MATRIX,
                         change_det=28),
        by_phase=dict(characterize=217, map=10), mapped=10, front=7,
        theta=("56.49", "336.98"),
        failed=dict(debayer=40, grayscale=16, gradient=16, steep_descent=8,
                    hessian=16, change_det=20),
        points=64,
        front_points=[("101.66", "299297.6"), ("116.26", "299297.6"),
                      ("178.25", "299298.0"), ("216.13", "299298.4"),
                      ("270.78", "299298.6"), ("336.84", "299299.2"),
                      ("336.98", "524579.2")]),
    FLEET: dict(
        invocations=dict(flash_attention=15, ssd_scan=6),
        by_phase=dict(characterize=18, map=3), mapped=7, front=4,
        failed=dict(flash_attention=7),
        points=13,
        rows=["39928.448,424192.000,1,1,2,2", "70390.809,477440.000,2,2,2,2",
              "73820.350,542976.000,2,4,2,2", "73820.350,542976.000,2,4,2,2",
              "156621.977,1018880.000,4,4,4,4",
              "156621.977,1018880.000,4,4,4,4",
              "156621.977,1018880.000,4,4,4,4"]),
}
# the recording call's calibration of tile 128 (on the card above):
# per-component latency scale as printed, and the theta ranges
PRINTED_CALIBRATION_128 = (
    {"change_det": "0.000895", "debayer": "0.00128", "gradient": "0.00107",
     "grayscale": "0.00143", "hessian": "0.001", "steep_descent": "0.00138",
     "warp": "0.000267"},
    "[calibrate] theta range, calibrated analytical: [56.49, 336.96] fps "
    "vs measured: [56.49, 336.98] fps")


def _books(session, res):
    return (repr(res.mapped), repr(res.characterizations),
            repr(res.planned), res.invocations,
            session.ledger.records_by_phase(), dict(session.ledger.failed),
            (res.theta_min, res.theta_max))


def _ref_wami(tile):
    oracle = PallasOracle(
        JW.wami_pallas_components(tile), mode="replay",
        measurements=JSet.from_store(JStore.load(_path(_wami(tile))),
                                     tile=tile),
        components_factory=JW.wami_pallas_components,
        fallback=JP.wami_hls_tool(), native_tile=tile, device_kind=CARD,
        vmem_budget=SMEM_H100)
    session = JW.wami_pallas_session(0.25, oracle=oracle, workers=8)
    return session, session.run()


def _ref_fleet():
    oracle = PallasOracle(
        JF.fleet_kernel_specs(), mode="replay",
        measurements=JSet.from_store(JStore.load(_path(FLEET)), tile=0),
        device_kind=CARD, vmem_budget=SMEM_H100)
    session = JR.build_session("fleet", "pallas", tool=oracle, workers=4)
    return session, session.run()


def _port(name):
    """The port's replay through its entry point's drive, on the CPU."""
    if name == FLEET:
        session, res, oracle, _, _ = fleet_cuda.drive(
            "replay", path=_path(name), device="cpu")
    else:
        tile = int(name[len("wami_cuda_tile"):-len(".json")])
        session, res, oracle, _, _ = wami_cuda.drive(
            "replay", tile=tile, path=_path(name), device="cpu")
    return session, res, oracle


def _printed(session, res):
    """A drive's numbers as the recorder prints them."""
    out = dict(invocations=dict(res.invocations),
               by_phase=dict(session.ledger.records_by_phase()),
               mapped=len(res.mapped), front=len(res.pareto()),
               theta=(f"{res.theta_min:.2f}", f"{res.theta_max:.2f}"),
               failed={k: v for k, v in session.ledger.failed.items()
                       if k in session.ledger.tool.components})
    return out


ALL = [_wami(t) for t in TILES] + [FLEET]


# ----------------------------------------------------------------------
# provenance
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_recording_is_the_card_s(name):
    port, ref = MeasurementStore.load(_path(name)), JStore.load(_path(name))
    assert port.entries == ref.entries and port.meta == ref.meta
    assert port.device_kind == ref.device_kind == CARD
    assert port.meta["power_limit"] == POWER_LIMIT
    assert port.smem_budget == SMEM_H100 == H100_SMEM_OPTIN_BYTES
    assert port.meta["interpret"] is False
    assert port.meta["torch_version"] and port.meta["cuda_version"]
    stages = ({"flash_attention", "ssd_scan"} if name == FLEET
              else set(TC.WAMI_CUDA_STAGES))
    assert {k[0] for k in port.entries} == stages
    assert port.tile == ref.tile == (0 if name == FLEET
                                     else int(name[14:-5]))
    assert len(port) == PRINTED[name]["points"]
    assert all(0 < w < 1e-4 for w in port.entries.values())


@pytest.mark.parametrize("name", ALL)
def test_recording_passes_both_packages_schema_rule(name):
    """REG004 of both lints reads the provenance keys as the schema
    allows: ``meta`` is free-form, the entries keep their form."""
    tile = MeasurementStore.load(_path(name)).tile
    for lint in (TL, JL):
        findings = []
        lint._lint_measurement_json("wami", tile, _path(name), findings)
        assert findings == []


def test_a_replay_reads_its_provenance_from_the_recording(monkeypatch):
    """Off the card a replay never asks ``torch.cuda``: the device kind
    and the budget come from the recording's ``meta`` or from explicit
    arguments, and a recording that carries no budget (the JAX
    package's interpret-mode ones) needs ``smem_budget=``."""
    import repro_torch.core.cuda_oracle as CO

    def no_card(*_args, **_kw):
        raise AssertionError("a replay asked the card")

    for name in ("device_kind_of", "device_smem_budget"):
        monkeypatch.setattr(CO, name, no_card)
        monkeypatch.setattr(TC, name, no_card, raising=False)
    oracle = TC.wami_cuda_oracle("replay", device="cpu",
                                 store_path=_path(_wami(64)), tile=64)
    assert (oracle.device_kind, oracle.smem_budget) == (CARD, SMEM_H100)
    tighter = TC.wami_cuda_oracle("replay", device="cpu", tile=64,
                                  store_path=_path(_wami(64)),
                                  smem_budget=65536)
    assert tighter.smem_budget == 65536
    assert not tighter.synthesize("debayer", ports=1, unrolls=32).feasible
    with pytest.raises(ValueError, match="carry no shared-memory budget"):
        TC.wami_cuda_oracle("replay", device="cpu",
                            store_path=JW.default_measurement_path(128))
    interpret = TC.wami_cuda_oracle(
        "replay", device="cpu", smem_budget=16 * 2**20,
        store_path=JW.default_measurement_path(128))
    assert interpret.device_kind == "interpret"


def test_recordings_are_distinct_from_the_reference_s():
    """The card's files are new; the JAX package's interpret-mode ones
    stay where they were."""
    for tile in TILES:
        assert TC.default_measurement_path(tile) == _path(_wami(tile))
        assert JW.default_measurement_path(tile) != _path(_wami(tile))
        assert JStore.load(JW.default_measurement_path(tile)).device_kind \
            == "interpret"
    assert TF.default_measurement_path() == _path(FLEET)


# ----------------------------------------------------------------------
# parity with the JAX package, and the card's printed numbers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tile", TILES)
def test_wami_replay_is_the_reference_s(tile):
    session, res, oracle = _port(_wami(tile))
    j_session, j_res = _ref_wami(tile)
    assert _books(session, res) == _books(j_session, j_res)
    assert oracle.device_kind == CARD and oracle.smem_budget == SMEM_H100
    want = dict(PRINTED[_wami(tile)])
    assert _printed(session, res) == {k: want[k] for k in (
        "invocations", "by_phase", "mapped", "front", "theta", "failed")}
    assert [(f"{p.perf:.2f}", f"{p.cost:.1f}") for p in res.pareto()] \
        == want["front_points"]


def test_fleet_replay_is_the_reference_s():
    session, res, oracle = _port(FLEET)
    j_session, j_res = _ref_fleet()
    assert _books(session, res) == _books(j_session, j_res)
    want = PRINTED[FLEET]
    got = _printed(session, res)
    del got["theta"]
    assert got == {k: want[k] for k in (
        "invocations", "by_phase", "mapped", "front", "failed")}
    assert fleet_cuda.front_lines(res)[1:] == want["rows"]


def _ref_plm_app():
    """The JAX package's WAMI app on the card's recordings: its paths and
    its calibrated fallback read the card's files."""
    app = JR.get_app("wami")
    return dataclasses.replace(
        app, measurement_path=lambda t: _path(_wami(t)),
        calibrated_fallback=lambda store=None: JW.wami_unit_system(
            store=store or JStore.load(_path(_wami(128)))).calibrated(
                JP.wami_hls_tool()))


def test_share_plm_replay_over_tiles_64_and_128_is_the_reference_s():
    port = TC.wami_cuda_plm_session(0.25, workers=8, mode="replay",
                                    measured_tiles=wami_plm.MEASURED_TILES,
                                    device="cpu", verify_plans=True)
    app = _ref_plm_app()
    tool = JR.build_tool(app, "pallas", share_plm=True, tiles=(128, 64),
                         device_kind=CARD, vmem_budget=SMEM_H100)
    ref = JR.build_session(app, "pallas", share_plm=True, tool=tool,
                           workers=8, verify_plans=True)
    res = port.run()
    assert _books(port, res) == _books(ref, ref.run())
    assert port.ledger.tool.measurements.keys() == [(64, CARD), (128, CARD)]
    assert (res.total_invocations, len(res.mapped)) == (223, 10)
    assert res.mapped and all(m.cost_actual <= m.cost_unshared + 1e-9
                              for m in res.mapped)
    assert any(len(g) > 1 for m in res.mapped for g in m.plm_groups)


# ----------------------------------------------------------------------
# coverage: replay == a fresh record driven by the recorded walls
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ALL)
def test_replay_equals_a_record_timed_by_the_recording(name, tmp_path):
    recorded = MeasurementStore.load(_path(name))

    def timer(component, ports, unrolls, _runner):
        return recorded.entries[(component, ports, unrolls)]

    fresh = str(tmp_path / name)
    opts = dict(device="cpu", device_kind=CARD, smem_budget=SMEM_H100,
                store_path=fresh, timer=timer)
    if name == FLEET:
        oracle = TF.fleet_cuda_oracle("record", **opts)
        session = build_session("fleet", "cuda", tool=oracle, workers=1)
    else:
        tile = recorded.tile
        oracle = TC.wami_cuda_oracle("record", tile=tile, **opts)
        session = TC.wami_cuda_session(oracle=oracle, workers=1)
    res = session.run()
    assert oracle.flush() == fresh
    assert MeasurementStore.load(fresh).entries == recorded.entries
    r_session, r_res, _ = _port(name)
    assert _books(r_session, r_res) == _books(session, res)


def test_record_resumes_an_existing_recording(tmp_path):
    """``--record`` onto a file already there resumes it, as the JAX
    package's recorder does: a point it holds is not timed again, and the
    file keeps its provenance."""
    fresh = tmp_path / _wami(64)
    fresh.write_bytes(open(_path(_wami(64)), "rb").read())

    def timer(*_args):
        raise AssertionError("a recorded point was timed again")

    oracle = TC.wami_cuda_oracle("record", tile=64, device="cpu",
                                 device_kind=CARD, smem_budget=SMEM_H100,
                                 store_path=str(fresh), timer=timer)
    TC.wami_cuda_session(oracle=oracle).run()
    oracle.flush()
    again = MeasurementStore.load(str(fresh))
    assert again.entries == MeasurementStore.load(_path(_wami(64))).entries
    assert again.meta["power_limit"] == POWER_LIMIT


# ----------------------------------------------------------------------
# calibration
# ----------------------------------------------------------------------
def test_calibration_is_the_reference_s_and_the_card_s():
    session, res, oracle = _port(_wami(128))
    j_session, _ = _ref_wami(128)
    measured = set(oracle.components)
    fit = calibrate_to_records(TP.wami_hls_tool(), [
        r for r in session.ledger.records if r.component in measured])
    j_fit = j_calibrate(JP.wami_hls_tool(), [
        r for r in j_session.ledger.records if r.component in measured])
    assert repr(fit) == repr(j_fit)
    scales, theta_line = PRINTED_CALIBRATION_128
    assert {k: f"{v:.3g}" for k, v in fit.scales.items()} == scales
    lines = wami_cuda.report("replay", session, res, oracle, None, 0.0)
    assert lines[-1] == theta_line


@pytest.mark.parametrize("tile", TILES)
def test_wami_unit_system_is_the_reference_s(tile):
    port = TC.wami_cuda_unit_system(tile)
    ref = JW.wami_unit_system(tile, store=JStore.load(_path(_wami(tile))))
    assert repr(port) == repr(ref)
    assert port.area_points > 0 and port.unit == "bytes"


def test_fleet_unit_system_is_the_reference_s():
    port = TF.fleet_unit_system(chip=REF_CHIP)
    ref = JF.fleet_unit_system(JStore.load(_path(FLEET)))
    assert repr(port) == repr(ref)


# ----------------------------------------------------------------------
# the footprint model at each recorded tile
# ----------------------------------------------------------------------
# the knob points whose double-buffered block exceeds the card's 232,448
# bytes of shared memory per block, per tile (the ``2 * step`` model,
# kept so that the fronts stay the JAX package's on the same walls)
INFEASIBLE = {
    64: {},
    128: {"debayer": [(1, 32)], "change_det": [(1, 16)]},
    256: {"debayer": [(1, 16), (1, 32), (2, 32)], "grayscale": [(1, 32)],
          "gradient": [(1, 32)], "steep_descent": [(1, 16)],
          "hessian": [(1, 32)],
          "change_det": [(1, 8), (1, 16), (2, 16)]},
}


@pytest.mark.parametrize("tile", TILES)
def test_infeasible_points_at_each_recorded_tile(tile):
    specs = TC.wami_cuda_components(tile, device="cpu")
    spaces = TP.wami_knob_spaces()
    found = {}
    for name, spec in specs.items():
        space = spaces[name]
        H, W = spec.shape
        over = [(p, u) for p in space.ports()
                for u in range(1, space.max_unrolls + 1)
                if spec.divisible(p, u)
                and 2 * spec.vmem_bytes(H, W, ports=p, unrolls=u)
                > SMEM_H100]
        if over:
            found[name] = over
    assert found == INFEASIBLE[tile]
    # every stage keeps recorded walls at every tile
    recorded = {k[0] for k in MeasurementStore.load(
        _path(_wami(tile))).entries}
    assert recorded == set(specs)
