"""The PyTorch fleet drives against the JAX package's, byte for byte.

  * measured, timer: the port's ``CudaOracle`` over
    ``fleet_cuda_components`` and the reference ``PallasOracle`` over
    ``fleet_kernel_specs`` in measure mode with one deterministic timer
    (nothing is executed), under the reference's 16 MiB budget and under
    an H100's 232,448-byte shared memory per block;
  * analytical: the port's ``XLATool``, given the reference's TPU
    constants (read from ``repro.core.xlatool``/``autotune`` here, in the
    test; the port itself carries only the H100 chip table), prices every
    knob point and drives COSMOS exactly as ``build_session("fleet",
    "analytical")`` does.
"""

import pytest
import torch

import repro.apps.fleet.pipeline as JF
from repro.core import (ExplorationSession as JSession, PallasOracle,
                        exhaustive_dse as j_exhaustive)
from repro.core import autotune as JA
from repro.core import xlatool as JX
from repro.core.registry import build_session
import repro_torch.apps.fleet.pipeline as TF
from repro_torch.core import (CudaOracle, MeasurementSet, MeasurementStore,
                              exhaustive_dse)
from repro_torch.core.chips import H100_SXM, ChipSpec
from repro_torch.core.xlatool import XLATool

SMEM_16MIB = 16 * 1024 * 1024          # the reference's VMEM budget
SMEM_H100 = 232448                     # an H100's opt-in smem per block
REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)


def _timer(name, ports, unrolls, runner):
    """Deterministic stand-in for the device time (never runs
    ``runner``): Amdahl-ish in the unrolls, sub-linear in ports."""
    return (1e-3 * (32 / unrolls) + 2e-4 * ports ** 0.5
            + 1e-5 * len(name))


def _port_oracle(budget, **kw):
    return TF.fleet_cuda_oracle(device="cpu", device_kind="interpret",
                                smem_budget=budget, **kw)


def _books(session, res):
    return (repr(res.mapped), repr(res.characterizations),
            repr(res.planned), res.invocations,
            session.ledger.records_by_phase(), dict(session.ledger.failed),
            (res.theta_min, res.theta_max))


@pytest.mark.parametrize("frames", [2, 3])
def test_tmg_and_knob_spaces_are_the_reference_s(frames):
    ref, port = JF.fleet_tmg(frames), TF.fleet_tmg(frames)
    assert [t.name for t in port.transitions] == [
        t.name for t in ref.transitions]
    assert repr(port.places) == repr(ref.places)
    delays = {"flash_attention": 1.5, "ssd_scan": 0.7}
    assert port.throughput(delays) == ref.throughput(delays)
    assert repr(TF.fleet_knob_spaces()) == repr(JF.fleet_knob_spaces())
    for name in ("FLASH_S", "FLASH_D", "FLASH_HEADS", "SSD_S", "SSD_P",
                 "SSD_N", "SSD_MAX_HEADS"):
        assert getattr(TF, name) == getattr(JF, name)


def test_kernel_specs_are_the_reference_s():
    ref = JF.fleet_kernel_specs()
    port = TF.fleet_cuda_components(device="cpu")
    assert tuple(port) == tuple(ref)
    for name, spec in port.items():
        r = ref[name]
        assert (spec.shape, spec.n_in, spec.n_out) == (r.shape, r.n_in,
                                                       r.n_out)
        for p in range(1, 5):
            for u in range(1, 9):
                assert spec.divisible(p, u) == r.divisible(p, u)
                assert spec.states(p, u) == r.states(p, u)


@pytest.mark.parametrize("budget", [SMEM_16MIB, SMEM_H100])
def test_timer_drive_and_exhaustive_are_byte_identical(budget):
    ref = PallasOracle(JF.fleet_kernel_specs(), mode="measure",
                       timer=_timer, vmem_budget=budget)
    port = _port_oracle(budget, timer=_timer)
    s_ref = JSession(JF.fleet_tmg(), ref, JF.fleet_knob_spaces(),
                     delta=0.3, fixed={})
    s_port = TF.fleet_cuda_session(oracle=port)
    res = s_port.run()
    assert _books(s_port, res) == _books(s_ref, s_ref.run())
    # the counts of the reference's walk under each budget
    assert (res.total_invocations, s_port.ledger.failed.get(
        "flash_attention"), len(res.pareto())) == {
        SMEM_16MIB: (29, 7, 8), SMEM_H100: (34, 11, 9)}[budget]
    names = list(JF.fleet_knob_spaces())
    e_ref = j_exhaustive(names, ref, JF.fleet_knob_spaces())
    e_port = exhaustive_dse(names, port, TF.fleet_knob_spaces())
    assert repr(e_port.fronts) == repr(e_ref.fronts)
    assert e_port.invocations == e_ref.invocations
    assert e_port.total_invocations == 40


def test_card_budget_rules_out_two_flash_points():
    card = _port_oracle(SMEM_H100, timer=_timer)
    tpu = _port_oracle(SMEM_16MIB, timer=_timer)
    for unrolls in (4, 8):
        s = card.synthesize("flash_attention", ports=1, unrolls=unrolls)
        assert not s.feasible
        assert tpu.synthesize("flash_attention", ports=1,
                              unrolls=unrolls).feasible
    ok = card.synthesize("flash_attention", ports=1, unrolls=2)
    assert ok.feasible and ok.detail["vmem_step_bytes"] == 115712.0


def test_record_then_replay_gives_the_same_front(tmp_path):
    path = str(tmp_path / "fleet_cuda.json")
    rec = _port_oracle(SMEM_H100, mode="record", store_path=path,
                       timer=_timer)
    res = TF.fleet_cuda_session(oracle=rec).run()
    assert rec.flush() == path
    store = MeasurementStore.load(path)
    assert store.device_kind == "interpret" and store.tile == 0
    assert {k[0] for k in store.entries} == {"flash_attention", "ssd_scan"}
    replay = _port_oracle(SMEM_H100, mode="replay",
                          measurements=MeasurementSet.from_store(store))
    assert repr(TF.fleet_cuda_session(oracle=replay).run().mapped) \
        == repr(res.mapped)


def test_default_recording_is_a_new_file():
    assert TF.default_measurement_path().endswith(
        "artifacts/measurements/fleet_cuda.json")
    assert TF.default_measurement_path() != JF.default_measurement_path()


def test_xla_tool_prices_like_the_reference_at_every_knob_point():
    ref = JF.fleet_xla_tool()
    port = TF.fleet_xla_tool(chip=REF_CHIP)
    assert isinstance(port, XLATool)
    for comp in ("flash_attention", "ssd_scan"):
        for ports in (1, 2, 4, 8):
            for unrolls in range(1, 9):
                got = port.synthesize(comp, ports=ports, unrolls=unrolls)
                want = ref.synthesize(comp, ports=ports, unrolls=unrolls)
                assert repr(got) == repr(want)
                if got.feasible:
                    assert repr(port.cdfg_facts(comp, got)) == repr(
                        ref.cdfg_facts(comp, want))


def test_analytical_front_is_byte_identical_to_build_session():
    s_ref = build_session("fleet", "analytical")
    s_port = TF.fleet_session(chip=REF_CHIP)
    res = s_port.run()
    assert _books(s_port, res) == _books(s_ref, s_ref.run())
    assert res.invocations == {"flash_attention": 12, "ssd_scan": 12}


def test_analytical_drive_on_the_h100_table():
    """The port's default chip is an H100 SXM: 80 GB per chip, so the
    budget admits every point the TPU's 16 GiB admitted."""
    assert TF.fleet_xla_tool().hbm_budget == H100_SXM.hbm_bytes \
        == 80 * 10 ** 9
    ref = TF.fleet_xla_tool(chip=REF_CHIP)
    h100 = TF.fleet_xla_tool()
    for comp in ("flash_attention", "ssd_scan"):
        for ports in (1, 2, 4):
            for unrolls in range(1, 9):
                if ref.synthesize(comp, ports=ports,
                                  unrolls=unrolls).feasible:
                    assert h100.synthesize(comp, ports=ports,
                                           unrolls=unrolls).feasible
    res = TF.fleet_session().run()
    assert res.mapped and len(res.pareto()) >= 1


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        TF.fleet_session(backend="pallas")


def test_cuda_session_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.fleet_cuda_session()
    with pytest.raises(RuntimeError, match="CUDA"):
        TF.fleet_session(backend="cuda")


def test_port_oracle_is_a_cuda_oracle():
    assert isinstance(_port_oracle(SMEM_H100, timer=_timer), CudaOracle)
