"""The PyTorch DSE drives against the JAX package's, byte for byte.

  * analytical: ``wami_cosmos``/``wami_exhaustive`` in both packages;
  * measured, replay: the reference ``PallasOracle`` and the port's
    ``CudaOracle`` over the four template-side stages {grayscale,
    gradient, steep_descent, hessian} and over all seven kernels,
    everything else priced by ``wami_hls_tool()``, replaying the
    committed ``wami_pallas_tile128.json``;
  * measured, timer: the same two oracles in measure mode with one
    deterministic timer (nothing is executed), under the reference's
    16 MiB budget and under the card's 232,448-byte shared memory.
"""

import json
import math

import pytest
import torch

from repro.apps.wami.pallas import (default_measurement_path,
                                    wami_pallas_components)
import repro.apps.wami.pipeline as JP
from repro.core import (ExplorationSession as JSession,
                        MeasurementSet as JSet, MeasurementStore as JStore,
                        PallasOracle, exhaustive_dse as j_exhaustive)
from repro_torch.apps.wami import cuda as TC
import repro_torch.apps.wami.pipeline as TP
from repro_torch.core import (CudaOracle, MeasurementSet, MeasurementStore,
                              MissingMeasurementError, exhaustive_dse)

STAGES = ("grayscale", "gradient", "steep_descent", "hessian")
SMEM_16MIB = 16 * 1024 * 1024          # the reference's VMEM budget
SMEM_H100 = 232448                     # an H100's opt-in smem per block


def _timer(name, ports, unrolls, runner):
    """Deterministic stand-in for the device time (never runs
    ``runner``): Amdahl-ish in the unrolls, sub-linear in ports."""
    return (1e-3 * (32 / unrolls) + 2e-4 * ports ** 0.5
            + 1e-5 * len(name))


@pytest.fixture(scope="module")
def ref_specs():
    comps = wami_pallas_components(128)
    return {n: comps[n] for n in STAGES}


def _ref_oracle(specs, **kw):
    return PallasOracle(specs, fallback=JP.wami_hls_tool(), native_tile=128,
                        **kw)


def _port_oracle(**kw):
    """The port's seven-stage WAMI oracle on the CPU."""
    kw.setdefault("device_kind", "interpret")
    kw.setdefault("smem_budget", SMEM_16MIB)
    return TC.wami_cuda_oracle(device="cpu", **kw)


def _port_oracle_over(stages, **kw):
    """The port's oracle with only ``stages`` measured, the rest priced
    by the fallback (the counterpart of ``_ref_oracle``)."""
    comps = TC.wami_cuda_components(128, device="cpu")
    kw.setdefault("smem_budget", SMEM_16MIB)
    return CudaOracle({n: comps[n] for n in stages},
                      fallback=TP.wami_hls_tool(), device="cpu",
                      device_kind="interpret", native_tile=128, **kw)


def _ref_session(oracle):
    return JSession(JP.wami_tmg(), oracle, JP.wami_knob_spaces(), delta=0.25,
                    fixed={"matrix_inv": JP.MATRIX_INV_LATENCY_S})


def _books(session, res):
    return (repr(res.mapped), repr(res.characterizations),
            repr(res.planned), res.invocations,
            session.ledger.records_by_phase(), dict(session.ledger.failed),
            (res.theta_min, res.theta_max))


def test_analytical_cosmos_is_byte_identical():
    ref, port = JP.wami_cosmos(), TP.wami_cosmos()
    assert repr(port.mapped) == repr(ref.mapped)
    assert repr(port.characterizations) == repr(ref.characterizations)
    assert port.invocations == ref.invocations
    assert list(port.invocations) == list(ref.invocations)


def test_analytical_exhaustive_is_byte_identical():
    ref, port = JP.wami_exhaustive(), TP.wami_exhaustive()
    assert repr(port.fronts) == repr(ref.fronts)
    assert port.invocations == ref.invocations
    assert port.total_invocations == ref.total_invocations == 949


def test_measured_replay_is_byte_identical(ref_specs):
    path = default_measurement_path(128)
    ref = _ref_oracle(ref_specs, mode="replay",
                      measurements=JSet.from_store(JStore.load(path),
                                                   tile=128))
    port = _port_oracle_over(STAGES, mode="replay",
                             measurements=MeasurementSet.from_store(
                                 MeasurementStore.load(path), tile=128))
    s_ref = _ref_session(ref)
    s_port = TC.wami_cuda_session(oracle=port)
    assert _books(s_port, s_port.run()) == _books(s_ref, s_ref.run())
    assert s_port.ledger.total() > 0
    # the walls came from the recording: measured stages carry wall_s
    measured = [r for r in s_port.ledger.records
                if r.component in STAGES and r.feasible]
    assert measured


def test_measured_timer_drive_and_exhaustive_are_byte_identical(ref_specs):
    ref = _ref_oracle(ref_specs, mode="measure", timer=_timer)
    port = _port_oracle_over(STAGES, mode="measure", timer=_timer)
    s_ref = _ref_session(ref)
    s_port = TC.wami_cuda_session(oracle=port)
    assert _books(s_port, s_port.run()) == _books(s_ref, s_ref.run())
    names = list(JP.wami_knob_spaces())
    e_ref = j_exhaustive(names, ref, JP.wami_knob_spaces())
    e_port = exhaustive_dse(names, port, TP.wami_knob_spaces())
    assert repr(e_port.fronts) == repr(e_ref.fronts)
    assert e_port.invocations == e_ref.invocations


def test_seven_stages_have_the_reference_specs():
    ref = wami_pallas_components(128)
    port = TC.wami_cuda_components(128, device="cpu")
    assert tuple(port) == tuple(ref) == TC.WAMI_CUDA_STAGES
    for name, spec in port.items():
        r = ref[name]
        assert (spec.shape, spec.n_in, spec.n_out) == (r.shape, r.n_in,
                                                       r.n_out)
        for ports in (1, 2, 8):
            for unrolls in (1, 4, 16):
                for fn, rfn in ((spec.vmem_bytes, r.vmem_bytes),
                                (spec.grid_steps, r.grid_steps)):
                    assert (fn(128, 128, ports=ports, unrolls=unrolls)
                            == rfn(128, 128, ports=ports, unrolls=unrolls))


def test_seven_stage_replay_is_byte_identical():
    """All seven kernels replay their walls from the committed recording;
    only the 6x6 matrix stages are priced by the fallback."""
    path = default_measurement_path(128)
    ref = _ref_oracle(wami_pallas_components(128), mode="replay",
                      measurements=JSet.from_store(JStore.load(path),
                                                   tile=128))
    port = _port_oracle(mode="replay", measurements=MeasurementSet.from_store(
        MeasurementStore.load(path), tile=128))
    s_ref = _ref_session(ref)
    s_port = TC.wami_cuda_session(oracle=port)
    res = s_port.run()
    assert _books(s_port, res) == _books(s_ref, s_ref.run())
    assert res.total_invocations == 135
    assert len(res.mapped) == 10 and len(res.pareto()) == 9
    # the walls the oracle priced came from the recording, one set per
    # kernel stage
    assert {key[0] for key in port._measured} == set(TC.WAMI_CUDA_STAGES)


@pytest.mark.parametrize("budget", [SMEM_16MIB, SMEM_H100])
def test_seven_stage_timer_drive_and_exhaustive_are_byte_identical(budget):
    """The card's walk (the 232,448-byte budget) and the TPU's (16 MiB)
    both equal the reference's under the same budget."""
    specs = wami_pallas_components(128)
    ref = _ref_oracle(specs, mode="measure", timer=_timer,
                      vmem_budget=budget)
    port = _port_oracle(mode="measure", timer=_timer, smem_budget=budget)
    s_ref = _ref_session(ref)
    s_port = TC.wami_cuda_session(oracle=port)
    res = s_port.run()
    assert _books(s_port, res) == _books(s_ref, s_ref.run())
    failed = s_port.ledger.failed
    # the counts of the reference's walk under each budget
    assert (res.total_invocations, failed.get("debayer"),
            failed.get("change_det"), len(res.pareto())) == {
        SMEM_16MIB: (220, 11, 10, 8), SMEM_H100: (239, 26, 15, 9)}[budget]
    names = list(JP.wami_knob_spaces())
    e_ref = j_exhaustive(names, ref, JP.wami_knob_spaces())
    e_port = exhaustive_dse(names, port, TP.wami_knob_spaces())
    assert repr(e_port.fronts) == repr(e_ref.fronts)
    assert e_port.invocations == e_ref.invocations
    assert e_port.total_invocations == 949


def test_card_budget_rules_out_the_largest_blocks():
    """Under an H100's shared memory per block the double-buffered block
    of debayer at (1, 32) and of change detection at (1, 16) no longer
    fits; under the TPU's 16 MiB it does."""
    card = _port_oracle(mode="measure", timer=_timer, smem_budget=SMEM_H100)
    tpu = _port_oracle(mode="measure", timer=_timer)
    for comp, unrolls, step in (("debayer", 32, 196608),
                                ("change_det", 16, 163840)):
        s = card.synthesize(comp, ports=1, unrolls=unrolls)
        assert not s.feasible and math.isinf(s.lam)
        ok = tpu.synthesize(comp, ports=1, unrolls=unrolls)
        assert ok.feasible and ok.detail["vmem_step_bytes"] == step
        assert card.synthesize(comp, ports=2, unrolls=unrolls).feasible


def test_shared_memory_budget_is_the_lambda_constraint():
    oracle = _port_oracle(mode="measure", timer=_timer)
    ok = oracle.synthesize("hessian", ports=1, unrolls=32)
    assert ok.feasible and ok.detail["vmem_step_bytes"] == 98448.0
    tight = _port_oracle(mode="measure", timer=_timer, smem_budget=196895)
    s = tight.synthesize("hessian", ports=1, unrolls=32)
    assert not s.feasible and math.isinf(s.lam)
    assert tight.synthesize("hessian", ports=2, unrolls=32).feasible


def test_store_format_round_trips_with_the_reference(tmp_path):
    path = str(tmp_path / "rec.json")
    store = MeasurementStore(path, meta={"tile": 128, "interpret": False,
                                         "device_kind": "NVIDIA H100"})
    store.put(("gradient", 2, 4), 1.5e-6)
    store.put(("grayscale", 1, 8), 2.5e-6)
    store.save()
    ref = JStore.load(path)
    assert ref.entries == store.entries
    assert ref.device_kind == "NVIDIA H100" and ref.tile == 128
    ref.save(str(tmp_path / "ref.json"))
    with open(path) as a, open(tmp_path / "ref.json") as b:
        assert json.load(a) == json.load(b)
    replay = _port_oracle(mode="replay", device_kind="NVIDIA H100",
                          measurements=MeasurementSet.from_store(
                              MeasurementStore.load(path), tile=128))
    s = replay.synthesize("gradient", ports=2, unrolls=4)
    assert s.feasible and s.detail["wall_s"] == 1.5e-6
    with pytest.raises(MissingMeasurementError):
        replay.synthesize("gradient", ports=1, unrolls=8)


def test_record_mode_writes_the_timings(tmp_path):
    path = str(tmp_path / "wami_cuda_tile128.json")
    oracle = _port_oracle(mode="record", store_path=path, timer=_timer)
    assert isinstance(oracle, CudaOracle)
    oracle.synthesize("grayscale", ports=2, unrolls=4)
    assert oracle.flush() == path
    rec = MeasurementStore.load(path)
    assert rec.entries == {("grayscale", 2, 4): _timer("grayscale", 2, 4,
                                                       None)}
    assert rec.device_kind == "interpret" and rec.tile == 128


def test_cuda_session_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.wami_cuda_session()
