"""The port's App/Backend registry against the JAX package's.

Mirrors tests/test_registry.py (round-trips, unknown-name errors, the
apps x backends support matrix), then holds the port's registry-resolved
drives against the live reference's, byte for byte:

  * ``build_session(app, "analytical")``: front ``repr`` and ledger
    outcome counts, for ``wami`` and ``fleet`` (the fleet's XLA tool
    given the reference's TPU constants, read here in the test);
  * ``build_session(app, "cuda", mode="replay")`` over the reference's
    recordings (``wami_pallas_tile*.json``, ``fleet_pallas.json``,
    device kind ``"interpret"``, the reference's 16 MiB budget) against
    ``build_session(app, "pallas")``; the port's App is pointed at the
    recordings with ``dataclasses.replace``.

The two registries live side by side in one process: the port never
registers into the reference's.
"""

import dataclasses

import pytest

import repro.apps.fleet.pipeline as JF
from repro.apps.wami.pallas import (default_measurement_path as j_wami_path,
                                    wami_pallas_components)
from repro.core import autotune as JA
from repro.core import registry as JR
from repro.core import xlatool as JX
import repro_torch.apps.fleet.pipeline as TF
from repro_torch.core import (App, Backend, CudaOracle, DSEQuery,
                              ExplorationSession, KnobSpace,
                              MeasurementStore, MissingMeasurementError,
                              build_session, build_tool,
                              get_app, get_backend, list_apps, list_backends,
                              register_app)
from repro_torch.core.chips import ChipSpec
from repro_torch.core.hlsim import HLSTool
from repro_torch.core.registry import _APPS
from repro_torch.core.tmg import pipeline_tmg

SMEM_16MIB = 16 * 1024 * 1024          # the reference's VMEM budget
REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)
# the measured backend's options for a CPU replay of the reference's
# interpret-mode recordings
REPLAY = dict(mode="replay", device="cpu", device_kind="interpret",
              smem_budget=SMEM_16MIB)


def _on_ref_recordings(name):
    """The port's app, pointed at the reference's recordings (and, for the
    fleet, at the reference's TPU constants in its analytical tool)."""
    app = get_app(name)
    if name == "wami":
        return dataclasses.replace(app, measurement_path=j_wami_path)
    return dataclasses.replace(
        app, measurement_path=lambda tile=0: JF.default_measurement_path(),
        analytical=lambda: TF.fleet_xla_tool(chip=REF_CHIP),
        calibrated_fallback=lambda store=None: TF.fleet_calibrated_tool(
            store, chip=REF_CHIP))


def _books(session, res):
    return (repr(res.mapped), repr(res.characterizations),
            repr(res.planned), res.invocations,
            session.ledger.records_by_phase(), dict(session.ledger.failed),
            session.ledger.outcome_counts())


# ----------------------------------------------------------------------
# round-trips
# ----------------------------------------------------------------------
def test_builtin_apps_resolve_by_name():
    assert get_app("wami").name == "wami"
    assert get_app("fleet").name == "fleet"
    names = [a.name for a in list_apps()]
    assert "wami" in names and "fleet" in names


def test_builtin_backends_resolve_by_name():
    analytical = get_backend("analytical")
    cuda = get_backend("cuda")
    assert not analytical.measured and cuda.measured
    assert isinstance(cuda, Backend)
    assert {b.name for b in list_backends()} == {"analytical", "cuda"}


def test_unknown_names_list_whats_registered():
    with pytest.raises(KeyError, match="wami"):
        get_app("nonesuch")
    with pytest.raises(KeyError, match="analytical"):
        get_backend("pallas")


def test_register_app_round_trip():
    app = App(
        name="toy-registry-test",
        description="two-stage toy",
        tmg=lambda: pipeline_tmg(["a", "b"]),
        knob_spaces=lambda **_: {n: KnobSpace(clock_ns=1.0, max_ports=2,
                                              max_unrolls=4)
                                 for n in ("a", "b")},
        analytical=lambda: HLSTool({}),
    )
    try:
        register_app(app)
        assert get_app("toy-registry-test") is app
        assert get_backend("analytical").supports(app)
        assert not get_backend("cuda").supports(app)     # no kernel specs
        assert "no CUDA kernel specs" in get_backend("cuda").skip_reason(app)
    finally:
        _APPS.pop("toy-registry-test", None)


# ----------------------------------------------------------------------
# capability metadata
# ----------------------------------------------------------------------
def test_wami_capability_metadata():
    wami = _on_ref_recordings("wami")
    cuda = get_backend("cuda")
    assert cuda.supports(wami)
    assert cuda.supported_tiles(wami) == (64, 128, 256)
    assert set(cuda.supported_tiles(wami)) <= set(wami.recorded_tiles)
    cal = cuda.calibrate(wami)
    assert cal is not None and hasattr(cal, "synthesize")
    # the port's own card recording of the native tile is committed: the
    # fallback is fitted from it
    own = cuda.calibrate(get_app("wami"))
    assert type(own).__name__ == "CalibratedTool"
    assert own.synthesize("sd_update", unrolls=1, ports=1).feasible
    assert cuda.supported_tiles(get_app("wami")) == (64, 128, 256)
    sets = wami.measurement_set((64, 128, 256))
    assert sets.keys() == [(t, "interpret") for t in (64, 128, 256)]
    assert all(len(store) > 0 for store in sets.stores())


def test_fleet_capability_metadata():
    fleet = _on_ref_recordings("fleet")
    assert get_backend("cuda").supports(fleet)
    assert get_backend("cuda").supported_tiles(fleet) == (0,)
    assert get_backend("analytical").supports(fleet)


# ----------------------------------------------------------------------
# the support matrix: every supported pair smoke-constructs
# ----------------------------------------------------------------------
def test_every_supported_pair_smoke_constructs():
    for app in (_on_ref_recordings(a.name) for a in list_apps()):
        for backend in list_backends():
            if not backend.supports(app):
                continue
            opts = REPLAY if backend.measured else {}
            session = build_session(app, backend.name, **opts)
            assert isinstance(session, ExplorationSession)
            assert set(session.spaces) == {
                t.name for t in session.tmg.transitions} - set(app.fixed)


def test_build_tool_returns_the_backend_oracle():
    wami = _on_ref_recordings("wami")
    assert isinstance(build_tool(wami, "cuda", **REPLAY), CudaOracle)
    tool = build_tool("wami", "analytical")
    assert hasattr(tool, "synthesize") and not isinstance(tool, CudaOracle)


def test_build_session_injected_tool_skips_factory():
    marker = build_tool("wami", "analytical")
    session = build_session("wami", "analytical", tool=marker)
    assert session.ledger.tool is marker
    with pytest.raises(ValueError, match="pre-built"):
        build_session("wami", "analytical", tool=marker, mode="replay")


# ----------------------------------------------------------------------
# registry-resolved drives stay byte-identical to the classic wrappers
# ----------------------------------------------------------------------
def test_registry_session_matches_classic_wami_session():
    from repro_torch.apps.wami import wami_session
    a = wami_session(delta=0.3, workers=4).run()
    b = build_session("wami", "analytical", delta=0.3, workers=4).run()
    assert [(m.theta_actual, m.cost_actual) for m in a.mapped] \
        == [(m.theta_actual, m.cost_actual) for m in b.mapped]
    assert a.invocations == b.invocations


# ----------------------------------------------------------------------
# against the live reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["wami", "fleet"])
def test_analytical_session_is_the_reference_s(name):
    port = build_session(_on_ref_recordings(name), "analytical")
    ref = JR.build_session(name, "analytical")
    res = port.run()
    assert _books(port, res) == _books(ref, ref.run())
    assert repr(res.pareto()) == repr(ref.result().pareto())


@pytest.mark.parametrize("name", ["wami", "fleet"])
def test_cuda_replay_is_the_reference_s_pallas_replay(name):
    port = build_session(_on_ref_recordings(name), "cuda", **REPLAY)
    ref = JR.build_session(name, "pallas")
    res = port.run()
    assert _books(port, res) == _books(ref, ref.run())
    assert res.mapped and all(m.cost_unshared is None for m in res.mapped)


def test_the_reference_registry_keeps_its_own_apps():
    """Both registries resolved in one process: the reference's apps are
    still the reference's (the port registers only into its own)."""
    get_app("wami"), get_app("fleet")
    assert JR.get_app("wami").kernel_specs is wami_pallas_components
    assert JR.get_app("fleet").kernel_specs is JF.fleet_kernel_specs
    assert get_app("wami").kernel_specs is not wami_pallas_components
    assert get_backend("cuda") is not JR.get_backend("pallas")


# ----------------------------------------------------------------------
# queries, refusals, record mode
# ----------------------------------------------------------------------
def test_query_session_resolves_like_build_session():
    q = DSEQuery(app="wami", delta=0.3, tile_sizes=[64, 128],
                 share_plm=True)
    assert q.tile_sizes == (64, 128)
    a = ExplorationSession.from_query(q).run()
    b = build_session("wami", "analytical", delta=0.3, share_plm=True,
                      tile_sizes=(64, 128)).run()
    assert repr(a.mapped) == repr(b.mapped)


@pytest.mark.parametrize("flag", ["batch_pricing", "guided"])
def test_pricing_and_surrogate_are_refused_not_ignored(flag):
    """Either flag takes effect on the analytical backend (the tool is
    priced through a grid), and guided characterization is refused on
    the measured backend, which has no grid program."""
    from repro_torch.core import BatchPricer
    s = build_session("wami", "analytical", **{flag: True})
    assert isinstance(s.ledger.tool, BatchPricer)
    assert (s.pricer is not None) == (flag == "guided")
    if flag == "guided":
        with pytest.raises(ValueError, match="analytical pricing grid"):
            build_session("wami", "cuda", guided=True, device="cpu",
                          device_kind="interpret", smem_budget=16 * 2**20)


def test_cuda_backend_needs_the_card_unless_told_otherwise():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_session("wami", "cuda")


def _timer(name, ports, unrolls, runner):
    """A stand-in for the card's clock: a wall per knob point."""
    return 1e-5 * (8 / unrolls) + 1e-6 * ports + 1e-7 * len(name)


def test_record_mode_starts_a_fresh_recording(tmp_path):
    """Record mode with no file on disk starts a fresh store per tile,
    tagged with its tile and device kind; a timer stands in for the card,
    and the flushed recording replays to the same front."""
    app = dataclasses.replace(
        get_app("fleet"), measurement_path=lambda tile=0: str(
            tmp_path / "fleet_cuda.json"))
    opts = dict(device="cpu", device_kind="cpu-timer", smem_budget=232448)
    rec = build_session(app, "cuda", mode="record", timer=_timer, **opts)
    res = rec.run()
    assert rec.ledger.tool.flush() == str(tmp_path / "fleet_cuda.json")
    replay = build_session(app, "cuda", mode="replay", **opts).run()
    assert repr(replay.mapped) == repr(res.mapped)
    store = MeasurementStore.load(str(tmp_path / "fleet_cuda.json"))
    assert (store.tile, store.device_kind) == (0, "cpu-timer")
    assert len(store) == len(rec.ledger.tool.store) > 0


def test_share_plm_without_a_native_recording_refuses_to_price(tmp_path):
    """A share-PLM drive whose native tile has no recording yet has no
    walls to fit the calibrated fallback from: the first point priced
    through it (WAMI's matrix stages have no kernel) raises, naming how
    to record the native tile, instead of pricing in the HLS model's mm²
    beside measured bytes."""
    for mode in ("record", "measure"):
        # a directory per mode: record mode flushes what it times
        app = dataclasses.replace(
            get_app("wami"), measurement_path=lambda t, mode=mode: str(
                tmp_path / f"{mode}_wami_cuda_tile{t}.json"))
        session = build_session(app, "cuda", share_plm=True, mode=mode,
                                tiles=(64, 128), device="cpu",
                                device_kind="cpu-timer",
                                smem_budget=232448, timer=_timer)
        with pytest.raises(MissingMeasurementError,
                           match=r"native tile 128 .*mode='record'"):
            session.run()


def test_share_plm_record_over_kernels_only_needs_no_fit(tmp_path):
    """Every fleet stage has a kernel, so a fresh share-PLM recording
    never prices through the (unfitted) fallback: it runs, plans memory,
    and replays — with the fallback then fitted from the recording — to
    the same front."""
    app = dataclasses.replace(
        get_app("fleet"), measurement_path=lambda tile=0: str(
            tmp_path / "fleet_cuda.json"))
    opts = dict(share_plm=True, device="cpu", device_kind="cpu-timer",
                smem_budget=232448, verify_plans=True)
    rec = build_session(app, "cuda", mode="record", timer=_timer, **opts)
    res = rec.run()
    rec.ledger.tool.flush()
    replay = build_session(app, "cuda", mode="replay", **opts)
    assert type(replay.ledger.tool.fallback).__name__ == "CalibratedTool"
    assert repr(replay.run().mapped) == repr(res.mapped)
    assert res.mapped and all(m.cost_actual <= m.cost_unshared
                              for m in res.mapped)
