"""The port's calibration against the JAX package's.

Mirrors tests/test_calibrate.py — latency-fit round-trips, the area
exchange rate, the dominance-preservation properties (hypothesis) — and
holds the port's fits against the live reference's: the unit system
fitted from the committed ``wami_pallas_tile128.json`` (and the fleet's
``fleet_pallas.json``, on the reference's TPU constants) must equal the
reference's bit for bit.
"""

import pytest
from hypothesis import given, settings, strategies as st

import repro.apps.fleet.pipeline as JF
import repro.apps.wami.pallas as JWP
from repro.core import autotune as JA
from repro.core import xlatool as JX
from repro.core.calibrate import fit_latency_scales as j_fit_latency_scales
from repro.core.hlsim import (ComponentSpec as JComponentSpec,
                              HLSTool as JHLSTool, LoopNest as JLoopNest)
from repro.core.plm.units import vmem_area_bytes
import repro_torch.apps.fleet.pipeline as TF
from repro_torch.apps.wami.cuda import (wami_cuda_components,
                                        wami_cuda_unit_system)
from repro_torch.core import (CalibratedTool, CudaOracle, DesignPoint,
                              MeasurementStore, dominates_min_min,
                              fit_area_scale, fit_latency_scales,
                              smem_area_bytes)
from repro_torch.core.chips import ChipSpec
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest

REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)


def _hls(noise=0.0):
    loop = LoopNest(trip=1024, gamma_r=4, gamma_w=2, arith_ops=16,
                    dep_depth=4, live_values=8)
    return HLSTool({"c": ComponentSpec("c", loop, words_in=4096,
                                       words_out=4096)}, noise=noise)


def _fit_tuple(units):
    return (units.unit, units.lam.scales, units.lam.points,
            units.lam.lam_spread, units.area_scale, units.area_points,
            units.area_spread)


# ----------------------------------------------------------------------
# latency fit
# ----------------------------------------------------------------------
def test_latency_fit_round_trip_exact():
    tool = _hls()
    k = 3.7
    pts = [(p, u) for p in (1, 2, 4) for u in (4, 8, 16)]
    measured = [("c", p, u, k * tool.synthesize("c", unrolls=u,
                                                ports=p).lam)
                for p, u in pts]
    fit = fit_latency_scales(tool, measured)
    assert fit.scale("c") == pytest.approx(k, rel=1e-12)
    assert fit.lam_spread["c"] == pytest.approx(1.0)
    cal = CalibratedTool(tool, fit)
    for (p, u), (_, _, _, lam) in zip(pts, measured):
        assert cal.synthesize("c", unrolls=u, ports=p).lam == \
            pytest.approx(lam, rel=1e-12)


def test_latency_fit_uses_the_measured_points_tile():
    loop = LoopNest(trip=1024, gamma_r=4, gamma_w=2, arith_ops=16,
                    dep_depth=4, live_values=8)
    tool = HLSTool({"c": ComponentSpec("c", loop, words_in=4096,
                                       words_out=4096, outer_repeats=16,
                                       base_tile=32)}, noise=0.0)
    k = 2.0
    measured = [("c", p, u, k * tool.synthesize("c", unrolls=u, ports=p,
                                                tile=t).lam, t)
                for p in (1, 2) for u in (4, 8) for t in (32, 64)]
    fit = fit_latency_scales(tool, measured)
    assert fit.scale("c") == pytest.approx(k, rel=1e-12)
    assert fit.lam_spread["c"] == pytest.approx(1.0)   # no tile leakage


def test_latency_fit_order_independent_and_the_reference_s():
    tool = _hls()
    measured = [("c", p, u, 1e-3 * u * (1 + 0.1 * p))
                for p in (1, 2, 4) for u in (4, 8, 16)]
    f1 = fit_latency_scales(tool, measured)
    f2 = fit_latency_scales(tool, list(reversed(measured)))
    assert f1.scales == f2.scales          # bitwise: sorted log sum
    loop = JLoopNest(trip=1024, gamma_r=4, gamma_w=2, arith_ops=16,
                     dep_depth=4, live_values=8)
    ref = JHLSTool({"c": JComponentSpec("c", loop, words_in=4096,
                                        words_out=4096)}, noise=0.0)
    assert repr(f1) == repr(j_fit_latency_scales(ref, measured))


# ----------------------------------------------------------------------
# area fit
# ----------------------------------------------------------------------
def test_area_scale_round_trip():
    tool = _hls()
    k = 7.5e4                              # "bytes per mm2"
    measured = [("c", p, u, k * tool.synthesize("c", unrolls=u,
                                                ports=p).area)
                for p in (1, 2, 4) for u in (4, 8)]
    scale, n, spread = fit_area_scale(tool, measured)
    assert scale == pytest.approx(k, rel=1e-12)
    assert n == 6 and spread == pytest.approx(1.0)


def test_area_scale_skips_bad_points():
    tool = _hls()
    good = 2.0 * tool.synthesize("c", unrolls=4, ports=2).area
    scale, n, _ = fit_area_scale(tool, [("c", 2, 4, float("inf")),
                                        ("c", 2, 4, -5.0),
                                        ("c", 2, 4, good)])
    assert n == 1 and scale == pytest.approx(2.0)
    assert fit_area_scale(tool, []) == (1.0, 0, 1.0)


def test_calibrated_tool_scales_area_and_detail():
    tool = _hls()
    cal = CalibratedTool(tool, fit_latency_scales(tool, []),
                         area_scale=1e4, unit="bytes")
    raw = tool.synthesize("c", unrolls=4, ports=2)
    s = cal.synthesize("c", unrolls=4, ports=2)
    assert s.area == pytest.approx(raw.area * 1e4)
    assert s.detail["area_plm"] == pytest.approx(
        raw.detail["area_plm"] * 1e4)
    assert s.detail["area_logic"] == pytest.approx(
        raw.detail["area_logic"] * 1e4)
    req = cal.plm_requirement("c", s)
    assert req.unit == "bytes"
    assert req.area_plm == pytest.approx(s.detail["area_plm"])
    assert req.area_plm + req.area_logic == pytest.approx(s.area)


# ----------------------------------------------------------------------
# property: calibration never reorders dominance within one backend
# ----------------------------------------------------------------------
_POINTS = st.lists(st.tuples(st.floats(min_value=1e-9, max_value=1e3),
                             st.floats(min_value=1e-9, max_value=1e3)),
                   min_size=2, max_size=12)


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=-20, max_value=20),
       st.integers(min_value=-20, max_value=20),
       st.floats(min_value=1e-6, max_value=1e6),
       st.floats(min_value=1e-6, max_value=1e6), _POINTS)
def test_calibration_preserves_dominance_order(e_lam, e_area, k_lam, k_area,
                                               raw_points):
    """Scaling every latency by one positive constant and every area by
    another is monotone on both axes.  With power-of-two constants the
    products are exact, so min-min dominance between any two points is
    the same before and after; with any other constants a product may
    round two distinct values onto one (1000 and 1000 - 1 ulp times
    67109.8), which can turn dominance into a tie but never reverse
    it."""
    pts = [DesignPoint(perf=lam, cost=area) for lam, area in raw_points]
    exact = [DesignPoint(perf=lam * 2.0 ** e_lam, cost=area * 2.0 ** e_area)
             for lam, area in raw_points]
    scaled = [DesignPoint(perf=lam * k_lam, cost=area * k_area)
              for lam, area in raw_points]
    for i, a in enumerate(pts):
        for j, b in enumerate(pts):
            if i == j:
                continue
            assert dominates_min_min(a, b) == \
                dominates_min_min(exact[i], exact[j])
            if dominates_min_min(a, b):
                assert not dominates_min_min(scaled[j], scaled[i])
            if dominates_min_min(scaled[i], scaled[j]):
                assert not dominates_min_min(b, a)


@settings(max_examples=20, deadline=None)
@given(st.floats(min_value=0.1, max_value=10.0),
       st.floats(min_value=0.1, max_value=10.0))
def test_calibrated_hlstool_preserves_dominance(k_lam, k_area):
    tool = _hls()
    fit = fit_latency_scales(
        tool, [("c", p, u, k_lam * tool.synthesize("c", unrolls=u,
                                                   ports=p).lam)
               for p in (1, 2) for u in (2, 4)])
    cal = CalibratedTool(tool, fit, area_scale=k_area)
    knobs = [(p, u) for p in (1, 2, 4) for u in (4, 8)]
    raw = [tool.synthesize("c", unrolls=u, ports=p) for p, u in knobs]
    cald = [cal.synthesize("c", unrolls=u, ports=p) for p, u in knobs]

    def dp(s):
        return DesignPoint(perf=s.lam, cost=s.area)

    for i in range(len(knobs)):
        for j in range(len(knobs)):
            if i == j:
                continue
            assert dominates_min_min(dp(raw[i]), dp(raw[j])) == \
                dominates_min_min(dp(cald[i]), dp(cald[j]))


# ----------------------------------------------------------------------
# the unit systems against the live reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tile", [64, 128, 256])
def test_wami_unit_system_is_the_reference_s_bit_for_bit(tile):
    path = JWP.default_measurement_path(tile)
    port = wami_cuda_unit_system(tile, store=MeasurementStore.load(path))
    ref = JWP.wami_unit_system(tile)
    assert _fit_tuple(port) == _fit_tuple(ref)
    assert port.area_points > 0 and set(port.lam.scales) == {
        "debayer", "grayscale", "gradient", "steep_descent", "hessian",
        "warp", "change_det"}


def test_fleet_unit_system_is_the_reference_s_bit_for_bit():
    store = MeasurementStore.load(JF.default_measurement_path())
    port = TF.fleet_unit_system(store, chip=REF_CHIP)
    assert _fit_tuple(port) == _fit_tuple(JF.fleet_unit_system())


def test_one_area_rule_for_the_oracle_and_the_fit():
    """The oracle prices a point's area by the same rule the unit fit
    reads (``smem_area_bytes``), and that rule is the reference's
    double-buffered footprint, byte for byte."""
    specs = wami_cuda_components(128, "cpu")
    ref = JWP.wami_pallas_components(128)
    oracle = CudaOracle(specs, device="cpu", device_kind="interpret",
                        smem_budget=16 * 1024 * 1024,
                        timer=lambda *_: 1e-6)        # nothing runs
    for name, spec in specs.items():
        for ports, unrolls in ((1, 1), (2, 8), (4, 16)):
            want = vmem_area_bytes(ref[name], ports, unrolls)
            assert smem_area_bytes(spec, ports, unrolls) == want
            s = oracle.synthesize(name, ports=ports, unrolls=unrolls)
            assert not s.feasible or s.area == want
