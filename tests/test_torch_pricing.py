"""Whole-grid pricing of the PyTorch package against the scalar path and
against the JAX package's ``BatchPricer``, bit for bit.

The contract of ``repro_torch.core.pricing`` is exact equality: every
``Synthesis`` a wrapped tool returns — lam, area, states, feasibility,
tile, detail dict — equals the scalar path's field for field, at every
point of the WAMI knob spaces at tiles 64, 128 and 256 and of the fleet
on the H100 chip table.  The XLA grid prices the tool's chip table: at a
``ChipSpec`` carrying the JAX package's TPU constants it equals that
package's grid (``repr`` of both, the same dataclass fields), on the
H100 it does not.  Sessions run with ``batch_pricing=True`` keep the
plain drive's books, and measured tools pass ``wrap()`` untouched.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import BatchPricer as RefPricer
from repro.core import build_session as ref_build_session
from repro.core import build_tool as ref_build_tool
from repro.core.autotune import HBM_BYTES_PER_CHIP as REF_HBM
from repro.core.hlsim import ComponentSpec as RefSpec
from repro.core.hlsim import HLSTool as RefHLSTool
from repro.core.hlsim import LoopNest as RefLoopNest
from repro.core.xlatool import _HBM_BW, _ICI_BW, _PEAK
from repro_torch.apps.fleet import fleet_xla_tool
from repro_torch.apps.wami import wami_cuda_oracle, wami_knob_spaces
from repro_torch.core import BatchPricer, build_session, build_tool
from repro_torch.core.chips import H100_SXM, ChipSpec
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest
from repro_torch.core.obs import LogicalClock, Tracer
from repro_torch.core.registry import _UnfittedFallback, get_app
from repro_torch.core.xlatool import XLATool

REF_CHIP = ChipSpec(name="reference", peak_flops=_PEAK, hbm_bw=_HBM_BW,
                    link_bw=_ICI_BW, hbm_bytes=REF_HBM)
SMEM_16MIB = 16 * 1024 * 1024


def _pow2_ladder(top):
    return [1 << k for k in range(top.bit_length()) if (1 << k) <= top]


def _assert_same(pricer, tool, component, **kw):
    got = pricer.synthesize(component, **kw)
    want = tool.synthesize(component, **kw)
    assert got == want, (component, kw, got, want)
    return got


# ----------------------------------------------------------------------
# registered apps: every knob point, against the scalar path and the
# JAX package's grid
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tile", [0, 64, 128, 256])
def test_wami_grid_bit_exact_over_the_knob_spaces(tile):
    tool, ref_tool = build_tool("wami"), ref_build_tool("wami")
    pricer, ref_pricer = BatchPricer(tool), RefPricer(ref_tool)
    kw = {"tile": tile} if tile else {}
    for component, space in wami_knob_spaces().items():
        for ports in _pow2_ladder(space.max_ports):
            for unrolls in range(1, space.max_unrolls + 1):
                for cap in (None, 3, 7):
                    got = _assert_same(pricer, tool, component,
                                       unrolls=unrolls, ports=ports,
                                       max_states=cap, **kw)
                    want = ref_pricer.synthesize(
                        component, unrolls=unrolls, ports=ports,
                        max_states=cap, **kw)
                    assert repr(got) == repr(want)
    assert pricer.fallbacks == 0 and pricer.lookups > 0


def test_wami_clock_axis_bit_exact():
    tool = build_tool("wami")
    pricer = BatchPricer(tool)
    for component in list(tool.components)[:4]:
        for tile in (0, 64, 256):
            for ports in (1, 4):
                for unrolls in (1, 5, 8):
                    for clock in (1.0, 0.75):
                        _assert_same(pricer, tool, component,
                                     unrolls=unrolls, ports=ports,
                                     tile=tile, clock_ns=clock)
    assert pricer.fallbacks == 0


@pytest.mark.parametrize("chip", ["h100", "reference"])
def test_fleet_grid_bit_exact(chip):
    tool = fleet_xla_tool(chip=H100_SXM if chip == "h100" else REF_CHIP)
    assert isinstance(tool, XLATool)
    pricer = BatchPricer(tool)
    ref_pricer = RefPricer(ref_build_tool("fleet"))
    for component in tool.components:
        for ports in range(1, 7):        # past max_ports=4: forces growth
            for unrolls in range(1, 11):
                for cap in (None, 5):    # XLATool ignores max_states
                    got = _assert_same(pricer, tool, component,
                                       unrolls=unrolls, ports=ports,
                                       max_states=cap)
                    if chip == "reference":
                        want = ref_pricer.synthesize(
                            component, unrolls=unrolls, ports=ports,
                            max_states=cap)
                        assert repr(got) == repr(want)
    assert pricer.fallbacks == 0


def test_fleet_grid_prices_the_tool_s_chip():
    """The grid divides by ``tool.chip``, not by the TPU constants: on
    the H100 table its latencies differ from the reference-chip grid's
    wherever both are feasible, and equal the H100 scalar path's."""
    h100 = BatchPricer(fleet_xla_tool())
    tpu = BatchPricer(fleet_xla_tool(chip=REF_CHIP))
    compared = 0
    for component in h100.components:
        for ports in (1, 2, 4):
            for unrolls in (1, 4, 6):
                a = h100.synthesize(component, unrolls=unrolls, ports=ports)
                b = tpu.synthesize(component, unrolls=unrolls, ports=ports)
                if a.feasible and b.feasible:
                    assert a.lam < b.lam
                    compared += 1
    assert compared > 0


def test_cdfg_facts_delegate_to_scalar_tool():
    tool = build_tool("wami")
    pricer = BatchPricer(tool)
    name = next(iter(tool.components))
    s = pricer.synthesize(name, unrolls=2, ports=2)
    assert pricer.cdfg_facts(name, s) == tool.cdfg_facts(name, s)


# ----------------------------------------------------------------------
# fallback paths: out-of-grid requests answer via the scalar tool
# ----------------------------------------------------------------------
def test_non_pow2_ports_fall_back_to_scalar():
    tool = build_tool("wami")
    pricer = BatchPricer(tool)
    name = next(iter(tool.components))
    before = pricer.fallbacks
    _assert_same(pricer, tool, name, unrolls=3, ports=3)
    assert pricer.fallbacks == before + 1


def test_xla_rejects_tile_knob_exactly_like_scalar():
    tool = build_tool("fleet")
    pricer = BatchPricer(tool)
    name = next(iter(tool.components))
    with pytest.raises(TypeError):
        tool.synthesize(name, unrolls=1, ports=1, tile=64)
    with pytest.raises(TypeError):
        pricer.synthesize(name, unrolls=1, ports=1, tile=64)


def test_unknown_component_raises_like_scalar():
    tool = build_tool("wami")
    pricer = BatchPricer(tool)
    with pytest.raises(KeyError):
        tool.synthesize("no-such", unrolls=1, ports=1)
    with pytest.raises(KeyError):
        pricer.synthesize("no-such", unrolls=1, ports=1)


# ----------------------------------------------------------------------
# wrap rules: grid only where the grid provably mirrors the tool
# ----------------------------------------------------------------------
def test_wrap_is_idempotent_and_selective():
    tool = build_tool("wami")
    pricer = BatchPricer.wrap(tool)
    assert isinstance(pricer, BatchPricer) and pricer.tool is tool
    assert BatchPricer.wrap(pricer) is pricer
    other = object()
    assert BatchPricer.wrap(other) is other


def test_wrap_passes_overridden_synthesize_through():
    class Broken(HLSTool):
        def synthesize(self, component, **kw):
            raise RuntimeError("seeded failure")

    spec = ComponentSpec("a", LoopNest(64, 2, 1, 8, 3, 6), 256, 256)
    broken = Broken({"a": spec})
    assert BatchPricer.wrap(broken) is broken
    with pytest.raises(TypeError):
        BatchPricer(broken)
    with pytest.raises(TypeError):
        BatchPricer(object())


def test_wrap_passes_measured_and_calibrated_tools_through():
    """The measured oracle, the calibrated fallback and the unfitted
    stand-in carry no grid program: wrap() leaves each as it is."""
    oracle = wami_cuda_oracle(device="cpu", device_kind="interpret",
                              smem_budget=SMEM_16MIB)
    calibrated = get_app("wami").calibrated_fallback(
        store=_interpret_store(128))
    unfitted = _UnfittedFallback(get_app("wami"), "interpret")
    for tool in (oracle, calibrated, unfitted):
        assert BatchPricer.wrap(tool) is tool
        with pytest.raises(TypeError):
            BatchPricer(tool)


def _interpret_store(tile):
    import os

    from repro_torch.core import MeasurementStore
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return MeasurementStore.load(os.path.join(
        root, "artifacts", "measurements", f"wami_pallas_tile{tile}.json"))


def test_batch_pricing_leaves_the_cuda_tool_unwrapped():
    import dataclasses
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    app = dataclasses.replace(
        get_app("wami"), measurement_path=lambda t: os.path.join(
            root, "artifacts", "measurements", f"wami_pallas_tile{t}.json"))
    s = build_session(app, "cuda", mode="replay", device="cpu",
                      device_kind="interpret", smem_budget=SMEM_16MIB,
                      batch_pricing=True)
    assert type(s.ledger.tool).__name__ == "CudaOracle"


# ----------------------------------------------------------------------
# observability: builds are memoized, grown by doubling, and traced
# ----------------------------------------------------------------------
def test_grid_builds_memoized_and_traced():
    tool = build_tool("wami")
    pricer = BatchPricer(tool)
    tr = Tracer(clock=LogicalClock())
    pricer.tracer = tr
    name = next(iter(tool.components))
    pricer.synthesize(name, unrolls=1, ports=1)
    assert pricer.grid_builds == 1
    first_points = pricer.grid_points_priced
    pricer.synthesize(name, unrolls=8, ports=8)   # inside the min extent
    assert pricer.grid_builds == 1
    pricer.synthesize(name, unrolls=17, ports=8)  # forces doubled rebuild
    assert pricer.grid_builds == 2
    assert pricer.grid_points_priced > first_points
    spans = tr.spans("pricing.batch")
    assert len(spans) == 2
    assert spans[0].attrs["component"] == name
    assert spans[0].attrs["n"] > 0


# ----------------------------------------------------------------------
# ledger invisibility: sessions with batch_pricing keep identical books
# ----------------------------------------------------------------------
@pytest.mark.parametrize("workers", [1, 3])
def test_session_books_identical_and_equal_to_the_reference(workers):
    plain = build_session("wami", workers=workers)
    res_plain = plain.run()
    batched = build_session("wami", workers=workers, batch_pricing=True)
    res_batched = batched.run()
    assert isinstance(batched.ledger.tool, BatchPricer)
    assert dict(plain.ledger.invocations) == dict(batched.ledger.invocations)
    assert dict(plain.ledger.failed) == dict(batched.ledger.failed)
    assert repr(res_plain.planned) == repr(res_batched.planned)
    assert repr(res_plain.mapped) == repr(res_batched.mapped)
    ref = ref_build_session("wami", workers=workers, batch_pricing=True)
    ref_res = ref.run()
    assert repr(ref_res.mapped) == repr(res_batched.mapped)
    assert dict(ref.ledger.invocations) == dict(batched.ledger.invocations)


def test_fleet_session_books_at_the_reference_chip():
    port = build_session("fleet", tool=fleet_xla_tool(chip=REF_CHIP),
                         batch_pricing=True)
    ref = ref_build_session("fleet", batch_pricing=True)
    assert repr(port.run().mapped) == repr(ref.run().mapped)
    assert dict(port.ledger.invocations) == dict(ref.ledger.invocations)


# ----------------------------------------------------------------------
# property: randomized spaces, tiles, noise seeds — still bit-exact,
# and equal to the JAX package's grid
# ----------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(trip=st.integers(1, 512), gamma_r=st.integers(0, 4),
       gamma_w=st.integers(0, 3), arith=st.integers(1, 32),
       dep=st.integers(1, 8), live=st.integers(1, 16),
       has_plm=st.booleans(), words=st.integers(16, 2048),
       noise=st.sampled_from([0.0, 1.0, 2.5]),
       seed=st.sampled_from(["cosmos", "alt"]),
       base_tile=st.sampled_from([0, 32]),
       max_ports=st.sampled_from([2, 4, 8]),
       max_unrolls=st.integers(2, 12))
def test_property_random_hls_space_bit_exact(
        trip, gamma_r, gamma_w, arith, dep, live, has_plm, words,
        noise, seed, base_tile, max_ports, max_unrolls):
    loop = (trip, gamma_r, gamma_w, arith, dep, live, has_plm)
    spec = ComponentSpec("rand", LoopNest(*loop), words, max(1, words // 2),
                         base_tile=base_tile)
    ref_spec = RefSpec("rand", RefLoopNest(*loop), words,
                       max(1, words // 2), base_tile=base_tile)
    tool = HLSTool({"rand": spec}, noise=noise, seed=seed)
    pricer = BatchPricer(tool)
    ref_pricer = RefPricer(RefHLSTool({"rand": ref_spec}, noise=noise,
                                      seed=seed))
    tiles = (0, 16, 48) if base_tile else (0,)
    for tile in tiles:
        for ports in _pow2_ladder(max_ports):
            for unrolls in range(1, max_unrolls + 1):
                for cap in (None, dep):
                    got = _assert_same(pricer, tool, "rand",
                                       unrolls=unrolls, ports=ports,
                                       max_states=cap, tile=tile)
                    assert repr(got) == repr(ref_pricer.synthesize(
                        "rand", unrolls=unrolls, ports=ports,
                        max_states=cap, tile=tile))
    assert pricer.fallbacks == 0
