"""The port's system-level PLM planner against the JAX package's.

Mirrors tests/test_plm.py — compatibility certificate, shared-bank
planning, the tile knob axis, the WAMI memory-co-design drives — and
holds each result against the live reference on the same inputs:

  * plans, certificates and syntheses compare by ``repr`` (exact);
  * the analytical WAMI share-PLM front (the fig10 ``share_plm`` cell:
    ``build_session("wami", "analytical", share_plm=True)`` over
    ``WAMI_TILE_SIZES``, ``verify_plans=True``) equals the reference's;
  * the measured share-PLM session replayed over the reference's
    ``wami_pallas_tile*.json`` (device kind ``"interpret"``, the
    reference's 16 MiB budget) equals ``wami_plm_session``'s.
"""

import pytest

import repro.apps.wami.pallas as JWP
import repro.apps.wami.pipeline as JWPipe
from repro.core import (MemGen as JMemGen, MemoryCompatGraph as JCompat,
                        PLMPlanner as JPlanner,
                        PLMRequirement as JRequirement, PLMSpec as JSpec)
from repro.core.hlsim import (ComponentSpec as JComponentSpec,
                              HLSTool as JHLSTool, LoopNest as JLoopNest)
from repro.core.oracle import OracleLedger as JLedger
from repro.core.registry import build_session as j_build_session
from repro.core.tmg import pipeline_tmg as j_pipeline_tmg
from repro_torch.apps.wami.cuda import wami_cuda_plm_session
from repro_torch.apps.wami.knobs import WAMI_TILE_SIZES
from repro_torch.apps.wami.pipeline import (wami_plm_planner, wami_session,
                                            wami_tmg)
from repro_torch.core import (KnobSpace, MemGen, MemoryCompatGraph,
                              PLMPlanner, PLMRequirement, PLMSpec,
                              build_session, exclusive_pairs)
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest
from repro_torch.core.oracle import OracleLedger
from repro_torch.core.plm.planner import shared_area
from repro_torch.core.tmg import Place, TMG, Transition, pipeline_tmg

SMEM_16MIB = 16 * 1024 * 1024          # the reference's VMEM budget
LK = {"warp", "matrix_sub", "sd_update", "matrix_mul", "matrix_add",
      "matrix_resh"}


# ----------------------------------------------------------------------
# compatibility certificate
# ----------------------------------------------------------------------
def test_wami_lk_loop_is_mutually_exclusive():
    """The one-token LK refinement cycle certifies exactly the six loop
    components; streaming neighbours (2-token ping-pong) stay concurrent;
    the certificate is the reference's."""
    g = MemoryCompatGraph(wami_tmg())
    for u in LK:
        for v in LK:
            if u != v:
                assert g.may_share(u, v), (u, v)
    assert not g.may_share("debayer", "grayscale")
    assert not g.may_share("gradient", "steep_descent")
    assert not g.may_share("hessian", "matrix_inv")
    ref = JCompat(JWPipe.wami_tmg())
    names = [t.name for t in wami_tmg().transitions]
    assert [g.neighbours(n) for n in names] == [ref.neighbours(n)
                                                for n in names]
    assert {frozenset(p) for p in exclusive_pairs(wami_tmg())} == {
        frozenset((u, v)) for u in LK for v in LK if u != v}


def test_single_buffer_pipeline_serializes_neighbours():
    tmg = pipeline_tmg(["a", "b", "c"], buffers=1)
    g = MemoryCompatGraph(tmg)
    assert g.may_share("a", "b") and g.may_share("b", "c")
    g2 = MemoryCompatGraph(pipeline_tmg(["a", "b", "c"], buffers=2))
    assert not g2.may_share("a", "b")


def test_self_loops_certify_nothing():
    tmg = TMG([Transition("a"), Transition("b")],
              [Place("self:a", "a", "a", tokens=1),
               Place("self:b", "b", "b", tokens=1),
               Place("f", "a", "b", tokens=2),
               Place("r", "b", "a", tokens=2)])
    assert exclusive_pairs(tmg) == frozenset()


# ----------------------------------------------------------------------
# memgen shared generation
# ----------------------------------------------------------------------
def test_generate_shared_envelope_and_benefit():
    gen = MemGen()
    specs = [PLMSpec(words=32768, word_bits=32, ports=4),
             PLMSpec(words=49152, word_bits=32, ports=2),
             PLMSpec(words=114688, word_bits=32, ports=8)]
    shared = gen.generate_shared(specs)
    assert shared.ports == 8 and shared.clients == 3
    assert shared.banks & (shared.banks - 1) == 0
    private = sum(gen.generate(s).area for s in specs)
    biggest = gen.generate(PLMSpec(words=114688, word_bits=32, ports=8)).area
    assert biggest < shared.area < private
    ref = JMemGen().generate_shared([JSpec(words=s.words,
                                           word_bits=s.word_bits,
                                           ports=s.ports) for s in specs])
    assert repr(shared) == repr(ref)


def test_plm_bits():
    gen = MemGen()
    plm = gen.generate(PLMSpec(words=8192, word_bits=32, ports=4))
    assert plm.bits == plm.banks * plm.words_per_bank * 32
    assert plm.bits >= 8192 * 32
    assert plm.bits == plm.total_bits(32)


# ----------------------------------------------------------------------
# planner
# ----------------------------------------------------------------------
def _req(name, words=4096, ports=2, area=None, logic=0.01, unit="mm2"):
    a = area if area is not None else MemGen().generate(
        PLMSpec(words=words, word_bits=32, ports=ports)).area
    return PLMRequirement(component=name, capacity=words, word_bits=32,
                          ports=ports, area_plm=a, area_logic=logic,
                          unit=unit)


def _j(req):
    return JRequirement(**{f: getattr(req, f) for f in (
        "component", "capacity", "word_bits", "ports", "area_plm",
        "area_logic", "unit", "tile")})


def _plan_both(names, reqs, buffers=1):
    """The port's plan and the reference's, of the same requirements."""
    port = PLMPlanner(pipeline_tmg(list(names), buffers=buffers)).plan(reqs)
    ref = JPlanner(j_pipeline_tmg(list(names), buffers=buffers)).plan(
        [_j(r) for r in reqs])
    assert repr(port) == repr(ref)
    return port


def test_planner_groups_and_guard():
    plan = _plan_both(["a", "b", "c"], [_req("a", words=65536),
                                        _req("b", words=32768),
                                        _req("c", words=65536)])
    assert [g for g in plan.groups if len(g.members) > 1]
    assert plan.system_cost <= plan.area_private + 1e-12
    assert plan.saved > 0
    for g in plan.groups:
        assert g.area <= g.area_private + 1e-12


def test_guard_holds_when_backend_underprices_memgen():
    cheap = MemGen().generate(PLMSpec(words=65536, word_bits=32,
                                      ports=2)).area / 3.0
    plan = _plan_both(["a", "b", "c"], [_req("a", words=65536, area=cheap),
                                        _req("b", words=65536, area=cheap)])
    assert plan.system_cost <= plan.area_private + 1e-12
    for g in plan.groups:
        assert g.saved >= -1e-12


def test_planner_never_groups_concurrent_components():
    plan = _plan_both(["a", "b", "c"], [_req("a", words=65536),
                                        _req("b", words=65536)], buffers=2)
    assert all(len(g.members) == 1 for g in plan.groups)
    assert plan.saved == 0.0
    assert plan.system_cost == pytest.approx(plan.area_private)


def test_planner_respects_units_and_unsplittable():
    reqs = [_req("a", words=65536, unit="mm2"),
            _req("b", area=1e6, words=65536, unit="bytes"),
            PLMRequirement(component="c", capacity=0, word_bits=0, ports=1,
                           area_plm=0.0, area_logic=0.5)]
    plan = _plan_both(["a", "b", "c"], reqs)
    assert all(len(g.members) == 1 for g in plan.groups)


def test_planner_deterministic():
    planner = PLMPlanner(pipeline_tmg(["a", "b", "c", "d"], buffers=1))
    reqs = [_req(n, words=w) for n, w in
            (("a", 65536), ("b", 32768), ("c", 65536), ("d", 16384))]
    assert planner.plan(list(reqs)) == planner.plan(list(reversed(reqs)))
    _plan_both(["a", "b", "c", "d"], reqs)


def test_shared_area_bytes_unit():
    area, *_ = shared_area([_req("a", area=1e5, unit="bytes"),
                            _req("b", area=3e5, unit="bytes")], MemGen())
    assert 3e5 < area < 4e5          # max + arbitration, far below the sum
    assert area == 3e5 + 4096


# ----------------------------------------------------------------------
# the tile knob axis
# ----------------------------------------------------------------------
def _tool():
    loop = LoopNest(trip=1024, gamma_r=4, gamma_w=2, arith_ops=16,
                    dep_depth=4, live_values=8)
    spec = ComponentSpec("c", loop, words_in=4096, words_out=4096,
                         outer_repeats=16, base_tile=32)
    return HLSTool({"c": spec}, noise=0.0)


def _j_tool():
    loop = JLoopNest(trip=1024, gamma_r=4, gamma_w=2, arith_ops=16,
                     dep_depth=4, live_values=8)
    spec = JComponentSpec("c", loop, words_in=4096, words_out=4096,
                          outer_repeats=16, base_tile=32)
    return JHLSTool({"c": spec}, noise=0.0)


def test_tile_trades_capacity_for_latency():
    tool, ref = _tool(), _j_tool()
    s32 = tool.synthesize("c", unrolls=4, ports=4, tile=32)
    s64 = tool.synthesize("c", unrolls=4, ports=4, tile=64)
    assert s64.detail["plm_words"] > s32.detail["plm_words"]
    assert s64.area > s32.area
    assert s64.lam < s32.lam
    s0 = tool.synthesize("c", unrolls=4, ports=4)
    assert (s32.lam, s32.area) == (s0.lam, s0.area)
    assert s32.tile == 32 and s0.tile == 0
    for t in (0, 32, 64):
        assert repr(tool.synthesize("c", unrolls=4, ports=4, tile=t)) == \
            repr(ref.synthesize("c", unrolls=4, ports=4, tile=t))


def test_characterize_labels_tile_axis():
    from repro_torch.core.characterize import characterize_component
    res = characterize_component(OracleLedger(_tool()), "c",
                                 KnobSpace(clock_ns=1.0, max_ports=4,
                                           max_unrolls=8,
                                           tile_sizes=(32, 64)))
    assert {32, 64} <= {dict(p.knobs).get("tile", 0) for p in res.points}
    assert {r.tile for r in res.regions} >= {32, 64}


def test_characterize_tile_order_independent():
    from repro_torch.core.characterize import characterize_component

    def regions_for(order):
        res = characterize_component(
            OracleLedger(_tool()), "c",
            KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8,
                      tile_sizes=order))
        return sorted((r.tile, r.ports, r.lam_max, r.area_min)
                      for r in res.regions)

    asc = regions_for((32, 64))
    assert asc == regions_for((64, 32))
    assert {t for t, *_ in asc} == {32, 64}


def test_tile_points_cached_separately():
    ledger = OracleLedger(_tool())
    a = ledger.synthesize("c", unrolls=4, ports=2, tile=32)
    b = ledger.synthesize("c", unrolls=4, ports=2, tile=64)
    assert a.area != b.area
    assert ledger.total("c") == 2
    ledger.synthesize("c", unrolls=4, ports=2, tile=64)   # cache hit
    assert ledger.total("c") == 2


# ----------------------------------------------------------------------
# session integration + WAMI against the live reference
# ----------------------------------------------------------------------
def _points(res):
    return [(m.theta_actual, m.cost_actual, m.cost_unshared, m.plm_groups)
            for m in res.mapped]


def test_session_shared_cost_dominates_naive_sum_analytical():
    res = wami_session(0.3, workers=8, share_plm=True,
                       tile_sizes=WAMI_TILE_SIZES).run()
    assert res.mapped
    strictly = 0
    for m in res.mapped:
        assert m.cost_unshared is not None
        assert m.cost_actual <= m.cost_unshared + 1e-12
        if m.cost_actual < m.cost_unshared * (1 - 1e-12):
            strictly += 1
        assert m.plm_groups            # LK loop shares on every point
    assert strictly >= 1
    ref = JWPipe.wami_session(0.3, workers=8, share_plm=True,
                              tile_sizes=WAMI_TILE_SIZES).run()
    assert _points(res) == _points(ref)


def test_fig10_share_plm_cell_is_the_live_reference_s():
    """The fig10 ``share_plm`` cell, analytical: the same front, plans
    and invocations as the live reference (its committed CSV is one of
    the failing gates, so the comparison is with the reference run in
    this process)."""
    port = build_session("wami", "analytical", share_plm=True, workers=8,
                         verify_plans=True)
    ref = j_build_session("wami", "analytical", share_plm=True, workers=8,
                          verify_plans=True)
    res, want = port.run(), ref.run()
    assert set(port.spaces["warp"].tile_sizes) == set(WAMI_TILE_SIZES)
    assert repr(res.mapped) == repr(want.mapped)
    assert res.invocations == want.invocations
    assert port.ledger.outcome_counts() == ref.ledger.outcome_counts()
    assert repr(res.pareto()) == repr(want.pareto())


@pytest.mark.parametrize("measured,tile_sizes", [
    ((128,), (64, 128)), ((64, 128), (64, 128)),
    ((64, 128, 256), (64, 128, 256))])
def test_measured_share_plm_replay_is_wami_plm_session_s(measured,
                                                        tile_sizes):
    """The measured share-PLM drive replayed over the reference's
    recordings: the same front, groups and invocations as the
    reference's ``wami_plm_session``; the shared cost never exceeds the
    per-component sum, every point shares banks, and some point shares
    them inside the LK loop (the structural certificate; the others
    share under their LP schedule's busy intervals)."""
    port = wami_cuda_plm_session(
        0.25, measured_tiles=measured, tile_sizes=tile_sizes, workers=4,
        mode="replay", verify_plans=True,
        measurement_path=JWP.default_measurement_path,
        device="cpu", device_kind="interpret", smem_budget=SMEM_16MIB)
    res = port.run()
    want = JWP.wami_plm_session(0.25, measured_tiles=measured,
                                tile_sizes=tile_sizes, workers=4,
                                verify_plans=True).run()
    assert _points(res) == _points(want)
    assert repr(res.mapped) == repr(want.mapped)
    assert res.invocations == want.invocations
    strictly = 0
    for theta, shared, naive, groups in _points(res):
        assert shared <= naive + 1e-9
        strictly += shared < naive * (1 - 1e-12)
        assert groups
    assert strictly >= 1
    assert any(set(g) <= LK for m in res.mapped for g in m.plm_groups)
    tile_axis = [n for n, ch in res.characterizations.items()
                 if len({dict(p.knobs).get("tile", 0)
                         for p in ch.points} - {0}) >= 2]
    assert len(tile_axis) >= 3


def test_wami_plm_planner_excludes_software_component():
    assert "matrix_inv" in wami_plm_planner().exclude


def test_excluded_component_area_stays_in_the_plan():
    tool = _tool()
    planner = PLMPlanner(pipeline_tmg(["c", "d"]), exclude=("c",))
    synth = tool.synthesize("c", unrolls=4, ports=2)
    plan = planner.plan_point(OracleLedger(tool), {"c": synth})
    assert plan.system_cost == pytest.approx(synth.area)
    (group,) = plan.groups
    assert group.members == ("c",) and group.area == 0.0
    ref = JPlanner(j_pipeline_tmg(["c", "d"]), exclude=("c",)).plan_point(
        JLedger(_j_tool()), {"c": _j_tool().synthesize("c", unrolls=4,
                                                       ports=2)})
    assert repr(plan) == repr(ref)
