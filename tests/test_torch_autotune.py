"""The port's knob walk against the JAX package's (the mirror of
``tests/test_autotune_hlo.py``'s pricing half and of
``examples/autoshard.py``).

Plans, ledger totals and stage names equal the live reference's for
every arch on ``train_4k`` at three meshes: at the reference's 16 GiB
(an ``XLAOracle`` on a chip table of that memory) and at the H100's
80 GB (the reference's walk with ``budget=80e9``)."""

import pytest

from repro.configs import get_config as j_get_config
from repro.core import autotune as JA
from repro.core.oracle import OracleLedger as JLedger
from repro.ft import replan as j_replan

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.core import autotune as TA
from repro_torch.core.chips import H100_SXM, ChipSpec
from repro_torch.core.oracle import OracleLedger
from repro_torch.ft import replan

TRAIN = SHAPES[0]
MESHES = ({"data": 16, "model": 16}, {"data": 8, "model": 16},
          {"pod": 2, "data": 16, "model": 16})
REF_CHIP = ChipSpec(name="reference", peak_flops=H100_SXM.peak_flops,
                    hbm_bw=H100_SXM.hbm_bw, link_bw=H100_SXM.link_bw,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)
BUDGETS = {"16GiB": (REF_CHIP, JA.HBM_BYTES_PER_CHIP),
           "80GB": (H100_SXM, H100_SXM.hbm_bytes)}


def _plan(p):
    return (p.microbatches, p.remat, p.accum_dtype, p.est_bytes,
            p.breakdown)


def _walk(choose, ledger, budget, stages):
    out = []
    for arch, cfg, mesh in stages:
        out.append(_plan(choose(cfg, TRAIN, mesh, ledger=ledger,
                                budget=budget)))
    return out


@pytest.mark.parametrize("budget", sorted(BUDGETS))
def test_plans_and_ledger_equal_reference(budget):
    chip, nbytes = BUDGETS[budget]
    j_led = JLedger(JA.XLAOracle())
    t_led = OracleLedger(TA.XLAOracle(chip=chip))
    for mesh in MESHES:
        j = _walk(JA.choose_train_knobs, j_led, nbytes,
                  [(a, j_get_config(a), mesh) for a in list_archs()])
        t = _walk(TA.choose_train_knobs, t_led, None,
                  [(a, get_config(a), mesh) for a in list_archs()])
        assert t == j, mesh
        assert t_led.total() == j_led.total()
        assert dict(t_led.invocations) == dict(j_led.invocations)
    assert sorted(t_led.tool.stages) == sorted(j_led.tool.stages)
    # the fits flag reads the oracle's chip
    for name in t_led.tool.stages:
        s = t_led.tool.synthesize(name, unrolls=2, ports=1)
        if s.feasible:
            assert s.detail["fits"] == float(
                s.detail["est_bytes"] <= chip.hbm_bytes)


def test_default_budget_is_the_chip_table():
    cfg = get_config("qwen2-0.5b")
    mesh = MESHES[0]
    assert TA.choose_train_knobs(cfg, TRAIN, mesh) == TA.choose_train_knobs(
        cfg, TRAIN, mesh, budget=H100_SXM.hbm_bytes)
    at_ref = TA.choose_train_knobs(
        cfg, TRAIN, mesh, ledger=OracleLedger(TA.XLAOracle(chip=REF_CHIP)))
    want = JA.choose_train_knobs(j_get_config("qwen2-0.5b"), TRAIN, mesh)
    assert _plan(at_ref) == _plan(want)


def test_autoshard_walk_counts():
    """The autoshard example at the card's budget: 60 priced points
    over the ten archs, the elastic re-plan of gemma2-9b, then 0 new
    invocations for the unchanged stage — as the reference counts."""
    mesh = MESHES[0]
    led = OracleLedger(TA.XLAOracle())
    j_led = JLedger(JA.XLAOracle())
    table = []
    for arch in list_archs():
        p = TA.choose_train_knobs(get_config(arch), TRAIN, mesh, ledger=led)
        jp = JA.choose_train_knobs(j_get_config(arch), TRAIN, mesh,
                                   ledger=j_led, budget=80e9)
        assert _plan(p) == _plan(jp), arch
        table.append((arch, p.microbatches, p.remat,
                      round(p.est_bytes / 1e9, 2)))
    assert led.total() == j_led.total() == 60
    assert ("qwen2-0.5b", 1, "dots", 29.0) in table
    assert ("gemma2-9b", 1, "full", 52.6) in table
    plan, j_plan = (replan((2, 16, 16), ("pod", "data", "model"), 500),
                    j_replan((2, 16, 16), ("pod", "data", "model"), 500))
    assert plan.new_shape == j_plan.new_shape
    mesh2 = dict(zip(plan.axis_names, plan.new_shape))
    before = led.total()
    p2 = TA.choose_train_knobs(get_config("gemma2-9b"), TRAIN, mesh2,
                               ledger=led)
    jp2 = JA.choose_train_knobs(j_get_config("gemma2-9b"), TRAIN, mesh2,
                                ledger=j_led, budget=80e9)
    assert _plan(p2) == _plan(jp2)
    assert led.total() - before == j_led.total() - before > 0
    before = led.total()
    TA.choose_train_knobs(get_config("gemma2-9b"), TRAIN, mesh, ledger=led)
    assert led.total() - before == 0


def test_oracle_protocol_matches_reference():
    cfg, j_cfg = get_config("zamba2-2.7b"), j_get_config("zamba2-2.7b")
    mesh = MESHES[0]
    t, j = TA.XLAOracle(chip=REF_CHIP), JA.XLAOracle()
    name = t.register("z", cfg, TRAIN, mesh)
    j.register("z", j_cfg, TRAIN, mesh)
    for u in range(0, len(JA._LADDER) + 2):
        ts = t.synthesize(name, unrolls=u, ports=1)
        js = j.synthesize(name, unrolls=u, ports=1)
        assert (ts.lam, ts.area, ts.feasible, ts.detail) == \
            (js.lam, js.area, js.feasible, js.detail), u
        if ts.feasible:
            assert t.cdfg_facts(name, ts) == j.cdfg_facts(name, js) or \
                vars(t.cdfg_facts(name, ts)) == vars(j.cdfg_facts(name, js))
            assert _plan(t.plan_from_synthesis(name, ts)) == \
                _plan(j.plan_from_synthesis(name, js))
    with pytest.raises(ValueError):
        t.register("z", get_config("gemma2-9b"), TRAIN, mesh)
    assert TA._LADDER == JA._LADDER
    assert TA._REMAT_FACTOR == JA._REMAT_FACTOR
    assert TA._mesh_key(MESHES[2]) == JA._mesh_key(MESHES[2])
    with pytest.raises(TypeError):
        TA.choose_train_knobs(cfg, TRAIN, mesh, ledger=OracleLedger(object()))
