"""The port's SoC composition layer against the JAX package's, live.

Both packages compose in the same process, over fronts each resolves
through its own registry; nothing here copies a committed constant of
the reference (the jax-0.9 CDFG drift has moved its committed
trajectory, see ROADMAP).  The port's fleet app prices on the H100 chip
table; to hold it against the reference its analytical tool is given
the reference's TPU constants (read here, in the test), as
tests/test_torch_registry.py does.  Compositions compare as sorted-key
JSON, fronts by ``repr``, verifier findings and errors by their text.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from repro.core import autotune as JA
from repro.core import xlatool as JX
from repro.core.analysis import lint as JL
from repro.core.pareto import DesignPoint as JPoint
from repro.core.soc import budget as JB
from repro.core.soc import compose as JC
from repro.core.soc import verify as JV
from repro.core.soc import workload as JW
import repro_torch.apps.fleet.pipeline as TF
from repro_torch.core import registry as TR
from repro_torch.core.analysis import lint as TL
from repro_torch.core.chips import ChipSpec
from repro_torch.core.pareto import DesignPoint as TPoint
from repro_torch.core.soc import budget as TB
from repro_torch.core.soc import compose as TC
from repro_torch.core.soc import verify as TV
from repro_torch.core.soc import workload as TW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_ARTIFACTS = sorted(
    os.path.join(REPO, "artifacts", "bench", "soc", n)
    for n in os.listdir(os.path.join(REPO, "artifacts", "bench", "soc"))
    if n.endswith(".composition.json"))
REF_CHIP = ChipSpec(name="reference", peak_flops=JX._PEAK,
                    hbm_bw=JX._HBM_BW, link_bw=JX._ICI_BW,
                    hbm_bytes=JA.HBM_BYTES_PER_CHIP)
MIX_SPEC = "wami=0.6,fleet=0.4"
# tests/test_soc.py's gates: greedy equals the exhaustive packer on the
# first five; on the last, replica granularity bites
EXACT_GATES = ((30.0, 12.0, 64.0), (60.0, 25.0, 64.0), (25.0, 10.0, 32.0),
               (80.0, 30.0, 96.0), (100.0, 40.0, 128.0))
PINNED_GAP_GATE = (40.0, 16.0, 64.0)
# budgets the minimal configuration overflows, one envelope each
TINY_GATES = ((1.0, 100.0, 100.0), (100.0, 0.5, 100.0),
              (100.0, 100.0, 0.01))


def _json(comp):
    return json.dumps(comp.to_json(), sort_keys=True)


def _outcome(fn, *args, **kw):
    """A composition's sorted-key JSON, or its error's type and text."""
    try:
        return _json(fn(*args, **kw))
    except (ValueError, KeyError) as e:
        return f"{type(e).__name__}: {e}"


@pytest.fixture(scope="module")
def ref_chip():
    """The port's fleet app with its XLA tool on the reference's TPU
    constants, while the module's tests that ask for it run."""
    fleet = TR.get_app("fleet")
    TR._APPS["fleet"] = dataclasses.replace(
        fleet, analytical=lambda: TF.fleet_xla_tool(chip=REF_CHIP))
    try:
        yield
    finally:
        TR._APPS["fleet"] = fleet


@pytest.fixture(scope="module")
def ref_fronts():
    mix = JW.TrafficMix.parse(MIX_SPEC)
    return JC.SoCComposer(JB.get_budget("sys_medium"), mix,
                          workers=8).fronts()


@pytest.fixture(scope="module")
def port_fronts(ref_chip):
    mix = TW.TrafficMix.parse(MIX_SPEC)
    return TC.SoCComposer(TB.get_budget("sys_medium"), mix,
                          workers=8).fronts()


def _gate(pkg, area, power, bw, tech=45):
    return pkg.SoCBudget(name="gate", area_mm2=area, power_w=power,
                         bw_gbps=bw).at_tech(tech)


# ----------------------------------------------------------------------
# budgets and tech scaling
# ----------------------------------------------------------------------
def test_budget_tables_and_presets_are_the_reference_s():
    assert TB.TECH_NODES == JB.TECH_NODES
    assert TB.REF_TECH_NM == JB.REF_TECH_NM
    assert (TB._AREA_SCALE, TB._POWER_SCALE, TB._BW_SCALE) == (
        JB._AREA_SCALE, JB._POWER_SCALE, JB._BW_SCALE)
    assert ({n: b.to_json() for n, b in TB.BUDGET_PRESETS.items()}
            == {n: b.to_json() for n, b in JB.BUDGET_PRESETS.items()})


@pytest.mark.parametrize("tech", JB.TECH_NODES)
@pytest.mark.parametrize("preset", sorted(JB.BUDGET_PRESETS))
def test_tech_scaling_equals_the_reference(preset, tech):
    t = TB.get_budget(preset).at_tech(tech)
    j = JB.get_budget(preset).at_tech(tech)
    assert t.to_json() == j.to_json()
    assert TB.SoCBudget.from_json(t.to_json()) == t
    for area in (0.5, 10.0, 157.57):
        assert t.scale_area(area) == j.scale_area(area)
        assert t.power_of(area) == j.power_of(area)


@pytest.mark.parametrize("call", [
    lambda pkg: pkg.get_budget("sys_huge"),
    lambda pkg: pkg.SoCBudget(name="bad", area_mm2=-1.0, power_w=1.0,
                              bw_gbps=1.0),
    lambda pkg: pkg.SoCBudget(name="bad", area_mm2=1.0, power_w=1.0,
                              bw_gbps=1.0, tech_nm=28),
    lambda pkg: pkg.get_budget("sys_small").at_tech(7),
])
def test_budget_errors_equal_the_reference_s(call):
    def err(pkg):
        with pytest.raises((KeyError, ValueError)) as ei:
            call(pkg)
        return type(ei.value).__name__, str(ei.value)
    assert err(TB) == err(JB)


# ----------------------------------------------------------------------
# traffic mixes
# ----------------------------------------------------------------------
def test_default_demands_are_the_reference_s():
    assert TW.DEFAULT_DEMANDS == JW.DEFAULT_DEMANDS
    assert TW.DEFAULT_DEMANDS["wami"]["bytes_per_request"] == 16777216
    assert TW.DEFAULT_DEMANDS["fleet"]["area_scale"] == 2e-12


@pytest.mark.parametrize("spec,name,overrides", [
    (MIX_SPEC, None, {}),
    ("wami=0.9,fleet=0.1", "w90", {}),
    (MIX_SPEC, None, {"wami": {"share_plm": False},
                      "fleet": {"backend": "cuda", "area_scale": 3.5e-9}}),
    ("fleet=2,wami=1", None, {"wami": {"delta": 0.5}}),
    ("wami=1.0", None, {}),
])
def test_traffic_mix_parse_equals_the_reference(spec, name, overrides):
    t = TW.TrafficMix.parse(spec, name=name, **overrides)
    j = JW.TrafficMix.parse(spec, name=name, **overrides)
    assert t.to_json() == j.to_json()
    assert t.shares() == j.shares()
    assert t.normalized().to_json() == j.normalized().to_json()
    assert TW.TrafficMix.from_json(t.to_json()) == t


@pytest.mark.parametrize("call", [
    lambda pkg: pkg.TrafficMix.parse("wami:0.6"),
    lambda pkg: pkg.TrafficMix.parse(","),
    lambda pkg: pkg.TrafficMix.parse("wami=0.5,wami=0.5"),
    lambda pkg: pkg.TrafficMix.parse("wami=0"),
    lambda pkg: pkg.TrafficMix.parse(MIX_SPEC).demand("autoshard"),
    lambda pkg: pkg.TrafficMix.parse("nosuchapp=1.0").resolve(),
    lambda pkg: pkg.AppDemand(app="x", share=1.0, area_scale=0.0),
    lambda pkg: pkg.AppDemand(app="x", share=1.0, bytes_per_request=-1),
])
def test_traffic_mix_errors_equal_the_reference_s(call):
    def err(pkg):
        with pytest.raises((KeyError, ValueError)) as ei:
            call(pkg)
        return type(ei.value).__name__, str(ei.value)
    assert err(TW) == err(JW)


def test_resolve_reads_the_port_s_registry():
    apps = TW.TrafficMix.parse(MIX_SPEC).resolve()
    assert [a.name for a in apps] == ["wami", "fleet"]
    assert all(isinstance(a, TR.App) for a in apps)


# ----------------------------------------------------------------------
# fronts and compositions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("app", ["wami", "fleet"])
def test_fronts_equal_the_reference_s(app, ref_fronts, port_fronts):
    assert repr(port_fronts[app]) == repr(ref_fronts[app])
    assert port_fronts[app]


@pytest.mark.parametrize("method", ["greedy", "exhaustive"])
@pytest.mark.parametrize("tech", [45, 16])
@pytest.mark.parametrize("gate", EXACT_GATES + (PINNED_GAP_GATE,))
def test_composition_json_equals_the_reference_s(gate, tech, method,
                                                  ref_fronts, port_fronts):
    fn = {"greedy": "greedy_composition",
          "exhaustive": "optimal_composition"}[method]
    # at 16 nm the largest gate enumerates ~270,000 configurations
    kw = {"max_configs": 300_000} if method == "exhaustive" else {}
    t = _outcome(getattr(TC, fn), _gate(TB, *gate, tech),
                 TW.TrafficMix.parse(MIX_SPEC), port_fronts, **kw)
    j = _outcome(getattr(JC, fn), _gate(JB, *gate, tech),
                 JW.TrafficMix.parse(MIX_SPEC), ref_fronts, **kw)
    assert t == j
    assert t.startswith("{")          # every gate composes


@pytest.mark.parametrize("tech", [45, 16])
def test_greedy_matches_exhaustive_where_granularity_does_not_bite(
        tech, port_fronts):
    """Equal on the exact gates; on the pinned gate within
    tests/test_soc.py's 0.4% (0.38% at 45 nm, equal at 16 nm)."""
    mix = TW.TrafficMix.parse(MIX_SPEC)
    for gate in EXACT_GATES + (PINNED_GAP_GATE,):
        g = TC.greedy_composition(_gate(TB, *gate, tech), mix, port_fronts)
        o = TC.optimal_composition(_gate(TB, *gate, tech), mix,
                                   port_fronts, max_configs=300_000)
        gap = ((o.sustained_throughput - g.sustained_throughput)
               / o.sustained_throughput)
        if gate == PINNED_GAP_GATE:
            assert 0.0 <= gap <= 0.004
        else:
            assert g.sustained_throughput == pytest.approx(
                o.sustained_throughput, rel=1e-12), gate
        TV.assert_composition_sound(g, fronts=port_fronts)
        TV.assert_composition_sound(o, fronts=port_fronts)


@pytest.mark.parametrize("gate", TINY_GATES)
def test_infeasible_mix_names_the_same_field(gate, ref_fronts,
                                             port_fronts):
    def err(C, pkg, W, fronts):
        with pytest.raises(C.BudgetInfeasibleError) as ei:
            C.greedy_composition(_gate(pkg, *gate), W.TrafficMix.parse(
                MIX_SPEC), fronts)
        with pytest.raises(C.BudgetInfeasibleError) as ei2:
            C.optimal_composition(_gate(pkg, *gate), W.TrafficMix.parse(
                MIX_SPEC), fronts)
        e = ei.value
        assert str(ei2.value) == str(e)
        return e.budget_field, e.need, e.limit, e.mix_name, str(e)
    t = err(TC, TB, TW, port_fronts)
    assert t == err(JC, JB, JW, ref_fronts)
    assert t[0] == {0: "area_mm2", 1: "power_w", 2: "bw_gbps"}[
        TINY_GATES.index(gate)]


def test_exhaustive_guards_raise_the_reference_s_errors(ref_fronts,
                                                        port_fronts):
    def errs(C, B, W, fronts):
        mix = W.TrafficMix.parse(MIX_SPEC)
        wide = W.TrafficMix(name="wide", demands=mix.demands + tuple(
            dataclasses.replace(mix.demands[0], app=f"ghost{i}")
            for i in range(3)))
        ghosts = dict(fronts, **{f"ghost{i}": fronts["wami"]
                                 for i in range(3)})
        out = []
        for call in (
                lambda: C.optimal_composition(B.get_budget("sys_large"),
                                              wide, ghosts),
                lambda: C.optimal_composition(B.get_budget("sys_large"),
                                              mix, fronts, max_configs=3),
                lambda: C.greedy_composition(B.get_budget("sys_large"),
                                             mix, {"wami": fronts["wami"]}),
                lambda: C.operating_points([], mix.demand("wami"),
                                           B.get_budget("sys_large"))):
            with pytest.raises((ValueError, KeyError)) as ei:
                call()
            out.append(f"{type(ei.value).__name__}: {ei.value}")
        return out
    t = errs(TC, TB, TW, port_fronts)
    assert t == errs(JC, JB, JW, ref_fronts)
    assert "max_apps" in t[0] and "max_configs" in t[1]


def test_solo_compositions_of_every_registered_app(ref_fronts,
                                                   port_fronts):
    for app in TR.list_apps():
        def solo(C, B, W, fronts):
            mix = W.TrafficMix.parse(f"{app.name}=1.0",
                                     name=f"{app.name}_solo")
            comp = C.SoCComposer(B.get_budget("sys_large"), mix,
                                 fronts={app.name: fronts[app.name]})
            return comp.compose(), comp.fronts()
        t, t_fronts = solo(TC, TB, TW, port_fronts)
        j, _ = solo(JC, JB, JW, ref_fronts)
        assert _json(t) == _json(j), app.name
        TV.assert_composition_sound(t, fronts=t_fronts)
        (alloc,) = t.allocations
        assert alloc.app == app.name and alloc.replicas >= 1


def test_composer_resolves_fronts_through_the_port_s_registry(ref_chip,
                                                               ref_fronts):
    """No injected fronts: the composer builds each app's session itself,
    traces ``soc.compose`` > ``soc.front``/``soc.allocate`` and counts."""
    from repro_torch.core.obs import LogicalClock, MetricsRegistry, Tracer
    tracer, metrics = Tracer(LogicalClock()), MetricsRegistry()
    composer = TC.SoCComposer(TB.get_budget("sys_medium"),
                              TW.TrafficMix.parse(MIX_SPEC), workers=2,
                              tracer=tracer, metrics=metrics)
    g, o = composer.compose(), composer.compose("exhaustive")
    ref = JC.SoCComposer(JB.get_budget("sys_medium"),
                         JW.TrafficMix.parse(MIX_SPEC), fronts=ref_fronts)
    assert _json(g) == _json(ref.compose())
    assert _json(o) == _json(ref.compose("exhaustive"))
    names = [s.name for s in tracer.spans()]
    assert names.count("soc.compose") == 2
    assert names.count("soc.front") == 2        # resolved once, memoized
    assert names.count("soc.allocate") == 1     # the greedy walk's
    by_id = {s.span_id: s for s in tracer.spans()}
    for s in tracer.spans():
        if s.name in ("soc.front", "soc.allocate"):
            assert by_id[s.parent_id].name == "soc.compose"
    assert metrics.counter("soc.compositions").value == 2
    assert metrics.counter("soc.moves").value > 0
    assert metrics.gauge("soc.sustained_throughput").value == \
        o.sustained_throughput
    with pytest.raises(ValueError, match="methods"):
        composer.compose("annealing")


# ----------------------------------------------------------------------
# the verifier
# ----------------------------------------------------------------------
def _tampered(comp, kind):
    r = dataclasses.replace
    a0 = comp.allocations[0]
    if kind == "real":
        return comp
    if kind == "lied":
        return r(comp, sustained_throughput=comp.sustained_throughput * 2)
    if kind == "shrunk":
        return r(comp, budget=r(comp.budget, area_mm2=10.0))
    if kind == "dropped":
        return r(comp, allocations=comp.allocations[:1])
    if kind == "doubled":
        return r(comp, allocations=comp.allocations + (a0,))
    if kind == "share":
        return r(comp, allocations=(r(a0, share=a0.share / 2),)
                 + comp.allocations[1:])
    if kind == "replicas":
        return r(comp, allocations=(r(a0, replicas=0),)
                 + comp.allocations[1:])
    if kind == "priced":
        return r(comp, allocations=(r(a0, point=r(
            a0.point, area_mm2=a0.point.area_mm2 * 0.5)),)
            + comp.allocations[1:])
    if kind == "off_front":
        return r(comp, allocations=(r(a0, point=r(
            a0.point, theta=a0.point.theta * 1.5)),)
            + comp.allocations[1:])
    raise AssertionError(kind)


TAMPERS = ("real", "lied", "shrunk", "dropped", "doubled", "share",
           "replicas", "priced", "off_front")


@pytest.mark.parametrize("kind", TAMPERS)
def test_tampered_compositions_give_the_reference_s_rules(
        kind, ref_fronts, port_fronts):
    def rules(C, B, W, V, fronts):
        comp = C.greedy_composition(B.get_budget("sys_medium"),
                                    W.TrafficMix.parse(MIX_SPEC), fronts)
        bad = _tampered(comp, kind)
        return ([str(v) for v in V.verify_composition(bad)],
                [str(v) for v in V.verify_composition(bad, fronts=fronts)])
    t = rules(TC, TB, TW, TV, port_fronts)
    assert t == rules(JC, JB, JW, JV, ref_fronts)
    assert bool(t[1]) == (kind != "real")


def test_assert_composition_sound_raises_like_the_reference(port_fronts):
    comp = TC.greedy_composition(TB.get_budget("sys_medium"),
                                 TW.TrafficMix.parse(MIX_SPEC), port_fronts)
    with pytest.raises(TV.CompositionVerificationError, match="C-THETA"):
        TV.assert_composition_sound(_tampered(comp, "lied"))
    rt = TC.Composition.from_json(comp.to_json())
    assert _json(rt) == _json(comp)


@pytest.mark.parametrize("with_fronts", [False, True])
@pytest.mark.parametrize("path", REF_ARTIFACTS,
                         ids=[os.path.basename(p) for p in REF_ARTIFACTS])
def test_verify_file_on_the_reference_s_artifacts(path, with_fronts,
                                                  ref_chip):
    """Both packages re-prove the JAX package's committed compositions
    the same way.  With fronts, both report the same ``C-FRONT [wami]``:
    the artifacts were composed from WAMI CDFG facts made before jax 0.9
    (under which ``repro/apps/wami/cdfg.py::_walk`` prices the ``jit``
    and ``iota`` equations as arithmetic), and the port's own walk of its
    ``make_fx`` graphs gives the live facts (hessian's are pinned to them
    in ``WAMI_KERNEL_FACTS``), so its re-resolved WAMI front is the live
    reference's, which no longer holds the committed point."""
    t = TV.verify_composition_file(path, with_fronts=with_fronts)
    j = JV.verify_composition_file(path, with_fronts=with_fronts)
    assert (t[0], [str(v) for v in t[1]]) == (j[0], [str(v) for v in j[1]])
    assert t[0] == 2
    rules = [(v.rule, v.group) for v in t[1]]
    assert rules == ([("C-FRONT", ("wami",))] if with_fronts else [])


def test_verify_cli(tmp_path, capsys, monkeypatch, port_fronts):
    monkeypatch.chdir(tmp_path)
    assert TV.main([]) == 1           # the default path, not yet written
    assert capsys.readouterr().out == (
        f"FAIL {os.path.join('artifacts', 'bench_torch', 'soc')}: no such "
        f"file or directory\n")
    assert TV.main([str(tmp_path)]) == 1          # nothing to prove
    assert "no *.composition.json" in capsys.readouterr().err
    comp = TC.greedy_composition(TB.get_budget("sys_medium"),
                                 TW.TrafficMix.parse(MIX_SPEC), port_fronts)
    (tmp_path / "a.composition.json").write_text(_json(comp))
    (tmp_path / "b.composition.json").write_text(
        _json(_tampered(comp, "lied")))
    (tmp_path / "c.composition.json").write_text(json.dumps({"mix": {}}))
    assert TV.main([str(tmp_path)]) == 2
    out = capsys.readouterr().out
    assert "ok   " in out and "C-THETA" in out and "C-PROV" in out
    assert TV.main([str(tmp_path / "a.composition.json")]) == 0


# ----------------------------------------------------------------------
# the compose CLI
# ----------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--verify"],
    ["--mix", "wami=0.9,fleet=0.1", "--tech", "16"],
    ["--budget", "sys_small", "--area", "60", "--bw", "64",
     "--method", "exhaustive", "--verify"],
    ["--mix", "wami=1.0", "--budget", "sys_large", "--tech", "22"],
])
def test_compose_cli_equals_the_reference_s(argv, tmp_path, capsys,
                                            ref_chip):
    out = str(tmp_path / "c.composition.json")
    assert JC.main(argv + ["--workers", "2", "--out", out]) == 0
    j_stdout = capsys.readouterr().out
    with open(out) as f:
        j_doc = f.read()
    assert TC.main(argv + ["--workers", "2", "--out", out]) == 0
    assert capsys.readouterr().out == j_stdout
    with open(out) as f:
        assert f.read() == j_doc


@pytest.mark.parametrize("argv", [
    ["--mix", "wami=0.6,nosuchapp=0.4"],
    ["--budget", "sys_small", "--area", "0.1"],
    ["--budget", "sys_huge"],
])
def test_compose_cli_failures_equal_the_reference_s(argv, capsys, ref_chip):
    assert JC.main(argv + ["--workers", "2"]) == 1
    j_err = capsys.readouterr().err
    assert TC.main(argv + ["--workers", "2"]) == 1
    assert capsys.readouterr().err == j_err
    assert j_err.startswith("soc-compose: FAIL")


def test_compose_cli_on_the_h100_table(tmp_path, capsys):
    """The port's own registry (the fleet on the H100 chip table): the
    CLI's artifact is the in-process composition, and it re-proves."""
    out = str(tmp_path / "h100.composition.json")
    assert TC.main(["--verify", "--workers", "2", "--out", out]) == 0
    assert "independently re-proved" in capsys.readouterr().out
    comp = TC.SoCComposer(TB.get_budget("sys_medium"),
                          TW.TrafficMix.parse(MIX_SPEC)).compose()
    with open(out) as f:
        assert json.load(f) == json.loads(_json(comp))
    n, violations = TV.verify_composition_file(out, with_fronts=True)
    assert n == 2 and violations == []


# ----------------------------------------------------------------------
# SOC001: provenance of composition artifacts
# ----------------------------------------------------------------------
def test_soc001_flags_the_same_artifacts(tmp_path, port_fronts):
    comp = TC.greedy_composition(TB.get_budget("sys_medium"),
                                 TW.TrafficMix.parse(MIX_SPEC), port_fronts)
    (tmp_path / "good.composition.json").write_text(_json(comp))
    doc = comp.to_json()
    del doc["budget"]
    doc["mix"] = {"name": "anonymous"}
    (tmp_path / "bad.composition.json").write_text(json.dumps(doc))
    doc = comp.to_json()
    del doc["budget"]["tech_nm"]
    doc["mix"] = []
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "worse.composition.json").write_text(
        json.dumps(doc))
    (tmp_path / "torn.composition.json").write_text('{"budget": ')
    found = {}
    for L in (TL, JL):
        findings = []
        L._lint_soc_artifacts(findings, root=str(tmp_path))
        found[L] = [(f.rule, f.app, f.subject, f.detail) for f in findings]
    assert found[TL] == found[JL]
    assert {s for _, _, s, _ in found[TL]} == {
        "bad.composition.json", os.path.join("sub", "worse.composition.json"),
        "torn.composition.json"}
    assert all(r == "SOC001" for r, *_ in found[TL])


def test_soc001_default_root_is_the_port_s_artifacts(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    soc = tmp_path / "artifacts" / "bench_torch" / "soc"
    soc.mkdir(parents=True)
    (soc / "x.composition.json").write_text("{}")
    findings = []
    TL._lint_soc_artifacts(findings)
    assert {f.subject for f in findings} == {
        os.path.join("soc", "x.composition.json")}
    # the reference's committed artifacts carry their provenance
    findings = []
    TL._lint_soc_artifacts(findings, root=os.path.join(REPO, "artifacts",
                                                       "bench"))
    assert findings == []


# ----------------------------------------------------------------------
# random fronts, composed by both packages
# ----------------------------------------------------------------------
def _random_fronts(rng, apps):
    out = {}
    for app in apps:
        n = int(rng.integers(1, 7))
        theta = np.sort(rng.uniform(0.5, 80.0, n))
        cost = np.sort(rng.uniform(0.1, 40.0, n))
        knobs = [(("ports", int(rng.integers(1, 9))),) for _ in range(n)]
        out[app] = [(float(t), float(c), k)
                    for t, c, k in zip(theta, cost, knobs)]
    return out


@pytest.mark.parametrize("seed", range(12))
def test_random_fronts_compose_identically(seed):
    rng = np.random.default_rng(seed)
    apps = ["a", "b", "c"][:int(rng.integers(1, 4))]
    raw = _random_fronts(rng, apps)
    shares = {a: float(rng.uniform(0.1, 1.0)) for a in apps}
    spec = ",".join(f"{a}={shares[a]!r}" for a in apps)
    over = {a: {"bytes_per_request": float(rng.uniform(0, 2e8)),
                "area_scale": float(rng.uniform(0.2, 3.0))} for a in apps}
    gate = (float(rng.uniform(20, 200)), float(rng.uniform(5, 80)),
            float(rng.uniform(5, 200)))
    tech = int(rng.choice(JB.TECH_NODES))
    results = []
    for C, B, W, P in ((TC, TB, TW, TPoint), (JC, JB, JW, JPoint)):
        fronts = {a: [P(perf=t, cost=c, knobs=k) for t, c, k in pts]
                  for a, pts in raw.items()}
        mix = W.TrafficMix.parse(spec, **over)
        budget = _gate(B, *gate, tech)
        results.append((
            _outcome(C.greedy_composition, budget, mix, fronts),
            _outcome(C.optimal_composition, budget, mix, fronts,
                     max_configs=20_000)))
    assert results[0] == results[1]
