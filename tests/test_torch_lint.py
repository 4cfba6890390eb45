"""The port's static lint against the JAX package's, and on its own
registry.

  * the reference's seeded broken app (tests/test_analysis.py), rebuilt
    with the port's ``App``, gives the same findings in both packages;
  * on the port's registry, with every declared card recording
    committed (WAMI tiles 64, 128, 256; the fleet's one file), the lint
    finds nothing; pointed at copies of the reference's interpret-mode
    recordings it is clean;
  * SPEC003 checks the kernel specs' double-buffered footprints against
    an H100's 232,448 bytes of opt-in shared memory per block;
  * OBS001 on a seeded oracle class, SOC001's provenance rule, and the
    CLI's exit codes;
  * ``App.parity_cases`` of both apps are the cases the apps' own
    factories build.
"""

import dataclasses
import json
import os
import shutil
import sys

import pytest
import torch

from repro.core import registry as JR
from repro.core.analysis import lint as JL
from repro.core.knobs import KnobSpace as JKnobSpace
from repro.core.tmg import pipeline_tmg as j_pipeline_tmg
import repro_torch.apps.fleet.pipeline as TF
import repro_torch.apps.wami.cuda as TWC
from repro_torch.core import registry as TR
from repro_torch.core.analysis import lint as TL
from repro_torch.core.cuda_oracle import H100_SMEM_OPTIN_BYTES
from repro_torch.core.knobs import KnobSpace
from repro_torch.core.tmg import pipeline_tmg
from repro_torch.kernels.flash_attention import H100_SMEM_OPTIN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEASUREMENTS = os.path.join(REPO, "artifacts", "measurements")
# the findings of the port's registry, (rule, app, subject): none, every
# declared card recording committed
UNRECORDED = []
# the card recordings the apps declare
CARD_RECORDINGS = ["fleet_cuda.json", "wami_cuda_tile128.json",
                   "wami_cuda_tile256.json", "wami_cuda_tile64.json"]


def _keys(findings):
    return [(f.rule, f.app, f.subject) for f in findings]


def _broken_app(App, KS, tmg_fn, tmp_path):
    """tests/test_analysis.py's app seeded with one violation per rule
    family, built with either package's ``App``; its parity-case factory
    takes the port's ``device=`` keyword (the reference's lint calls it
    with no argument)."""
    def tmg():
        return tmg_fn(["a", "b"], buffers=1)

    bad_store = tmp_path / "bad.json"
    bad_store.write_text(json.dumps(
        {"version": 1, "meta": {},
         "entries": {"a:p2:u1": 0.5, "nonsense-key": 1.0,
                     "a:p4:u1": -3.0}}))

    def spaces():
        return {"a": KS(clock_ns=1.0, min_ports=3, max_ports=3,
                        max_unrolls=2, tile_sizes=(64, 64))}

    return App(
        name="lint_seeded_test_app",
        description="deliberately violates one rule per family",
        tmg=tmg, knob_spaces=spaces,
        analytical=lambda: (_ for _ in ()).throw(RuntimeError("boom")),
        measurement_path=lambda t: str(tmp_path / ("missing.json"
                                                   if t == 7 else
                                                   "bad.json")),
        recorded_tiles=(7, 9),
        default_tiles=(5,),
        parity_cases=lambda tile=None, device=None: [("x", 1, 2, ())],
    )


def _port_broken(tmp_path):
    return _broken_app(TR.App, KnobSpace, pipeline_tmg, tmp_path)


def _on_copies(tmp_path):
    """The port's apps pointed at copies of the reference's recordings
    (interpret mode, ``artifacts/measurements/*_pallas*.json``)."""
    for name in os.listdir(MEASUREMENTS):
        if "_pallas" in name:
            shutil.copy(os.path.join(MEASUREMENTS, name), tmp_path)
    wami = dataclasses.replace(
        TR.get_app("wami"), measurement_path=lambda t: str(
            tmp_path / f"wami_pallas_tile{t}.json"))
    fleet = dataclasses.replace(
        TR.get_app("fleet"), measurement_path=lambda t=0: str(
            tmp_path / "fleet_pallas.json"))
    return wami, fleet


# ----------------------------------------------------------------------
# the seeded app: the same findings in both packages
# ----------------------------------------------------------------------
def test_seeded_app_gives_the_reference_s_findings(tmp_path):
    port = TL.lint_app(_port_broken(tmp_path))
    ref = JL.lint_app(_broken_app(JR.App, JKnobSpace, j_pipeline_tmg,
                                  tmp_path))
    assert [str(f) for f in port] == [str(f) for f in ref]
    rules = {f.rule for f in port}
    assert {"REG001", "REG002", "REG003", "REG004", "REG005", "REG006",
            "KNOB001", "KNOB002"} <= rules
    assert len([f for f in port if f.rule == "REG004"]) == 2
    assert all(str(f).startswith(f.rule) for f in port)


@pytest.mark.parametrize("cases,subject", [
    (lambda tile=None, device=None: [], "parity_cases"),
    (lambda tile=None, device=None: [("x", len, len, 3)], "parity_cases[0]"),
    (lambda: [("x", len, len, ())], "parity_cases"),
])
def test_reg002_reports_malformed_parity_cases(cases, subject, tmp_path):
    """An empty list, a case whose args are not a sequence, and a factory
    without the ``device=`` keyword the port's protocol requires."""
    app = dataclasses.replace(TR.get_app("fleet"), name="p",
                              parity_cases=cases)
    reg2 = [f for f in TL.lint_app(app) if f.rule == "REG002"]
    assert [f.subject for f in reg2] == [subject]


def test_lint_finding_is_the_reference_s_record():
    f = TL.LintFinding("REG003", "wami", "tile=64", "missing")
    assert str(f) == str(JL.LintFinding("REG003", "wami", "tile=64",
                                        "missing"))
    assert str(f) == "REG003 wami/tile=64: missing"


# ----------------------------------------------------------------------
# the port's registry
# ----------------------------------------------------------------------
def test_registry_lints_to_the_four_unrecorded_tiles():
    """Every declared card recording is committed, so no REG003 is left,
    and they pass the schema (no REG004); nothing else is found (no
    SPEC003 against the card's budget, no REG002: both apps' parity
    cases build on the CPU)."""
    findings = TL.lint_all()
    assert _keys(findings) == UNRECORDED
    declared = sorted(os.path.basename(app.measurement_path(t))
                      for app in TR.list_apps() for t in app.recorded_tiles)
    assert declared == CARD_RECORDINGS
    for name in declared:
        assert os.path.exists(os.path.join(MEASUREMENTS, name))
    # without one of them, its REG003 is back
    wami = dataclasses.replace(TR.get_app("wami"), measurement_path=lambda
                               t: os.path.join(MEASUREMENTS,
                                               f"missing_tile{t}.json"))
    assert [f.subject for f in TL.lint_app(wami)
            if f.rule == "REG003"] == ["tile=64", "tile=128", "tile=256"]


def test_registry_lints_clean_on_copies_of_the_reference_recordings(
        tmp_path):
    wami, fleet = _on_copies(tmp_path)
    assert TL.lint_app(wami) == [] and TL.lint_app(fleet) == []
    assert TL.lint_all([fleet, wami]) == []


def test_reg004_on_a_recording_the_port_writes(tmp_path):
    """A recording saved by the port's store passes the schema check; a
    malformed key or a non-positive wall does not."""
    from repro_torch.core import MeasurementStore
    store = MeasurementStore(meta={"tile": 0})
    store.put(("flash_attention", 1, 1), 1.25e-5)
    store.put(("ssd_scan", 2, 8), 1.5e-5)
    good = store.save(str(tmp_path / "fleet_cuda.json"))
    fleet = dataclasses.replace(TR.get_app("fleet"),
                                measurement_path=lambda t=0: good)
    assert TL.lint_app(fleet) == []
    doc = json.loads(open(good).read())
    doc["entries"]["ssd_scan:p2:u8"] = 0.0
    doc["entries"]["ssd_scan:2:8"] = 1.0
    with open(good, "w") as f:
        json.dump(doc, f)
    assert sorted(f.detail.split(" (")[0].split(" for")[0]
                  for f in TL.lint_app(fleet)) == [
        "malformed entry key 'ssd_scan:2:8'", "non-positive wall 0.0"]


# ----------------------------------------------------------------------
# SPEC003: the card's shared memory
# ----------------------------------------------------------------------
def test_the_budget_is_an_h100_s_opt_in_shared_memory():
    assert H100_SMEM_OPTIN_BYTES == 232448 == 227 * 1024 == H100_SMEM_OPTIN


@pytest.mark.parametrize("app,comp,infeasible", [
    ("fleet", "flash_attention", [(1, 4), (1, 8)]),
    ("wami", "debayer", [(1, 32)]),
    ("wami", "change_det", [(1, 16)]),
])
def test_points_past_the_budget_leave_a_feasible_one(app, comp, infeasible):
    """The points the card's budget rules out (ROADMAP, "Shared-memory
    cap"), each component keeping a feasible one, so no SPEC003."""
    a = TR.get_app(app)
    spec = a.kernel_specs(a.native_tile, device="cpu")[comp]
    space = a.knob_spaces()[comp]
    H, W = spec.shape
    over, fits = [], []
    for p in space.ports():
        for u in range(1, space.max_unrolls + 1):
            if spec.divisible(p, u):
                step = spec.vmem_bytes(H, W, ports=p, unrolls=u)
                (over if 2 * step > H100_SMEM_OPTIN_BYTES
                 else fits).append((p, u))
    assert over == infeasible and fits
    assert not [f for f in TL.lint_app(a) if f.rule.startswith("SPEC")]


def test_spec003_fires_when_no_point_fits(monkeypatch):
    """At a budget below the smallest footprint every component of the
    fleet is reported, naming the budget."""
    import repro_torch.core.cuda_oracle as CO
    monkeypatch.setattr(CO, "H100_SMEM_OPTIN_BYTES", 1024)
    spec3 = [f for f in TL.lint_app(TR.get_app("fleet"))
             if f.rule == "SPEC003"]
    assert [f.subject for f in spec3] == ["flash_attention", "ssd_scan"]
    assert all("(1024 bytes)" in f.detail for f in spec3)


def test_spec001_and_spec002():
    """A spec for a component the TMG lacks, and a grayscale frame 127
    wide that no even port count divides."""
    wami = TR.get_app("wami")

    def specs(tile, device=None):
        out = dict(wami.kernel_specs(tile, device=device))
        out["ghost"] = out["debayer"]
        out["grayscale"] = dataclasses.replace(out["grayscale"],
                                               shape=(128, 127))
        return out

    def spaces(**kw):
        out = dict(wami.knob_spaces(**kw))
        out["grayscale"] = dataclasses.replace(out["grayscale"],
                                               min_ports=2)
        return out
    found = _keys(TL.lint_app(dataclasses.replace(
        wami, kernel_specs=specs, knob_spaces=spaces,
        measurement_path=None)))
    assert found == [("SPEC001", "wami", "ghost"),
                     ("SPEC002", "wami", "grayscale")]


# ----------------------------------------------------------------------
# OBS001
# ----------------------------------------------------------------------
_SEEDED = '''
from typing import Protocol


class Declared(Protocol):
    def evaluate_batch(self, requests): ...


class Traced:
    def evaluate_batch(self, requests):
        with self.tracer.span("x"):
            return list(requests)


class Untraced:
    def evaluate_batch(self, requests):
        return [self.price(r) for r in requests]
'''


def test_obs001_flags_a_seeded_untraced_oracle(tmp_path, monkeypatch):
    (tmp_path / "lint_seeded_oracles.py").write_text(_SEEDED)
    monkeypatch.syspath_prepend(str(tmp_path))
    found = {}
    for L in (TL, JL):
        monkeypatch.setattr(L, "_OBS_ORACLE_MODULES",
                            ("lint_seeded_oracles", "no_such_module_x"))
        findings = []
        L._lint_observability(findings)
        found[L] = [str(f) for f in findings]
    assert found[TL] == found[JL]
    assert [f.split(":")[0] for f in found[TL]] == [
        "OBS001 repo/lint_seeded_oracles.Untraced",
        "OBS001 repo/no_such_module_x"]
    sys.modules.pop("lint_seeded_oracles", None)


def test_obs001_walks_the_port_s_oracle_modules():
    """The port's oracle classes all report to the tracer, the autotune
    module's ``XLAOracle`` (its ``evaluate_batch`` under a ``tool.batch``
    span) among them."""
    import repro_torch.core.autotune as TA
    assert TL._OBS_ORACLE_MODULES == ("repro_torch.core.oracle",
                                      "repro_torch.core.autotune")
    assert "evaluate_batch" in vars(TA.XLAOracle)
    findings = []
    TL._lint_observability(findings)
    assert findings == []


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------
def test_cli_exit_codes(tmp_path, capsys):
    assert TL.main([]) == 0
    out = capsys.readouterr()
    assert out.err == ""
    assert out.out.splitlines() == [
        "lint ok: [fleet, wami] — registry, kernel specs, and knob spaces "
        "are statically clean"]
    assert TL.main(["--app", "wami"]) == 0
    assert capsys.readouterr().out.startswith("lint ok: [wami] — ")
    wami, fleet = _on_copies(tmp_path)
    for app in (_port_broken(tmp_path),
                dataclasses.replace(wami, name="wami_on_copies")):
        TR.register_app(app)
    try:
        assert TL.main(["--app", "lint_seeded_test_app"]) == 1
        err = capsys.readouterr().err
        assert "REG003" in err and "KNOB001" in err
        assert TL.main(["--app", "wami_on_copies"]) == 0
        assert capsys.readouterr().out.startswith(
            "lint ok: [wami_on_copies]")
        with pytest.raises(KeyError, match="registered apps"):
            TL.main(["--app", "nosuchapp"])
    finally:
        TR._APPS.pop("lint_seeded_test_app", None)
        TR._APPS.pop("wami_on_copies", None)


# ----------------------------------------------------------------------
# App.parity_cases
# ----------------------------------------------------------------------
@pytest.mark.parametrize("app,factory,tile", [
    ("wami", TWC.wami_cuda_parity_cases, 64),
    ("wami", TWC.wami_cuda_parity_cases, 128),
    ("fleet", TF.fleet_cuda_parity_cases, TF.FLASH_S),
])
def test_registry_parity_cases_are_the_app_s_own(app, factory, tile):
    got = TR.get_app(app).parity_cases(tile, device="cpu")
    want = factory(tile, device="cpu")
    assert [c[0] for c in got] == [c[0] for c in want]
    for (_, op, plain, args), (_, op2, plain2, args2) in zip(got, want):
        assert op.__qualname__ == op2.__qualname__
        assert plain.__qualname__ == plain2.__qualname__
        assert all(torch.equal(a, b) for a, b in zip(args, args2))
        # every op takes the knobs; on the CPU it is its plain version
        out = op(*args, ports=1, unrolls=8)
        ref = plain(*args)
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(out, ref, strict=True):
            assert o.shape == r.shape and o.dtype == r.dtype
    assert [c[0] for c in got] == (
        ["flash_attention", "ssd_scan"] if app == "fleet" else
        ["wami_debayer", "wami_grayscale", "wami_gradient", "wami_steep",
         "wami_hessian", "wami_warp", "wami_change_det"])
