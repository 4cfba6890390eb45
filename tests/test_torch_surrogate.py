"""Surrogate-guided characterization of the PyTorch package: the guided
front is byte-identical to the unguided one, and its oracle spend is the
JAX package's.

A guided session walks Algorithm 1 over the pricing grid and confirms
the surrogate's top corner per component through the real oracle; any
grid/oracle disagreement falls back to the unguided walk.  The fleet
runs on the H100 chip table (the port's default) and, for the spend
comparison, at a ``ChipSpec`` carrying the JAX package's constants.
"""

import dataclasses

import pytest

from repro.core import OracleLedger as RefLedger
from repro.core import RidgeSurrogate as RefSurrogate
from repro.core import build_session as ref_build_session
from repro.core import characterize_component as ref_characterize
from repro.core.autotune import HBM_BYTES_PER_CHIP as REF_HBM
from repro.core.hlsim import ComponentSpec as RefSpec
from repro.core.hlsim import HLSTool as RefHLSTool
from repro.core.hlsim import LoopNest as RefLoopNest
from repro.core.knobs import KnobSpace as RefKnobSpace
from repro.core.xlatool import _HBM_BW, _ICI_BW, _PEAK
from repro_torch.apps.fleet import fleet_xla_tool
from repro_torch.apps.wami import wami_cuda_oracle
from repro_torch.core import (BatchPricer, KnobSpace, OracleLedger,
                              RidgeSurrogate, characterize_component,
                              guided_characterize_component)
from repro_torch.core.chips import ChipSpec
from repro_torch.core.hlsim import ComponentSpec, HLSTool, LoopNest
from repro_torch.core.registry import build_session

REF_CHIP = ChipSpec(name="reference", peak_flops=_PEAK, hbm_bw=_HBM_BW,
                    link_bw=_ICI_BW, hbm_bytes=REF_HBM)


def _run(app, **kw):
    s = build_session(app, **kw)
    return s, s.run()


def _front(res):
    return repr(res.planned), repr(res.mapped)


def _spend(session):
    return sum(session.ledger.invocations.values())


_CELLS = [("wami", {}), ("wami", {"share_plm": True}), ("fleet", {})]


@pytest.mark.parametrize("app,opts", _CELLS,
                         ids=[f"{a}{'-share_plm' if o else ''}"
                              for a, o in _CELLS])
def test_guided_front_byte_identical_and_strictly_cheaper(app, opts):
    plain_s, plain = _run(app, **opts)
    guided_s, guided = _run(app, guided=True, **opts)
    assert _front(guided) == _front(plain)
    assert _spend(guided_s) < _spend(plain_s)
    stats = guided_s.guided
    assert stats and set(stats) == set(plain_s.characterizations)
    assert not any(v["fell_back"] for v in stats.values())
    for name, char in guided_s.characterizations.items():
        assert char.invocations <= plain_s.characterizations[name].invocations


_REF_CELLS = [("wami", {}), ("wami", {"share_plm": True}),
              ("fleet", {"tool": "reference-chip"})]


@pytest.mark.parametrize("app,opts", _REF_CELLS,
                         ids=["wami", "wami-share_plm", "fleet"])
def test_guided_spend_and_front_equal_the_reference(app, opts):
    opts = dict(opts)
    if opts.pop("tool", None):
        opts["tool"] = fleet_xla_tool(chip=REF_CHIP)
    port_s, port = _run(app, guided=True, **opts)
    opts.pop("tool", None)
    ref_s = ref_build_session(app, guided=True, **opts)
    ref = ref_s.run()
    assert _front(port) == _front(ref)
    assert dict(port_s.ledger.invocations) == dict(ref_s.ledger.invocations)
    assert port_s.guided == ref_s.guided


@pytest.mark.parametrize("workers", [1, 4])
def test_guided_is_deterministic_across_worker_counts(workers):
    base_s, base = _run("wami", guided=True)
    par_s, par = _run("wami", guided=True, workers=workers)
    assert _front(par) == _front(base)
    assert dict(par_s.ledger.invocations) == dict(base_s.ledger.invocations)


def test_guided_is_refused_on_the_measured_backend():
    with pytest.raises(ValueError, match="analytical pricing grid"):
        build_session("wami", "cuda", guided=True, device="cpu",
                      device_kind="interpret", smem_budget=16 * 2 ** 20)
    oracle = wami_cuda_oracle(device="cpu", device_kind="interpret",
                              smem_budget=16 * 2 ** 20)
    with pytest.raises(ValueError, match="CudaOracle has none"):
        build_session("wami", "cuda", tool=oracle, guided=True)


# ----------------------------------------------------------------------
# poisoning: neither a bad ranker nor a bad grid may change the front
# ----------------------------------------------------------------------
class _PoisonedSurrogate(RidgeSurrogate):
    """Always 'fitted', adversarially inverted ranking."""

    @property
    def fitted(self):
        return True

    def predict(self, component, unrolls, ports, tile):
        return -float(unrolls * 31 + ports * 7 + tile)


def test_poisoned_surrogate_cannot_change_the_front():
    plain_s, plain = _run("wami")
    guided_s, guided = _run("wami", guided=True,
                            surrogate=_PoisonedSurrogate())
    assert _front(guided) == _front(plain)
    assert _spend(guided_s) < _spend(plain_s)


_LOOP = (256, 2, 1, 8, 3, 6)


def _toy_tool():
    return HLSTool({"a": ComponentSpec("a", LoopNest(*_LOOP), 1024, 1024)})


class _PoisonedPricer:
    """Grid facade whose feasible latencies are subtly wrong — the
    oracle confirmation must catch the disagreement."""

    def __init__(self, pricer):
        self._p = pricer

    def synthesize(self, component, **kw):
        s = self._p.synthesize(component, **kw)
        if s.feasible:
            return dataclasses.replace(s, lam=s.lam * (1.0 + 1e-6))
        return s

    def cdfg_facts(self, component, synth):
        return self._p.cdfg_facts(component, synth)


def test_poisoned_grid_is_caught_and_falls_back_to_exact_front():
    space = KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8)
    ref = characterize_component(OracleLedger(_toy_tool()), "a", space)

    tool = _toy_tool()
    gc = guided_characterize_component(
        OracleLedger(tool), "a", space,
        pricer=_PoisonedPricer(BatchPricer(tool)))
    assert gc.fell_back and gc.confirmed == 1
    assert repr(gc.result.regions) == repr(ref.regions)
    assert repr(gc.result.points) == repr(ref.points)
    assert gc.result.invocations == ref.invocations


def test_healthy_grid_confirms_one_invocation_per_component():
    space = KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8)
    ref = characterize_component(OracleLedger(_toy_tool()), "a", space)

    tool = _toy_tool()
    gc = guided_characterize_component(
        OracleLedger(tool), "a", space, pricer=BatchPricer(tool))
    assert not gc.fell_back and gc.confirmed == 1
    assert repr(gc.result.regions) == repr(ref.regions)
    assert repr(gc.result.points) == repr(ref.points)
    assert gc.result.invocations == 1
    assert gc.grid_invocations == ref.invocations


def test_surrogate_fits_online_and_predicts_as_the_reference():
    ledger = OracleLedger(_toy_tool())
    space = KnobSpace(clock_ns=1.0, max_ports=16, max_unrolls=32)
    characterize_component(ledger, "a", space)   # generate records
    ref_ledger = RefLedger(RefHLSTool(
        {"a": RefSpec("a", RefLoopNest(*_LOOP), 1024, 1024)}))
    ref_characterize(ref_ledger, "a",
                     RefKnobSpace(clock_ns=1.0, max_ports=16,
                                  max_unrolls=32))
    sur, ref_sur = RidgeSurrogate(), RefSurrogate()
    assert not sur.fitted
    with pytest.raises(RuntimeError):
        sur.predict("a", 1, 1, 0)
    assert sur.fit(ledger.records) and ref_sur.fit(ref_ledger.records)
    assert sur.fitted
    for u, p in ((1, 1), (8, 4), (32, 16), (3, 2)):
        assert sur.predict("a", u, p, 0) == ref_sur.predict("a", u, p, 0)
    # more parallelism must not predict slower on this monotone toy
    assert sur.predict("a", 8, 4, 0) <= sur.predict("a", 1, 1, 0)
