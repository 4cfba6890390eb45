"""Session state, the checkpoint store and the persistent oracle cache of
the PyTorch package, and their round trips across the two packages.

  * ``ExplorationSession.save`` after ``map()`` restores the whole
    result with zero tool invocations; after ``characterize()`` only the
    map phase is paid again; a share-PLM state keeps its schedules and
    compat tags through a JSON trip;
  * ``repro_torch.checkpoint.store`` writes the JAX package's layout
    (``step_XXXXXXXX/``, ``manifest.json``, one ``.npy`` per leaf under
    the same ``/``-joined path, ``LATEST``), so a session checkpoint or a
    ``PersistentOracleCache`` directory written by either package loads
    in the other;
  * a cache resumes a killed drive without re-invoking a flushed point.
"""

import json
import os

import numpy as np
import pytest

from repro.checkpoint import store as ref_store
from repro.core import ExplorationSession as RefSession
from repro.core import PersistentOracleCache as RefCache
from repro.core import build_session as ref_build_session
from repro_torch.checkpoint import store
from repro_torch.core import (CountingTool, ExplorationSession, HLSTool,
                              KnobSpace, OracleLedger,
                              PersistentOracleCache, build_session,
                              cosmos_dse, pipeline_tmg)
from repro_torch.core.hlsim import ComponentSpec, LoopNest


def _specs():
    return {
        "a": ComponentSpec("a", LoopNest(256, 2, 1, 8, 3, 6), 1024, 1024),
        "b": ComponentSpec("b", LoopNest(128, 1, 1, 4, 2, 4), 512, 512),
    }


def _system():
    specs = _specs()
    tmg = pipeline_tmg(list(specs), buffers=2)
    spaces = {n: KnobSpace(clock_ns=1.0, max_ports=4, max_unrolls=8)
              for n in specs}
    return specs, tmg, spaces


class SpyTool(HLSTool):
    calls = 0

    def synthesize(self, *a, **k):
        self.calls += 1
        return super().synthesize(*a, **k)


class _PoisonTool:
    """A restore that needs ANY tool traffic is a serialization bug."""

    def synthesize(self, *a, **k):
        raise AssertionError("restore must not invoke the tool")

    def cdfg_facts(self, *a, **k):
        raise AssertionError("restore must not invoke the tool")


# ----------------------------------------------------------------------
# the checkpoint store: the JAX package's layout and leaf paths
# ----------------------------------------------------------------------
_TREE = {"b": [np.arange(3, dtype=np.int32), {"z": np.float32(2.5)}],
         "a": np.ones((2, 2)), "none": None, "t": (np.int64(7),)}


def _manifest(root, step):
    with open(os.path.join(root, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_store_writes_the_reference_layout(tmp_path):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    store.save(mine, 3, _TREE, extra={"k": [1, 2]})
    ref_store.save(theirs, 3, _TREE, extra={"k": [1, 2]})
    assert _manifest(mine, 3) == _manifest(theirs, 3)
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == \
        ["LATEST", "step_00000003"]
    assert sorted(os.listdir(os.path.join(mine, "step_00000003"))) == \
        sorted(os.listdir(os.path.join(theirs, "step_00000003")))
    paths = [m["path"] for m in _manifest(mine, 3)["leaves"]]
    assert paths == ["a", "b/0", "b/1/z", "t/0"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_restores_across_packages(tmp_path, writer):
    root = str(tmp_path / "ck")
    save = store.save if writer == "port" else ref_store.save
    load = ref_store.restore if writer == "port" else store.restore
    save(root, 1, _TREE, extra={"x": 1})
    save(root, 2, _TREE, extra={"x": 2})
    assert store.list_steps(root) == ref_store.list_steps(root) == [1, 2]
    assert store.latest_step(root) == ref_store.latest_step(root) == 2
    tree, extra = load(root, 2, _TREE)
    assert extra == {"x": 2}
    assert tree["none"] is None and isinstance(tree["t"], tuple)
    np.testing.assert_array_equal(tree["b"][0], _TREE["b"][0])
    assert tree["b"][1]["z"] == np.float32(2.5)


def test_store_ignores_a_leftover_tmp_and_a_stale_pointer(tmp_path):
    root = str(tmp_path / "ck")
    store.save(root, 1, {"n": np.asarray(1)})
    os.makedirs(os.path.join(root, "step_00000002.tmp"))
    assert store.list_steps(root) == [1]
    with open(os.path.join(root, "LATEST"), "w") as f:
        f.write("9")                  # pointer to a step that never landed
    assert store.latest_step(root) == 1
    with pytest.raises(ValueError, match="shape"):
        store.restore(root, 1, {"n": np.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        store.restore(root, 1, {"m": np.asarray(0)})


# ----------------------------------------------------------------------
# session save / restore
# ----------------------------------------------------------------------
def test_save_restore_after_characterize(tmp_path):
    specs, tmg, spaces = _system()
    root = str(tmp_path / "session")
    s1 = ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3)
    s1.characterize()
    s1.save(root)
    ref = s1.run()
    s2 = ExplorationSession.restore(root, tmg, HLSTool(dict(specs)),
                                    spaces, delta=0.3)
    assert repr(s2.characterizations) == repr(s1.characterizations)
    res = s2.run()
    assert repr(res.mapped) == repr(ref.mapped)
    assert s2.ledger.total() < s1.ledger.total()


def test_save_after_map_restores_with_zero_invocations(tmp_path):
    specs, tmg, spaces = _system()
    root = str(tmp_path / "session")
    s1 = ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3)
    ref = s1.run()
    s1.save(root)
    s2 = ExplorationSession.restore(root, tmg, _PoisonTool(), spaces,
                                    delta=0.3)
    res = s2.run()
    assert s2.ledger.total() == 0
    assert repr(res.mapped) == repr(ref.mapped)
    assert repr(res.planned) == repr(ref.planned)
    assert [m.schedule.tag() for m in res.mapped] == \
        [m.schedule.tag() for m in ref.mapped]


def test_restore_with_persistent_cache_reinvokes_nothing(tmp_path):
    specs, tmg, spaces = _system()
    sroot, croot = str(tmp_path / "session"), str(tmp_path / "cache")
    s1 = ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3,
                            cache=PersistentOracleCache(croot))
    ref = s1.run()
    s1.save(sroot)
    spy = SpyTool(dict(specs))
    s2 = ExplorationSession.restore(sroot, tmg, spy, spaces, delta=0.3,
                                    cache=PersistentOracleCache(croot))
    res = s2.run()
    assert spy.calls == 0
    assert repr(res.mapped) == repr(ref.mapped)
    assert res.invocations == ref.invocations


def test_state_round_trips_schedule_and_compat_tag():
    s1 = build_session("wami", "analytical", share_plm=True)
    ref = s1.run()
    state = json.loads(json.dumps(s1.state()))
    assert state["version"] == 2
    assert state == json.loads(json.dumps(
        _ref_wami_share_plm_session().state()))
    s2 = build_session("wami", "analytical", share_plm=True,
                       tool=_PoisonTool())
    s2.load_state(state)
    res = s2.result()
    assert repr(res.mapped) == repr(ref.mapped)
    for got, want in zip(res.mapped, ref.mapped):
        assert got.memory_plan.compat_tag == want.memory_plan.compat_tag
        assert got.schedule.tag() == want.schedule.tag()


def _ref_wami_share_plm_session():
    s = ref_build_session("wami", "analytical", share_plm=True)
    s.run()
    return s


def test_version1_snapshot_still_loads():
    specs, tmg, spaces = _system()
    s1 = ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3)
    ref = s1.run()
    v1 = {k: v for k, v in s1.state().items() if k != "mapped"}
    v1["version"] = 1
    s2 = ExplorationSession(tmg, HLSTool(dict(specs)), spaces, delta=0.3)
    s2.load_state(v1)
    assert s2.mapped is None
    assert repr(s2.run().mapped) == repr(ref.mapped)
    with pytest.raises(ValueError, match="version"):
        s2.load_state({"version": 9})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_session_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """A WAMI session saved after ``map()`` by either package restores
    in the other with zero invocations and the same front."""
    root = str(tmp_path / "session")
    port = build_session("wami")
    port_res = port.run()
    ref = ref_build_session("wami")
    ref_res = ref.run()
    assert repr(port_res.mapped) == repr(ref_res.mapped)
    (port if writer == "port" else ref).save(root)
    if writer == "port":
        other = RefSession.restore(root, ref.tmg, _PoisonTool(), ref.spaces,
                                   delta=ref.delta, fixed=ref.fixed)
    else:
        other = ExplorationSession.restore(root, port.tmg, _PoisonTool(),
                                           port.spaces, delta=port.delta,
                                           fixed=port.fixed)
    res = other.run()
    assert other.ledger.total() == 0
    assert repr(res.mapped) == repr(port_res.mapped)


# ----------------------------------------------------------------------
# the persistent oracle cache
# ----------------------------------------------------------------------
def test_countingtool_is_the_ledger():
    assert issubclass(CountingTool, OracleLedger)
    led = CountingTool(HLSTool(_specs()))
    led.synthesize("a", unrolls=1, ports=1)
    led.synthesize("a", unrolls=1, ports=1)
    assert led.total("a") == 1


def test_persistent_cache_resume(tmp_path):
    specs, tmg, spaces = _system()
    root = str(tmp_path / "oracle-cache")
    t1 = SpyTool(dict(specs))
    r1 = cosmos_dse(tmg, t1, spaces, delta=0.3,
                    cache=PersistentOracleCache(root), workers=4)
    assert t1.calls > 0
    t2 = SpyTool(dict(specs))
    r2 = cosmos_dse(tmg, t2, spaces, delta=0.3,
                    cache=PersistentOracleCache(root), workers=4)
    assert t2.calls == 0
    assert repr(r1.mapped) == repr(r2.mapped)
    assert r1.invocations == r2.invocations


def test_persistent_cache_partial_resume(tmp_path):
    specs, tmg, spaces = _system()
    root = str(tmp_path / "cache")
    led = OracleLedger(SpyTool(dict(specs)),
                       cache=PersistentOracleCache(root, flush_every=1))
    led.synthesize("a", unrolls=1, ports=1)
    led.synthesize("a", unrolls=2, ports=2)
    t_ref, t_res = SpyTool(dict(specs)), SpyTool(dict(specs))
    ref = cosmos_dse(tmg, t_ref, spaces, delta=0.3)
    res = cosmos_dse(tmg, t_res, spaces, delta=0.3,
                     cache=PersistentOracleCache(root))
    assert t_res.calls < t_ref.calls
    assert repr(ref.mapped) == repr(res.mapped)
    assert ref.invocations == res.invocations


def test_persistent_cache_tile_keys_and_legacy_records(tmp_path):
    specs = _specs()
    specs["t"] = ComponentSpec("t", LoopNest(256, 2, 1, 8, 3, 6), 1024,
                               1024, outer_repeats=4, base_tile=32)
    root = str(tmp_path / "cache")
    led = OracleLedger(SpyTool(dict(specs)),
                       cache=PersistentOracleCache(root, flush_every=1))
    s32 = led.synthesize("t", unrolls=4, ports=2, tile=32)
    s64 = led.synthesize("t", unrolls=4, ports=2, tile=64)
    assert s32.area != s64.area
    led2 = OracleLedger(SpyTool(dict(specs)),
                        cache=PersistentOracleCache(root))
    assert led2.synthesize("t", unrolls=4, ports=2, tile=64).area == s64.area
    assert led2.total("t") == 2
    legacy_root = str(tmp_path / "legacy")
    entry = {"key": ["t", 4, 2, None],
             "synth": {"lam": 1.0, "area": 2.0, "ports": 2, "unrolls": 4,
                       "states": 3, "feasible": True, "detail": {}}}
    store.save(legacy_root, 1, {"n_entries": np.asarray(1)},
               extra={"entries": [entry]})
    (key, synth), = PersistentOracleCache(legacy_root).entries().items()
    assert key == ("t", 4, 2, None, 0)
    assert synth.area == 2.0 and synth.tile == 0


def test_persistent_cache_keeps_only_the_newest_steps(tmp_path):
    root = str(tmp_path / "cache")
    cache = PersistentOracleCache(root, flush_every=1)
    led = OracleLedger(HLSTool(_specs()), cache=cache)
    for u in (1, 2, 3, 4):
        led.synthesize("a", unrolls=u, ports=1)
    assert len(store.list_steps(root)) == PersistentOracleCache.KEEP_STEPS
    assert store.list_steps(root) == [3, 4]
    assert len(PersistentOracleCache(root)) == 4


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cache_directory_loads_in_the_other_package(tmp_path, writer):
    """A WAMI drive's cache written by either package reloads in the
    other as the same entries, and resumes there with zero fresh
    invocations and the same front."""
    root = str(tmp_path / "cache")
    if writer == "port":
        build_session("wami", cache=PersistentOracleCache(root)).run()
    else:
        ref_build_session("wami", cache=RefCache(root)).run()
    mine = PersistentOracleCache(root).entries()
    theirs = RefCache(root).entries()
    assert list(mine) == list(theirs)
    assert all(repr(mine[k]) == repr(theirs[k]) for k in mine)
    if writer == "port":
        s = ref_build_session("wami", cache=RefCache(root))
    else:
        s = build_session("wami", cache=PersistentOracleCache(root))
    res = s.run()
    counts = s.ledger.outcome_counts()
    assert counts["fresh"] == 0 and counts["replay"] == len(mine)
    assert repr(res.mapped) == repr(build_session("wami").run().mapped)
