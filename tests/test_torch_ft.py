"""The port's fault-tolerance copies (``repro_torch.ft``): mirrors of
``tests/test_substrate.py``'s straggler, watchdog and elastic tests, and
plans and reports equal to the JAX package's."""

import dataclasses
import os
import tempfile
import time

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.ft import StragglerDetector as RefStragglerDetector
from repro.ft import replan as ref_replan
from repro_torch.ft import (StragglerDetector, Watchdog, largest_pow2_leq,
                            replan)


def test_straggler_detector():
    det = StragglerDetector(4, patience=2)
    for _ in range(4):
        rep = det.update([1.0, 1.0, 1.0, 3.0])
    assert rep.flagged == [3]
    det2 = StragglerDetector(4, patience=2)
    rep = det2.update([1.0, 1.0, 1.0, 3.0])   # one strike only
    assert rep.flagged == []


def test_straggler_reports_equal_the_reference():
    rng = np.random.default_rng(0)
    det, ref = StragglerDetector(8), RefStragglerDetector(8)
    for _ in range(40):
        t = rng.gamma(4.0, 0.25, 8)
        t[5] *= 2.0
        a, b = det.update(t), ref.update(t)
        assert (a.step, a.flagged, a.median) == (b.step, b.flagged, b.median)
        assert np.array_equal(a.ewma, b.ewma)


def test_watchdog_fires_and_recovers():
    events = []
    wd = Watchdog(timeout_s=0.15, poll_s=0.02,
                  on_stall=lambda step, gap: events.append(step))
    wd.beat(1)
    time.sleep(0.4)
    assert wd.stalled and events == [1]
    wd.beat(2)
    assert not wd.stalled
    wd.close()
    assert not wd._thread.is_alive()


def test_watchdog_mirrors_heartbeat_file():
    with tempfile.TemporaryDirectory() as d:
        hb = os.path.join(d, "hb")
        with Watchdog(timeout_s=60.0, heartbeat_file=hb) as wd:
            wd.beat(7)
        with open(hb) as f:
            assert f.read().split()[0] == "7"


@settings(max_examples=50, deadline=None)
@given(st.integers(1, 512))
def test_elastic_plan_properties(surviving):
    plan = replan((2, 16, 16), ("pod", "data", "model"), surviving)
    used = 1
    for s in plan.new_shape:
        used *= s
    assert used <= surviving
    assert used == largest_pow2_leq(surviving)
    assert all(s >= 1 for s in plan.new_shape)


def test_elastic_keeps_tp_when_possible():
    plan = replan((16, 16), ("data", "model"), 255)
    assert plan.new_shape == (8, 16)
    assert not plan.needs_resharding
    plan2 = replan((16, 16), ("data", "model"), 8)
    assert plan2.needs_resharding


def test_elastic_plans_equal_the_reference():
    for shape, names in (((2, 16, 16), ("pod", "data", "model")),
                         ((16, 16), ("data", "model")),
                         ((4, 2), ("data", "model"))):
        total = int(np.prod(shape))
        for surviving in range(1, total + 1):
            for keep in (True, False):
                got = replan(shape, names, surviving, keep_model_axis=keep)
                want = ref_replan(shape, names, surviving,
                                  keep_model_axis=keep)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
