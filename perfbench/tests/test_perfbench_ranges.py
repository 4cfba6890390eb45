"""The readers of the program's own ranges (``mamba.ssd``,
``remat.recompute``, ``mamba.mixer``) on a synthetic traced window: each
gives its defined value, and nothing where the trace lacks its range;
the mixers' model FLOPs of the cell's step by the configuration and
traffic files."""

import json
import os
import types

import pytest

from perfbench.common import TraceSummary
from perfbench.flops import PEAKS
from perfbench.run import HERE, load_metric

CONFIG = json.load(open(os.path.join(HERE, "configs", "mamba2-780m.json")))
MIX = json.load(open(os.path.join(HERE, "traffic", "train-rows-2k.json")))
TOKENS = MIX["batch"] * MIX["seq_len"]
SPANS = {"mamba.ssd": 3.5, "remat.recompute": 1.5, "mamba.mixer": 5.0}
MIXER_FLOPS = load_metric("mixer_mfu.train").step_flops(
    CONFIG, MIX["seq_len"], TOKENS)


def _ctx(spans):
    t = TraceSummary(window_s=6.5, busy_s=6.4, device_ops=[], idle_gaps=[],
                     span_device_s=dict(spans),
                     span_count={k: 288 for k in spans}, kernel_s=6.0)
    return types.SimpleNamespace(
        traced=t, config=CONFIG, mix=MIX,
        records={"seq_len": MIX["seq_len"], "tokens_per_step": TOKENS,
                 "batch": MIX["batch"]})


def test_mixer_flops_of_the_cells_step():
    assert round(MIXER_FLOPS / 1e12, 1) == 186.8


@pytest.mark.parametrize("metric,expected", [
    ("ssd_share.train", 100.0 * 3.5 / 6.0),
    ("recompute_share.train", 100.0 * 1.5 / 6.0),
    ("mixer_mfu.train",
     100.0 * MIXER_FLOPS * MIX["trace_steps"] / 5.0 / PEAKS["bf16_flops"]),
])
def test_readers_of_the_programs_ranges(metric, expected):
    r = load_metric(metric)
    assert r.read(_ctx(SPANS)) == pytest.approx(expected, rel=1e-12)
    assert r.SPAN in SPANS and not hasattr(r, "WRAP")
    # a program without the range (the parent of the ranges, or a
    # refactor that drops one) gives no reading, not 0
    others = {k: v for k, v in SPANS.items() if k != r.SPAN}
    assert r.read(_ctx(others)) is None
    assert r.read(types.SimpleNamespace(traced=None, records={})) is None
