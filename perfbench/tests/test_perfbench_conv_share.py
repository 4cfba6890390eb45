"""The reader of the program's ``mamba.conv`` range
(``conv_share.train``) on a synthetic traced window: the conv's device
time over all device time, and nothing where the trace lacks the range
(a program without it, as before the conv had its own kernels)."""

import types

import pytest

from perfbench.common import TraceSummary
from perfbench.run import load_metric


def _ctx(spans):
    t = TraceSummary(window_s=6.5, busy_s=6.4, device_ops=[], idle_gaps=[],
                     span_device_s=dict(spans),
                     span_count={k: 288 for k in spans}, kernel_s=6.0)
    return types.SimpleNamespace(traced=t, records={})


def test_conv_share_reads_the_conv_range():
    r = load_metric("conv_share.train")
    spans = {"mamba.conv": 0.12, "mamba.ssd": 3.5, "mamba.mixer": 5.0}
    assert r.read(_ctx(spans)) == pytest.approx(2.0, rel=1e-12)
    assert r.SPAN == "mamba.conv" and not hasattr(r, "WRAP")
    del spans["mamba.conv"]
    assert r.read(_ctx(spans)) is None
    assert r.read(types.SimpleNamespace(traced=None, records={})) is None
