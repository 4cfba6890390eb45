"""The controls at a size a test run holds, judged as a run judges
(``Context.judge`` and ``Context.correct`` against the cell's committed
limits): the program passes, and the reference in float8 (products,
residual stream and gradients) put in its place, and half a batch left
out, do not.  The reference with its SSD in bf16 is read too; at the
cell's own size, on the card, it fails the limit of the leaf it moves
(A_log's first gradient; readings in PERF.md).  On the card
``perfbench/tools/control.py`` takes the same readings at full size."""

import json
import os

import pytest

from perfbench.run import ROOT
from perfbench.tests.small import small_config, small_mix
from perfbench.tools.control import CONTROLS, readings

CELLS = [c["name"] for c in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    got = []
    readings(cell, [2**31 + 3], {2**31 + 3}, device="cpu",
             config_override=small_config, mix_override=small_mix,
             emit=got.append)
    by_side = {r["side"]: r for r in got}
    assert set(by_side) == {"program", "fault_half_batch",
                            *("control_" + k for k in CONTROLS)}
    assert by_side["program"]["correct"], by_side["program"]
    # every leaf's gap is read; the limits hold those they name
    assert "grad_gap[layers/mamba/A_log]" in by_side["program"]
    assert not by_side["control_fp8"]["correct"], by_side["control_fp8"]
    assert not by_side["fault_half_batch"]["correct"]
