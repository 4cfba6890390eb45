"""A smoke run of every cell on the card, as the benchmark command runs it: one
short run each, whose last line is a correct result (skips without a
card)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.run import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.card
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
