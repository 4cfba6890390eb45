"""The Zamba2 training cell's own files: they load and agree with
BENCHMARK.json; the reference imports nothing of the program nor JAX;
the configuration file's further keys are held against the program's;
the operation counts equal hand counts at a small shape; the readers of
the program's ``zamba.shared`` and ``zamba.attn`` ranges give their
defined values and nothing where the trace lacks the range; and the
controls at a size a test run holds, judged as a run judges, fail where
the program passes (``perfbench/tools/control_zamba2.py`` takes the same
readings at full size on the card)."""

import ast
import json
import os
import types

import pytest

from perfbench.common import TraceSummary
from perfbench.run import HERE, ROOT, load_metric, metric_names
from perfbench.tests.small import small_config, small_mix

CELL = "zamba2-2.7b.train-4k"
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CONFIG = json.load(open(os.path.join(HERE, "configs", "zamba2-2.7b.json")))
MIX = json.load(open(os.path.join(HERE, "traffic", "train-rows-4k.json")))


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_cells_files_load_and_agree():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "zamba2-2.7b", "train-rows-4k", 1)
    assert MIX["driver"] == "train_zamba2" and MIX["batch"] * MIX["seq_len"] \
        == 32768
    conf = next(c for c in BENCH["configs"] if c["name"] == "zamba2-2.7b")
    assert conf["reduced"] == CONFIG["reduced"] == []
    assert conf["source"] == CONFIG["source"]
    limits = json.load(open(os.path.join(HERE, "limits", CELL + ".json")))
    assert limits and all(v > 0 for v in limits.values())
    # the Mamba2 layers' metrics read here too; mfu.train's FLOP count
    # takes the ssm family alone, and hybrid_mfu.train stands in for it
    assert set(metric_names(BENCH, cell, True)) == {
        "hybrid_mfu.train", "shared_share.train", "attn_mfu.train",
        "ssd_share.train", "mixer_mfu.train", "recompute_share.train",
        "optim_share.train", "idle_share.train"}
    assert set(metric_names(BENCH, cell, False)) == {"train_tok_s", "setup_s"}


def test_reference_and_driver_import_neither_the_program_nor_jax():
    for rel in ("reference/zamba2_ref.py", "drivers/train_zamba2.py",
                "flops_zamba2.py", "tools/control_zamba2.py"):
        names = set(_imports(os.path.join(HERE, rel)))
        assert not names & {"jax", "jaxlib", "flax", "repro"}, rel
        if rel.startswith("reference"):
            assert "repro_torch" not in names, rel


def test_the_program_config_is_held_to_the_further_keys():
    from perfbench.drivers.train_zamba2 import EXTRA_KEYS, check_extra_keys
    check_extra_keys(CONFIG)
    for key, bad in (("norm_eps", 1e-6), ("adapter_rank", 64),
                     ("hybrid_layer_ids", [6, 12])):
        assert key in EXTRA_KEYS
        with pytest.raises(SystemExit, match=key):
            check_extra_keys(dict(CONFIG, **{key: bad}))


SMALL = {"family": "zamba2", "d_model": 4, "ssm_expand": 2, "ssm_state": 2,
         "ssm_head_dim": 2, "conv_kernel": 2, "ssm_chunk": 4, "vocab": 10,
         "n_layers": 2, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "d_ff": 6, "adapter_rank": 3, "hybrid_layer_ids": [1]}


def test_counts_by_hand():
    from perfbench import flops, flops_zamba2 as fz
    # at seq 4: attention core 2*2*4*(4+1)=80 a token; q 2*8*8=128,
    # k and v 2*8*4=64 each, o 2*8*4=64, gate/up 2*4*12=96, down
    # 2*6*4=48, adapter 2*4*3 + 2*3*12=96, linear 2*4*4=32
    assert fz.attn_flops_per_token(SMALL, 4) == 80
    assert fz.shared_flops_per_token(SMALL, 4) == (
        128 + 64 + 64 + 64 + 96 + 48 + 96 + 32 + 80)
    mixer = flops.mixer_flops_per_token(SMALL, 4)
    per_token = 2 * mixer + 672 + 2 * 4 * 10
    assert fz.train_step_flops(SMALL, 3, 4) == 3 * 3 * 4 * per_token
    with pytest.raises(ValueError):
        fz.train_step_flops(dict(SMALL, family="ssm"), 1, 4)
    # the cell's step, as PERF.md states it
    assert round(fz.train_step_flops(CONFIG, 8, 4096) / 1e12, 1) == 808.9


def _ctx(spans):
    t = TraceSummary(window_s=15.0, busy_s=14.9, device_ops=[], idle_gaps=[],
                     span_device_s=dict(spans),
                     span_count={k: 27 for k in spans}, kernel_s=14.0)
    tokens = MIX["batch"] * MIX["seq_len"]
    return types.SimpleNamespace(
        traced=t, config=CONFIG, mix=MIX,
        records={"seq_len": MIX["seq_len"], "tokens_per_step": tokens,
                 "batch": MIX["batch"], "steps_done": 7.5, "window_s": 51.0})


def test_readers_of_the_cells_metrics():
    from perfbench.flops_zamba2 import (PEAKS, attn_flops_per_token,
                                        train_step_flops)
    spans = {"zamba.shared": 4.0, "zamba.attn": 1.0}
    ctx = _ctx(spans)
    share = load_metric("shared_share.train")
    assert share.read(ctx) == pytest.approx(100 * 4.0 / 14.0, rel=1e-12)
    attn = load_metric("attn_mfu.train")
    fl = 3 * attn_flops_per_token(CONFIG, 4096) * 9 * 32768 * MIX["trace_steps"]
    assert attn.read(ctx) == pytest.approx(
        100 * fl / 1.0 / PEAKS["bf16_flops"], rel=1e-12)
    mfu = load_metric("hybrid_mfu.train")
    assert mfu.read(ctx) == pytest.approx(
        100 * train_step_flops(CONFIG, 8, 4096) * 7.5 / 51.0
        / PEAKS["bf16_flops"], rel=1e-12)
    # a program without the ranges (the parent) gives no reading, not 0
    for r in (share, attn):
        assert r.read(_ctx({"mamba.ssd": 3.0})) is None
        assert r.SPAN in spans and not hasattr(r, "WRAP")
    assert mfu.read(types.SimpleNamespace(records={})) is None


def test_controls_fail_where_the_program_passes():
    from perfbench.tools.control_zamba2 import CONTROLS, readings
    got = []
    readings(CELL, [2**31 + 3], {2**31 + 3}, device="cpu",
             config_override=small_config, mix_override=small_mix,
             emit=got.append)
    by_side = {r["side"]: r for r in got}
    assert set(by_side) == {"program", "fault_half_batch",
                            *("control_" + k for k in CONTROLS)}
    assert by_side["program"]["correct"], by_side["program"]
    for side, r in by_side.items():
        if side != "program":
            assert not r["correct"], r
