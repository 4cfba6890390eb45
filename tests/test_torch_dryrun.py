"""The port's dry run (``launch/dryrun.py``) on reduced configs of each
family x train, prefill and decode, traced on a fake (data 2, model 2)
mesh on the CPU: every cell is ``ok`` (or ``skip`` with the reference's
reason), records have the reference's keys and file names, the rule
tables split a dense model's matmul work four ways, and the roofline
report renders the records."""

import io
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_mesh, release_mesh
from repro_torch.models import build_model, make_synthetic_batch
from repro_torch.optim import AdamWConfig, init_opt
from repro_torch.train import TrainStepConfig, make_train_step

FAMILIES = {"dense": "qwen2-0.5b", "moe": "phi3.5-moe-42b-a6.6b",
            "ssm": "mamba2-780m", "hybrid": "zamba2-2.7b",
            "encdec": "whisper-large-v3"}
# the named shapes at reduced sizes (sequence and batch cut, kinds kept)
SHAPES = {"train": ShapeSpec("train_4k", 64, 8, "train"),
          "prefill": ShapeSpec("prefill_32k", 64, 4, "prefill"),
          "decode": ShapeSpec("decode_32k", 64, 4, "decode")}

# the keys of the reference's records (src/repro/launch/dryrun.py)
BASE_KEYS = {"arch", "shape", "mesh", "kind", "microbatches", "remat",
             "accum_dtype", "q8_moments", "seq_parallel", "params",
             "active_params", "status"}
OK_KEYS = BASE_KEYS | {"devices", "lower_s", "compile_s", "memory", "cost",
                       "collectives", "roofline"}
PLAN_KEYS = {"planned_bytes", "plan_breakdown"}


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh((2, 2), ("data", "model"), device="cpu")
    yield m
    release_mesh()


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dryrun_torch"))


def _cell(mesh, out_dir, family, kind, **kw):
    arch = FAMILIES[family]
    return dryrun.run_cell(arch, SHAPES[kind].name, "pod",
                           cfg=get_config(arch).reduced(),
                           shape=SHAPES[kind], mesh=mesh, device="cpu",
                           out_dir=out_dir, verbose=False, **kw)


@pytest.mark.parametrize("kind", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_cell_traces(mesh, out_dir, family, kind):
    rec = _cell(mesh, out_dir, family, kind)
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == OK_KEYS
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert set(rec["cost"]) == {"flops_per_device", "bytes_per_device",
                                "xla_cost_flops_raw", "xla_cost_bytes_raw"}
    assert set(rec["collectives"]) == {"modeled_bytes_per_device",
                                       "raw_result_bytes", "per_op",
                                       "per_op_count"}
    assert set(rec["roofline"]) == {"t_compute_s", "t_memory_s",
                                    "t_collective_s", "bound", "t_bound_s"}
    assert rec["devices"] == 4 and rec["kind"] == kind
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0
    # the tensor-parallel rules put collectives on every path
    assert rec["collectives"]["modeled_bytes_per_device"] > 0
    assert set(rec["collectives"]["per_op"]) <= {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all"}
    fn = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__pod.json")
    with open(fn) as f:
        assert json.load(f) == json.loads(json.dumps(rec))


def test_inapplicable_cell_skips_with_the_reference_reason(mesh, out_dir):
    long = ShapeSpec("long_500k", 64, 1, "decode")
    rec = dryrun.run_cell("qwen2-0.5b", "long_500k", "pod",
                          cfg=get_config("qwen2-0.5b").reduced(),
                          shape=long, mesh=mesh, device="cpu",
                          out_dir=out_dir, verbose=False)
    ok, why = j_get_shape("long_500k").applicable(j_get_config("qwen2-0.5b"))
    assert not ok
    assert rec["status"] == "skip" and rec["skip_reason"] == why
    assert set(rec) == BASE_KEYS | {"skip_reason"}


def test_auto_records_the_plan(mesh, out_dir):
    rec = _cell(mesh, out_dir, "dense", "train", auto=True,
                extra_tag="auto")
    assert rec["status"] == "ok"
    assert set(rec) == OK_KEYS | PLAN_KEYS
    assert os.path.exists(os.path.join(
        out_dir, "qwen2-0.5b__train_4k__pod__auto.json"))


@pytest.mark.parametrize("flags", [
    dict(q8_moments=True), dict(seq_parallel=True),
    dict(microbatches=2, accum_dtype="bfloat16")],
    ids=["q8", "seq_parallel", "mb2_bf16"])
def test_flags_trace(mesh, out_dir, flags):
    """The dry run's knobs: 8-bit moments (their specs from
    ``_q8_opt_shardings``), sequence-parallel residuals, microbatches
    with bf16 accumulation."""
    rec = _cell(mesh, out_dir, "dense", "train", extra_tag="-".join(flags),
                **flags)
    assert rec["status"] == "ok", rec.get("traceback")
    for key, value in flags.items():
        assert rec[key] == value
    if flags.get("q8_moments"):
        plain = _cell(mesh, out_dir, "dense", "train", extra_tag="f32")
        # int8 moments: the state's bytes drop (the parameters stay)
        assert rec["memory"]["argument_bytes"] < \
            plain["memory"]["argument_bytes"]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_rules_split_the_matmul_work(mesh, out_dir, remat):
    """Per-device matmul FLOPs x 4 ranks against ``FlopCounterMode`` on
    the unsharded step (reduced qwen2: 4 heads, 2 KV heads, vocab 256,
    d_ff 128, all divisible by 2)."""
    rec = _cell(mesh, out_dir, "dense", "train", remat=remat,
                extra_tag=remat)
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, "cpu")
    step = make_train_step(model, AdamWConfig(), TrainStepConfig(remat=remat))
    shape = SHAPES["train"]
    batch = make_synthetic_batch(cfg, shape.global_batch, shape.seq_len,
                                 device="cpu")
    with FlopCounterMode(display=False) as fc:
        step(model.params(), init_opt(model.params()), batch)
    ratio = rec["cost"]["flops_per_device"] * 4 / fc.get_total_flops()
    assert 1.0 <= ratio <= 1.05, ratio


def test_roofline_renders_the_records(out_dir):
    rows = roofline.load(out_dir)
    assert len(rows) >= len(FAMILIES) * len(SHAPES)
    buf = io.StringIO()
    roofline.render(rows, buf)
    text = buf.getvalue()
    for arch in FAMILIES.values():
        assert f"| {arch} |" in text
    assert "SKIP" in text and "NVIDIA H100 SXM" in text
    assert "Bottleneck remedies" in text


def test_cli_skip_path(tmp_path):
    """The CLI over a cell that needs no trace (a full-attention arch at
    500k tokens) writes its skip record and exits 0."""
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                      "--mesh", "both", "--out", str(tmp_path),
                      "--device", "cpu"])
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == [
        "qwen2-0.5b__long_500k__multipod.json",
        "qwen2-0.5b__long_500k__pod.json"]


def test_no_cuda_no_trace():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run_cell("qwen2-0.5b", "train_4k", "pod")
