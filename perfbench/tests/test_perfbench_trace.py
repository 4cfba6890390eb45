"""The reading of a profiler trace (busy time as the union of device
operations, idle gaps by the host operation under them, the device time
of the kernels launched inside every named range), and the ranges that
metric readers ask for: a reader declares its ``SPAN`` and the call it
``WRAP``s, and the run wraps that call while it traces, then puts the
program's own function back."""

import json
import types

import torch

import repro_torch.train.step as step_mod
from perfbench.common import reader_wraps, spans_around, summarize_trace
from perfbench.run import load_metric


def test_summarize_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "perfbench.mixer",
         "ts": 0, "dur": 50, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "model.layer",
         "ts": 55, "dur": 40, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "model.layer",
         "ts": 4, "dur": 3, "tid": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 10,
         "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 6, "dur": 2, "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 60,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 61, "dur": 2, "tid": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 10, "dur": 40,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 70, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80, "dur": 20},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    t = summarize_trace(str(path))
    assert abs(t.window_s - 100e-6) < 1e-12
    assert abs(t.busy_s - 70e-6) < 1e-12        # 10-50 and 70-100
    assert abs(t.kernel_s - 80e-6) < 1e-12
    assert abs(t.span_device_s["perfbench.mixer"] - 40e-6) < 1e-12
    # the range on thread 2 covers the launch at 6 in time, not in thread
    assert abs(t.span_device_s["model.layer"] - 20e-6) < 1e-12
    assert t.span_count == {"perfbench.mixer": 1, "model.layer": 2}
    assert t.device_ops[0][0] == "gemm"
    [(name, gap)] = t.idle_gaps                  # 50-70: the add at 60
    assert name == "aten::add" and abs(gap - 20e-6) < 1e-12


def test_a_reader_file_names_its_span_and_call():
    optim = load_metric("optim_share.train")
    new = types.SimpleNamespace(
        SPAN="perfbench.step",
        WRAP=("repro_torch.train.step:make_train_step",
              "repro_torch.models.ssm_lm:MambaLM.loss"))
    wraps = reader_wraps([optim, new, load_metric("mfu.train")])
    assert wraps == {optim.WRAP: optim.SPAN,
                     "repro_torch.train.step:make_train_step": "perfbench.step",
                     "repro_torch.models.ssm_lm:MambaLM.loss": "perfbench.step"}


def test_spans_wrap_while_tracing_and_put_back(monkeypatch):
    import repro_torch.models.ssm_lm as ssm_lm
    own_update, own_loss = step_mod.apply_updates, ssm_lm.MambaLM.loss
    seen = []

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            seen.append(self.name)

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    wraps = {"repro_torch.train.step:apply_updates": "perfbench.optim",
             "repro_torch.models.ssm_lm:MambaLM.loss": "perfbench.loss"}
    with spans_around(wraps):
        assert step_mod.apply_updates is not own_update
        assert step_mod.apply_updates.__wrapped__ is own_update
        assert ssm_lm.MambaLM.loss is not own_loss
        try:
            step_mod.apply_updates(None, None, None, None)
        except Exception:
            pass
    assert seen == ["perfbench.optim"]
    assert step_mod.apply_updates is own_update
    assert ssm_lm.MambaLM.loss is own_loss
