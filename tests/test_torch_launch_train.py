"""The port's training launcher (``repro_torch.launch.train.run``) on the
CPU: the loss falls, and a run killed after its checkpoint and resumed
from ``ckpt_dir`` ends with the uninterrupted run's parameters."""

import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, list_steps
from repro_torch.launch import train
from repro_torch.utils import tree_leaves
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)

KW = dict(steps=12, batch=4, seq=32, lr=1e-3, ckpt_every=6, log_every=6,
          seed=3, device="cpu")


def _leaves(params):
    return [t.detach().clone() for t in tree_leaves(params)]


class _Crash(Exception):
    pass


def _crashing_pipeline(after):
    """``DataPipeline`` whose run dies when asked for batch ``after``."""
    class Pipe(train.DataPipeline):
        def __next__(self):
            if self._next_step >= after:
                raise _Crash(after)
            self._next_step += 1
            return super().__next__()

        def __init__(self, *a, start_step=0, **kw):
            super().__init__(*a, start_step=start_step, **kw)
            self._next_step = start_step
    return Pipe


def test_launcher_loss_falls_and_resume_equals_uninterrupted(capsys,
                                                             monkeypatch):
    with tempfile.TemporaryDirectory() as d:
        want, want_losses = train.run("qwen2-0.5b-smoke", **KW)
        want = _leaves(want)
        assert np.mean(want_losses[-5:]) < np.mean(want_losses[:5])
        assert all(np.isfinite(want_losses))
        # the first run crashes in step 9, after its step-6 checkpoint
        root = os.path.join(d, "ck")
        with monkeypatch.context() as m:
            m.setattr(train, "DataPipeline", _crashing_pipeline(8))
            with pytest.raises(_Crash):
                train.run("qwen2-0.5b-smoke", **dict(KW, ckpt_dir=root))
        assert latest_step(root) == 6
        got, got_losses = train.run("qwen2-0.5b-smoke",
                                    **dict(KW, ckpt_dir=root))
        out = capsys.readouterr().out
        assert "[train] resumed from step 6" in out
        assert list_steps(root) == [6, 12]
        assert got_losses == want_losses[6:]
        for a, b in zip(want, _leaves(got)):
            assert torch.equal(a, b)


def test_launcher_cli_runs_on_cpu(capsys):
    train.main(["--arch", "qwen2-0.5b-smoke", "--steps", "2", "--batch",
                "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] qwen2-0.5b-smoke:" in out and "[train] done:" in out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.run("qwen2-0.5b-smoke", steps=1)
