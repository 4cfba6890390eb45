"""The reference against the program at the reduced configuration on the
CPU (float32 on both sides), and a run with the timed path broken
underneath comes out not correct: the checks see a step that leaves its
state unchanged and half a batch left out."""

import json
import os

import pytest
import torch

import repro_torch.models.ssm_lm as ssm_lm
import repro_torch.train.step as step_mod
from perfbench.run import ROOT, run_cell
from perfbench.tests.small import small_config, small_mix

SEED = 2**31 + 77
TRAIN = [c["name"] for c in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


def _run(cell, seconds=1.0):
    return run_cell(cell, SEED, seconds, False, device="cpu",
                    config_override=small_config, mix_override=small_mix)


@pytest.mark.parametrize("cell", TRAIN)
def test_train_reference_agrees_with_the_program(cell):
    ctx, metrics = _run(cell)
    assert ctx.correct() and ctx.attempted > 0
    assert all(v < 1e-5 for v, _ in ctx.checks.values()), ctx.checks
    assert metrics["train_tok_s"]["value"] > 0
    assert set(metrics) == {"train_tok_s", "setup_s"}


@pytest.mark.parametrize("cell", TRAIN)
def test_fault_state_unchanged_fails_training(monkeypatch, cell):
    def unchanged(cfg, params, grads, state, lr_scale=1.0, decay_mask=None):
        return params, state, {"grad_norm": torch.zeros(())}
    monkeypatch.setattr(step_mod, "apply_updates", unchanged)
    ctx, _ = _run(cell)
    assert not ctx.correct(), ctx.checks


@pytest.mark.parametrize("cell", TRAIN)
def test_fault_half_batch_fails_training(monkeypatch, cell):
    loss = ssm_lm.MambaLM.loss

    def half(self, batch):
        n = batch["tokens"].shape[0] // 2
        return loss(self, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(ssm_lm.MambaLM, "loss", half)
    ctx, _ = _run(cell)
    assert not ctx.correct(), ctx.checks
