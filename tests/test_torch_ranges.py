"""Profiler ranges inside the port's Mamba2 training step
(``repro_torch.core.obs.device_range``): ``mamba.mixer`` around
``mamba_sequence``, ``mamba.conv`` around its causal conv, ``mamba.ssd``
around the chunked SSD's local body and ``remat.recompute`` around
remat's re-run of a layer, each over every phase it runs in.

On the ``mamba2-780m`` smoke configuration, batch 2 x 64 tokens, one
step of ``make_train_step`` under ``torch.profiler`` for each remat
policy: the ranges' counts (forward and backward, plus the recompute
under a checkpointing policy), their durations, one layer's backward
range closed before the next one's opens, and backward work inside the
SSD's range on the thread that ran it.  Loss and every gradient are
the same bits with the profiler on and off; with no profiler a step
opens no range, registers no hook and adds no autograd node.  On a toy
checkpointed function with a leaf parameter under ``autograd.grad``
(which refuses a multi-grad hook a leaf's node) the ranges are those of
every phase and the gradients the same bits; a backward pass that needs
none of a call's inputs leaves no range open.
"""

import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

import repro_torch.core.obs.ranges as R
from repro_torch.configs import get_config
from repro_torch.core.obs import device_range
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_opt
from repro_torch.train import TrainStepConfig, make_loss_fn, make_train_step
from repro_torch.utils import tree_leaves

CFG = get_config("mamba2-780m-smoke")
L = CFG.n_layers
B, S = 2, 64
POLICIES = ["none", "full", "dots"]


def _batch():
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, CFG.vocab, (B, S + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _model():
    return build_model(CFG, "cpu", generator=torch.Generator().manual_seed(0))


def _trace(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _ranges(events):
    return [e for e in events if e.get("cat") == "user_annotation"]


@pytest.mark.parametrize("remat", POLICIES)
def test_ranges_cover_forward_recompute_and_backward(remat, tmp_path,
                                                      monkeypatch):
    model = _model()
    params = model.params()
    step = make_train_step(model, AdamWConfig(),
                           TrainStepConfig(remat=remat, warmup_steps=1))
    hooked = []
    close = R._CloseOnInputs.apply
    monkeypatch.setattr(R._CloseOnInputs, "apply",
                        lambda *a: hooked.append(1) or close(*a))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, init_opt(params), _batch())
    # hooks in the forward alone (the mixer's, the conv's, the SSD's),
    # never in a recompute
    assert len(hooked) == 3 * L
    events = _trace(prof, tmp_path)
    ranges = _ranges(events)
    count = Counter(e["name"] for e in ranges)
    phases = 2 if remat == "none" else 3
    assert count["mamba.mixer"] == phases * L
    assert count["mamba.ssd"] == phases * L
    assert count["mamba.conv"] == phases * L
    assert count["remat.recompute"] == (0 if remat == "none" else L)
    assert all(e["dur"] > 0 for e in ranges)
    # a layer's backward range closes before the next layer's opens: the
    # mixer ranges that no other holds are its forwards and backwards,
    # one after another
    mixer = sorted(((e["ts"], e["ts"] + e["dur"]) for e in ranges
                    if e["name"] == "mamba.mixer"), key=lambda r: (r[0], -r[1]))
    outer = [r for r in mixer
             if not any(o != r and o[0] <= r[0] and r[1] <= o[1]
                        for o in mixer)]
    assert len(outer) == 2 * L
    assert all(a[1] <= b[0] for a, b in zip(outer, outer[1:]))
    # backward work inside an SSD range, on the range's own thread
    ssd = [e for e in ranges if e["name"] == "mamba.ssd"]
    backward = [e for e in events if e.get("cat") == "cpu_op"
                and e["name"].startswith("autograd::engine::evaluate_function")]
    assert any(r["tid"] == op["tid"] and r["ts"] <= op["ts"]
               and op["ts"] + op["dur"] <= r["ts"] + r["dur"]
               for r in ssd for op in backward)


def _loss_and_grads(remat):
    model = _model()
    params = model.params()
    leaves = tree_leaves(params)
    loss, _ = make_loss_fn(model, remat)(params, _batch())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


@pytest.mark.parametrize("remat", POLICIES)
def test_loss_and_gradients_are_the_same_bits_with_the_profiler(remat):
    loss, grads = _loss_and_grads(remat)
    with profile(activities=[ProfilerActivity.CPU]):
        loss_p, grads_p = _loss_and_grads(remat)
    assert torch.equal(loss, loss_p)
    assert len(grads) == len(grads_p)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_p))


@pytest.mark.parametrize("remat", POLICIES)
def test_no_profiler_opens_no_range_and_registers_no_hook(remat,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler recording")
    model = _model()
    params = model.params()
    step = make_train_step(model, AdamWConfig(),
                           TrainStepConfig(remat=remat, warmup_steps=1))
    monkeypatch.setattr(R, "_enter", refuse)
    monkeypatch.setattr(torch.Tensor, "register_hook", refuse)
    monkeypatch.setattr(R._CloseOnInputs, "apply", refuse)
    _, _, metrics = step(params, init_opt(params), _batch())
    assert torch.isfinite(metrics["loss"])


@device_range("toy.layer")
def _toy(w, x):
    return torch.tanh(x @ w) * 2.0


def _toy_grads(checkpointed):
    g = torch.Generator().manual_seed(3)
    w = torch.randn(8, 8, generator=g, requires_grad=True)   # a leaf
    x0 = torch.randn(4, 8, generator=g, requires_grad=True)
    x = x0 * 1.5                                             # not a leaf
    y = (checkpoint(_toy, w, x, use_reentrant=False) if checkpointed
         else _toy(w, x))
    return torch.autograd.grad(y.square().sum(), [w, x0])


@pytest.mark.parametrize("checkpointed", [False, True])
def test_toy_function_with_a_leaf_parameter(checkpointed, tmp_path):
    plain = _toy_grads(checkpointed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ranged = _toy_grads(checkpointed)
    assert all(torch.equal(a, b) for a, b in zip(plain, ranged))
    ranges = [e for e in _ranges(_trace(prof, tmp_path))
              if e["name"] == "toy.layer"]
    # forward, backward, and the recompute when checkpointed
    assert len(ranges) == (3 if checkpointed else 2)
    assert all(e["dur"] > 0 for e in ranges)


W_OUTSIDE = torch.randn(8, 8, generator=torch.Generator().manual_seed(5),
                        requires_grad=True)


@device_range("toy.outside")
def _toy_outside(x):
    return torch.tanh(x @ W_OUTSIDE)


def test_toy_backward_range_opens_only_where_it_can_close(tmp_path):
    """A call of leaves alone gets its backward range; where a backward
    pass reaches the call's output but needs no gradient of its inputs
    (here, only that of a weight the function reads from outside its
    arguments), no backward range opens, so none is left open."""
    g = torch.Generator().manual_seed(4)
    w = torch.randn(8, 8, generator=g, requires_grad=True)
    x0 = torch.randn(4, 8, generator=g, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(_toy(w, x0).sum(), [w, x0])
        torch.autograd.grad(_toy_outside(x0 * 1.5).sum(), [W_OUTSIDE])
    count = Counter(e["name"] for e in _ranges(_trace(prof, tmp_path)))
    assert count["toy.layer"] == 2               # forward and backward
    assert count["toy.outside"] == 1             # forward alone


def _plain_layer(w, x):
    return torch.tanh(x @ w)


@pytest.mark.parametrize("checkpointed", [False, True])
def test_inside_backward_ranges_the_recompute_alone(checkpointed, tmp_path):
    body = device_range("toy.recompute").inside_backward(_plain_layer)
    g = torch.Generator().manual_seed(6)
    w = torch.randn(8, 8, generator=g, requires_grad=True)
    x = torch.randn(4, 8, generator=g, requires_grad=True) * 1.5
    body(w, x)                                  # no profiler: nothing
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = (checkpoint(body, w, x, use_reentrant=False) if checkpointed
             else body(w, x))
        torch.autograd.grad(y.sum(), [w])
    ranges = [e for e in _ranges(_trace(prof, tmp_path))
              if e["name"] == "toy.recompute"]
    assert len(ranges) == (1 if checkpointed else 0)
    assert all(e["dur"] > 0 for e in ranges)
