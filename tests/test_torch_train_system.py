"""End-to-end behaviour of the port's training path, mirrors of
``tests/test_system.py``: train -> checkpoint -> crash -> restart ->
serve, on qwen2-0.5b reduced on the CPU.

A run interrupted at step k and restarted from its checkpoint must give
the same parameters as the uninterrupted run (deterministic data and an
exact restore: on the CPU bit for bit), and the trained model must serve
through the batched engine."""

import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, init_opt
from repro_torch.serve import ServeEngine, generate
from repro_torch.train import TrainStepConfig, make_train_step
from repro_torch.utils import tree_leaves
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("qwen2-0.5b").reduced()
    src = SyntheticLM(vocab=cfg.vocab, seed=9)
    return cfg, src


def _model(cfg, seed, remat="none", microbatches=1):
    model = build_model(cfg, "cpu", torch.Generator().manual_seed(seed))
    step_fn = make_train_step(
        model, AdamWConfig(lr=1e-3),
        TrainStepConfig(microbatches=microbatches, remat=remat,
                        total_steps=100))
    return model, step_fn


def _batch(src, step):
    b = src.batch(step=step, shard=0, n_shards=1, batch=8, seq=32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_decreases(setup):
    cfg, src = setup
    model, step_fn = _model(cfg, 0)
    params = model.params()
    opt = init_opt(params)
    losses = []
    for i in range(40):
        params, opt, m = step_fn(params, opt, _batch(src, i))
        losses.append(float(m["loss"]))
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.05, f"{first} -> {last}"


def test_crash_restart_exact_resume(setup):
    cfg, src = setup
    with tempfile.TemporaryDirectory() as d:
        # continuous run: 10 steps
        ref, step_fn = _model(cfg, 1)
        p_ref, o_ref = ref.params(), init_opt(ref.params())
        for i in range(10):
            p_ref, o_ref, _ = step_fn(p_ref, o_ref, _batch(src, i))

        # interrupted run: 6 steps, checkpoint, "crash", restore, 4 more
        model, step_fn = _model(cfg, 1)
        p, o = model.params(), init_opt(model.params())
        for i in range(6):
            p, o, _ = step_fn(p, o, _batch(src, i))
        save(d, 6, {"params": p, "opt": o}, extra={"data_step": 6})
        del model, p, o, step_fn

        step = latest_step(d)
        assert step == 6
        model, step_fn = _model(cfg, 123)           # other weights
        params = model.params()
        state, extra = restore(d, step, {"params": params,
                                         "opt": init_opt(params)})
        with torch.no_grad():
            for a, b in zip(tree_leaves(params),
                            tree_leaves(state["params"])):
                a.copy_(b)
        p, o = params, state["opt"]
        assert int(o.step) == 6
        for i in range(extra["data_step"], 10):
            p, o, _ = step_fn(p, o, _batch(src, i))

        for a, b in zip(tree_leaves((p_ref, o_ref)), tree_leaves((p, o))):
            assert torch.equal(a, b)


def test_microbatch_equivalence(setup):
    """2-way grad accumulation must match the single-batch step closely."""
    cfg, src = setup
    batch = _batch(src, 0)
    outs = []
    for n in (1, 2):
        model, step_fn = _model(cfg, 2, microbatches=n)
        p, _, m = step_fn(model.params(), init_opt(model.params()), batch)
        outs.append((float(m["loss"]), [t.detach().float() for t in tree_leaves(p)]))
    (l1, p1), (l2, p2) = outs
    assert l1 == pytest.approx(l2, rel=1e-3)
    assert max(float((a - b).abs().max()) for a, b in zip(p1, p2)) < 5e-3


def test_remat_does_not_change_loss(setup):
    cfg, src = setup
    batch = _batch(src, 0)
    outs = []
    for remat in ("none", "full", "dots"):
        model, step_fn = _model(cfg, 3, remat=remat)
        _, _, m = step_fn(model.params(), init_opt(model.params()), batch)
        outs.append(float(m["loss"]))
    assert max(outs) - min(outs) < 1e-4


def test_serve_after_training(setup):
    cfg, src = setup
    model, step_fn = _model(cfg, 4)
    params, opt = model.params(), init_opt(model.params())
    for i in range(5):
        params, opt, _ = step_fn(params, opt, _batch(src, i))
    eng = ServeEngine(model, slots=4, prompt_len=16, max_new=8)
    prompt = _batch(src, 99)["tokens"][0, :12].numpy()
    for rid in range(5):
        eng.submit(rid, prompt)
    out = eng.run()
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert all(len(v) == 8 for v in out.values())
    # greedy generate must equal manual prefill+decode chain
    tokens = torch.from_numpy(prompt)[None, :]
    toks = generate(model, {"tokens": tokens}, max_new=4)
    logits, _ = model.prefill({"tokens": tokens}, max_len=20)
    assert int(toks[0, 0]) == int(torch.argmax(logits, -1)[0])


def test_unstack_layers_gradient_equals_indexing():
    """The models take each layer's parameters by ``unstack_layers`` (one
    ``unbind`` a leaf): the same views, and the same gradients, as
    indexing each layer of the stacked leaves; nested for the hybrid's
    (sites, every) stack."""
    from repro_torch.models.blocks import layer_params, unstack_layers
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(2, 3, 4, 5, generator=g, requires_grad=True),
            "b": {"c": torch.randn(2, 3, 5, generator=g,
                                   requires_grad=True)}}
    leaves = [tree["a"], tree["b"]["c"]]

    def loss(get):
        out = 0
        for s in range(2):
            for e in range(3):
                lp = get(s, e)
                out = out + ((lp["a"] @ lp["b"]["c"]) ** 2).sum() * (e + 1)
        return out
    sites = [unstack_layers(site) for site in unstack_layers(tree)]
    for s in range(2):
        for e in range(3):
            assert torch.equal(sites[s][e]["a"], tree["a"][s, e])
    got = torch.autograd.grad(loss(lambda s, e: sites[s][e]), leaves)
    want = torch.autograd.grad(
        loss(lambda s, e: layer_params(tree, s, e)), leaves)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
