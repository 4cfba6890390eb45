"""Zamba2 in its published form (``zamba2-2.7b-published``,
``repro_torch.models.zamba2.Zamba2LM``) against the benchmark's plain
float32 reference (``perfbench/reference/zamba2_ref.py``, written from
the published equations and importing nothing of the port).

On the CPU, float32, at a small size with 3 hybrid sites over 8 layers
(so that one of the two shared blocks serves two sites, each with its
own adapter and linear) and rows of 64 tokens: the loss and every
leaf's gradient, with remat off and full; prefill followed by decoding
against the reference's full-forward logits; the parameter count; the
launcher training the ``-smoke`` form; the registry keeping the JAX
package's ten archs; the profiler ranges ``zamba.shared`` and
``zamba.attn`` in every phase.  ``attention_core``'s default scale keeps
its bits, and the CPU never takes the fused path.

On the card (marked ``card``, skipped without one): the fused attention
path against the float32 einsum at small bf16 shapes at both scales,
forward and gradients, with its counters; and a bf16 training step of
the ``-smoke`` form, whose attention takes the fused path and whose SSD
takes the kernels, forward and backward, and no plain body.  Run them
on a card with ``python -m pytest tests/test_torch_zamba2_published.py
-m card``.
"""

import dataclasses
import json
import math
from collections import Counter

import pytest
import torch

from perfbench.reference import zamba2_ref as Z
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.zamba2_published import Zamba2Config
from repro_torch.kernels.route import route_counts
from repro_torch.launch import train as launcher
from repro_torch.models import Zamba2LM, build_model
from repro_torch.models import blocks
from repro_torch.train import make_loss_fn
from repro_torch.utils import leaves_with_paths, tree_leaves
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)

ARCH = "zamba2-2.7b-published"
SMALL = dataclasses.replace(get_config(ARCH + "-smoke"), n_layers=8,
                            hybrid_layer_ids=(1, 4, 6), adapter_rank=8)
B, S = 2, 64
TOL = 1e-5
# layers/mamba/A_log's gradient sums terms that cancel over the batch,
# positions and heads, so float32 round-off on either side leaves up to
# a few 1e-5 of its max|.| (tests/test_torch_train_step.py's
# DECAY_GRAD_TOL, for the same leaf of every SSM arch)
LEAF_TOL = {"layers/mamba/A_log": 5e-5}


def _model(cfg=SMALL, device="cpu"):
    return build_model(cfg, device,
                       generator=torch.Generator(device).manual_seed(0))


def _batch(cfg=SMALL, rows=B, seq=S, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab, (rows, seq + 1), generator=g)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _ref(model):
    """The reference's architecture and float32 weights (leaves that
    require grad) from the program's own."""
    arch = Z.Arch.from_json(dataclasses.asdict(model.cfg))
    W = {p: t.detach().clone().float().requires_grad_(True)
         for p, t in leaves_with_paths(model.params())}
    return arch, W


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


# ----------------------------------------------------------------------
# the configuration
# ----------------------------------------------------------------------

def test_registry_keeps_the_ten_and_resolves_the_published_form():
    assert len(list_archs()) == 10 and ARCH not in list_archs()
    cfg = get_config(ARCH)
    assert isinstance(cfg, Zamba2Config) and cfg.family == "zamba2"
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.hd(), cfg.d_ff,
            cfg.adapter_rank, cfg.num_mem_blocks, cfg.norm_eps) == (
        2560, 54, 32, 160, 10240, 128, 2, 1e-5)
    assert cfg.n_heads * cfg.hd() == 2 * cfg.d_model
    smoke = get_config(ARCH + "-smoke")
    assert smoke.name == ARCH + "-smoke" and smoke.d_model == 64
    assert smoke.hybrid_layer_ids == cfg.hybrid_layer_ids
    assert smoke.n_heads == smoke.n_kv_heads
    assert isinstance(build_model(smoke, "meta"), Zamba2LM)


@pytest.mark.parametrize("cfg", [SMALL, get_config(ARCH + "-smoke"),
                                 get_config(ARCH)],
                         ids=["small", "smoke", "full"])
def test_param_count_is_the_models_leaves(cfg):
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, "meta").params()))
    assert cfg.param_count() == n
    if cfg.name == ARCH:
        assert 2.60e9 <= n <= 2.75e9


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("remat", [None, "full"])
def test_loss_and_every_gradient_match_the_reference(remat):
    model = _model()
    batch = _batch()
    params = model.params()
    paths, leaves = zip(*leaves_with_paths(params))
    loss, _ = make_loss_fn(model, remat)(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    arch, W = _ref(model)
    want = Z.loss_sum(arch, W, batch["tokens"], batch["targets"],
                      Z.Precision("f32"), remat=remat is not None) / (B * S)
    want.backward()
    want = float(want.detach())
    assert abs(float(loss) - want) <= TOL * abs(want)
    # every leaf moves, and within 1e-5 of its reference's max|.|
    for p, g in zip(paths, grads):
        assert W[p].grad.abs().max() > 0, p
        assert _rel(g, W[p].grad) <= LEAF_TOL.get(p, TOL), \
            (p, _rel(g, W[p].grad))


def test_prefill_then_decode_match_the_reference_logits():
    model = _model()
    toks = _batch()["tokens"]
    arch, W = _ref(model)
    with torch.no_grad():
        h = Z.hidden(arch, W, toks, Z.Precision("f32"), remat=False)
        want = h @ W["embed"].t()                           # (B, S, V)
    P = 48
    logits, cache = model.prefill({"tokens": toks[:, :P]}, max_len=S)
    got = [logits]
    for i in range(P, S - 1):
        logits, cache = model.decode_step(toks[:, i:i + 1], cache)
        got.append(logits)
    assert cache["len"] == S - 1
    got = torch.stack(got, dim=1)
    assert _rel(got, want[:, P - 1:S - 1]) <= TOL


def test_the_launcher_trains_the_smoke_form():
    _, losses = launcher.run(ARCH + "-smoke", steps=3, batch=2, seq=64,
                             remat="full", log_every=1, device="cpu")
    assert len(losses) == 3 and all(map(math.isfinite, losses))


# ----------------------------------------------------------------------
# attention_core and the ranges
# ----------------------------------------------------------------------

def test_attention_core_default_scale_and_the_cpu_route():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 16, 4, 8, generator=g) for _ in range(3))
    pos = blocks.make_positions(2, 16)
    before = route_counts()
    base = blocks.attention_core(q, k, v, pos, pos)
    same = blocks.attention_core(q, k, v, pos, pos, scale=1 / math.sqrt(8),
                                 fused_ok=True)
    other = blocks.attention_core(q, k, v, pos, pos, scale=0.5)
    assert torch.equal(base, same) and not torch.equal(base, other)
    # a CPU call is neither a fused call nor a plain call on the card
    assert route_counts() == before


def test_ranges_cover_the_shared_block_and_the_attention_core(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    model = _model()
    batch = _batch()
    params = model.params()
    leaves = tree_leaves(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = make_loss_fn(model, "full")(params, batch)
        torch.autograd.grad(loss, leaves)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = Counter(e["name"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("ph") == "X")
    sites = len(SMALL.hybrid_layer_ids)
    # forward, recompute and backward of every site
    assert names["zamba.shared"] == 3 * sites
    assert names["zamba.attn"] == 3 * sites
    assert names["mamba.mixer"] == 3 * SMALL.n_layers


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("hd,heads,kv", [(160, 4, 4), (64, 8, 2)])
@pytest.mark.parametrize("half_hd_scale", [False, True])
def test_fused_attention_matches_the_einsum_on_the_card(hd, heads, kv,
                                                        half_hd_scale):
    dev = _card()
    g = torch.Generator(dev).manual_seed(3)
    Bc, Sc = 2, 384
    q = torch.randn(Bc, Sc, heads, hd, device=dev, generator=g)
    k = torch.randn(Bc, Sc, kv, hd, device=dev, generator=g)
    v = torch.randn(Bc, Sc, kv, hd, device=dev, generator=g)
    dy = torch.randn(Bc, Sc, heads, hd, device=dev, generator=g)
    pos = blocks.make_positions(Bc, Sc, device=dev)
    scale = 1 / math.sqrt(hd / 2 if half_hd_scale else hd)
    outs = {}
    for fused in (True, False):
        ins = [t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v)]
        before = route_counts()
        y = blocks.attention_core(*ins, pos, pos, scale=scale,
                                  fused_ok=fused)
        after = route_counts()
        assert after["attention.kernel"] - before["attention.kernel"] == int(
            fused)
        assert after["attention.plain"] - before["attention.plain"] == int(
            not fused)
        grads = torch.autograd.grad(y, ins, dy.to(torch.bfloat16))
        outs[fused] = [y.float()] + [t.float() for t in grads]
    for name, got, want in zip(("y", "dq", "dk", "dv"), outs[True],
                               outs[False]):
        assert _rel(got, want) <= 2e-2, (name, _rel(got, want))


@pytest.mark.card
def test_a_bf16_step_of_the_smoke_form_takes_the_kernels_on_the_card():
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.train import TrainStepConfig, make_train_step
    dev = _card()
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"), dtype="bfloat16",
                              param_dtype="bfloat16")
    model = _model(cfg, dev)
    batch = {k: v.to(dev) for k, v in _batch(cfg, 2, 256).items()}
    step = make_train_step(model, AdamWConfig(), TrainStepConfig(
        remat="full", warmup_steps=1))
    before = route_counts()
    params = model.params()
    _, _, m = step(params, init_opt(params), batch)
    assert math.isfinite(float(m["loss"]))
    after = route_counts()
    fused, plain, fwd, bwd, ssd_plain = (
        after[k] - before[k] for k in (
            "attention.kernel", "attention.plain", "ssd_scan.launches",
            "ssd_scan_bwd.launches", "ssd.plain"))
    sites = len(cfg.hybrid_layer_ids)
    # forward and recompute of every site
    assert (fused, plain) == (2 * sites, 0)
    assert fwd > 0 and bwd > 0 and ssd_plain == 0
