"""The port's loss, gradients and update against the JAX package's,
every arch at ``.reduced()`` in float32 with the same weights and
seeded-numpy batches: the loss and every gradient leaf of
``make_loss_fn`` against ``jax.value_and_grad``, and AdamW's update from
the same gradients (``test_torch_train_steps.py`` takes whole steps).

Tolerances (max|d| / max|ref|, each gradient leaf on its own): loss and
gradients 1e-5 (both MoE archs too: their routing is the same discrete
choice in both packages, so their gradients agree as closely as the
dense archs'), except the Mamba2 decay ``layers/mamba/A_log`` of the two
SSM archs, 5e-5: its gradient sums terms that cancel over batch,
sequence and the chunk's cumulative decay, and float32 roundoff in
autograd's order of summation leaves it up to 1.1e-5 from the float64
gradient of the same function
(``test_ssd_decay_grad_is_the_references``); the update from identical
gradients 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import init_opt as ref_init_opt
from repro.train import make_loss_fn as ref_make_loss_fn
from repro.utils import keystr_path as ref_keystr_path
from repro_torch.configs import list_archs
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamWConfig, apply_updates, init_opt
from repro_torch.train import make_loss_fn
from repro_torch.utils import leaves_with_paths, unflatten_like
from torch_lm_reference import (build_pair, flat_params, numpy_batch, rel,
                                to_jax, to_torch, torch_one_thread)  # noqa: F401

GRAD_TOL = 1e-5
DECAY_GRAD_TOL = 5e-5           # layers/mamba/A_log (see the docstring)
UPDATE_TOL = 1e-6
B, S = 4, 16


@pytest.fixture(scope="module")
def pairs():
    """Each arch built in both packages once, on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build_pair(arch)
        pair = cache[arch]
        # every test starts from the reference's parameters
        params_from_numpy(pair.port, flat_params(pair.ref_params))
        return pair
    return get


def _grads_by_path(tree, key=ref_keystr_path):
    return {key(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", list_archs())
def test_loss_and_grads_match_reference(pairs, arch):
    pair = pairs(arch)
    batch = numpy_batch(pair.cfg, B, S, seed=1)
    (ref_loss, _), ref_g = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(pair.ref, None), has_aux=True))(
        pair.ref_params, to_jax(batch))
    params = pair.port.params()
    loss, _ = make_loss_fn(pair.port, None)(params, to_torch(batch))
    paths, leaves = zip(*leaves_with_paths(params))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert rel(ref_loss, loss) <= GRAD_TOL
    want = _grads_by_path(ref_g)
    assert sorted(want) == sorted(paths)
    for path, g in zip(paths, grads):
        r = rel(want[path], g)
        tol = DECAY_GRAD_TOL if path == "layers/mamba/A_log" else GRAD_TOL
        assert r <= tol, f"{arch} grad {path}: rel {r:.3g}"


def test_ssd_decay_grad_is_the_references(pairs):
    """mamba2's ``A_log`` gradient in float64 (the port's model upcast)
    agrees with the reference's float32 one within 1e-5, and the port's
    float32 one within 5e-5 of it: the two packages take the gradient
    of the same function, with float32 roundoff between them."""
    import dataclasses
    from repro_torch.models import build_model
    pair = pairs("mamba2-780m")
    batch = numpy_batch(pair.cfg, B, S, seed=1)
    _, ref_g = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(pair.ref, None), has_aux=True))(
        pair.ref_params, to_jax(batch))
    want = _grads_by_path(ref_g)["layers/mamba/A_log"]
    m64 = build_model(dataclasses.replace(pair.cfg, dtype="float64",
                                          param_dtype="float64"), "cpu")
    with torch.no_grad():
        for name, p in m64.named_parameters():
            p.copy_(pair.port.get_parameter(name))
    got = {}
    for model, b in ((pair.port, to_torch(batch)),
                     (m64, {k: v.double() if v.is_floating_point() else v
                            for k, v in to_torch(batch).items()})):
        loss, _ = make_loss_fn(model, None)(model.params(), b)
        got[model] = torch.autograd.grad(
            loss, model.get_parameter("layers.mamba.A_log"))[0]
    g32, g64 = got[pair.port], got[m64]
    assert rel(want, g64) <= GRAD_TOL
    assert rel(g64.numpy(), g32) <= DECAY_GRAD_TOL


@pytest.mark.parametrize("arch", list_archs())
def test_update_from_identical_grads(pairs, arch):
    """The port's gradients fed to both packages' AdamW: parameters,
    moments and the grad norm within 1e-6."""
    pair = pairs(arch)
    batch = numpy_batch(pair.cfg, B, S, seed=2)
    params = pair.port.params()
    loss, _ = make_loss_fn(pair.port, None)(params, to_torch(batch))
    paths, leaves = zip(*leaves_with_paths(params))
    grads = dict(zip(paths, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    ref_g = jax.tree_util.tree_map_with_path(
        lambda kp, _: jnp.asarray(grads[ref_keystr_path(kp)].numpy()),
        pair.ref_params)
    cfg = dict(lr=1e-3)
    ref_p, ref_s, ref_m = jax.jit(functools.partial(
        ref_apply_updates, RefAdamWConfig(**cfg)))(
        pair.ref_params, ref_g, ref_init_opt(pair.ref_params))
    p, s, m = apply_updates(AdamWConfig(**cfg), params,
                            unflatten_like(params, iter(grads.values())),
                            init_opt(params))
    assert rel(ref_m["grad_norm"], m["grad_norm"]) <= UPDATE_TOL
    for name, ref_tree, tree in (("params", ref_p, p), ("mu", ref_s.mu, s.mu),
                                 ("nu", ref_s.nu, s.nu)):
        want = _grads_by_path(ref_tree)
        for path, t in leaves_with_paths(tree):
            r = rel(want[path], t)
            assert r <= UPDATE_TOL, f"{arch} {name} {path}: rel {r:.3g}"
