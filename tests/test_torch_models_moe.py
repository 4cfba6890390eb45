"""The port's MoE decoder LMs and MoE block against the JAX package's,
on the CPU.

As ``test_torch_models_dense``: the reference's ``init(PRNGKey(0))``
parameters through ``params_from_numpy``, the same numpy batch, 1e-5
relative in float32 for ``loss``, ``ce``, ``aux``, prefill logits and
caches and ``decode_step``.  The block is also held at a capacity
factor that drops slots, and gemma2-style window alternation after a
dense first layer is held by absolute layer index.  Router logits come
from continuous random weights and inputs, so no two experts tie.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as ref_blocks
from repro_torch.models import blocks
from torch_lm_reference import (assert_caches_close, assert_close,
                                build_pair, numpy_batch, to_jax, to_torch)

MOE = ["kimi-k2-1t-a32b", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module")
def pairs():
    return {a: build_pair(a) for a in MOE}


@pytest.mark.parametrize("arch", MOE)
def test_loss_matches_reference(pairs, arch):
    pair = pairs[arch]
    batch = numpy_batch(pair.cfg, 2, 16, seed=1)
    ref_loss, ref_m = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, m = pair.port.loss(to_torch(batch))
    assert_close(f"{arch} loss", ref_loss, loss)
    assert_close(f"{arch} ce", ref_m["ce"], m["ce"])
    assert_close(f"{arch} aux", ref_m["aux"], m["aux"])


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(pairs, arch):
    pair = pairs[arch]
    batch = numpy_batch(pair.cfg, 2, 9, seed=2)
    ref_logits, ref_cache = pair.ref.prefill(pair.ref_params, to_jax(batch),
                                             max_len=12)
    logits, cache = pair.port.prefill(to_torch(batch), max_len=12)
    assert_close(f"{arch} prefill logits", ref_logits, logits)
    assert_caches_close(f"{arch} prefill", ref_cache, cache)
    nxt = np.random.default_rng(3).integers(
        0, pair.cfg.vocab, (2, 1)).astype(np.int32)
    ref_logits, ref_cache = pair.ref.decode_step(pair.ref_params,
                                                 jnp.asarray(nxt), ref_cache)
    logits, cache = pair.port.decode_step(torch.from_numpy(nxt), cache)
    assert_close(f"{arch} decode logits", ref_logits, logits)
    assert_caches_close(f"{arch} decode", ref_cache, cache)


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency(pairs, arch):
    """tests/test_models.py's check in the port: 5e-2 for MoE, whose
    capacity drops differ between 18 tokens and 2."""
    port = pairs[arch].port
    batch = to_torch(numpy_batch(pairs[arch].cfg, 2, 9, seed=4))
    logits_a, _ = port.prefill(batch, max_len=16)
    _, cache = port.prefill(dict(batch, tokens=batch["tokens"][:, :8]),
                            max_len=16)
    logits_b, cache2 = port.decode_step(batch["tokens"][:, 8:9], cache)
    rel = float((logits_a - logits_b).abs().max() / logits_a.abs().max())
    assert rel < 5e-2, f"{arch}: rel={rel}"
    assert cache2["len"] == 9


@pytest.mark.parametrize("arch", MOE)
def test_train_step_finite_and_grads(pairs, arch):
    pair = pairs[arch]
    port = pair.port
    port.zero_grad()
    loss, m = port.loss(to_torch(numpy_batch(pair.cfg, 2, 16, seed=5)))
    assert abs(float(m["ce"].detach()) - math.log(pair.cfg.vocab)) < 1.0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in port.parameters())
    port.zero_grad()


def _moe_inputs(arch_pair, T_shape, seed):
    """The pair's first MoE layer's parameters and a random input."""
    params = jax.tree.map(lambda a: a[0], arch_pair.ref_params["layers"]
                          ["moe"])
    x = np.random.default_rng(seed).standard_normal(
        T_shape + (arch_pair.cfg.d_model,)).astype(np.float32)
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    return params, tparams, x


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference_with_capacity_drops(pairs, arch, cf):
    """At cf 0.5 the capacity C = ceil(T k cf / E) holds half the slots,
    so slots are dropped; at 4.0 none are."""
    pair = pairs[arch]
    cfg = dataclasses.replace(pair.cfg, capacity_factor=cf)
    params, tparams, x = _moe_inputs(pair, (2, 8), seed=int(cf * 10))
    T, k, E = 16, cfg.top_k, cfg.n_experts
    C = max(1, math.ceil(T * k * cf / E))
    assert (C * E < T * k) == (cf < 1.0)
    ref_y, ref_aux = ref_blocks.apply_moe(params, cfg, jnp.asarray(x))
    y, aux = blocks.apply_moe(tparams, cfg, torch.from_numpy(x))
    assert_close(f"{arch} cf {cf} y", ref_y, y)
    assert_close(f"{arch} cf {cf} aux", ref_aux, aux)
    if cf < 1.0:       # drops change the output
        full, _ = blocks.apply_moe(
            tparams, dataclasses.replace(cfg, capacity_factor=4.0),
            torch.from_numpy(x))
        assert float((full - y).abs().max()) > 1e-3


def test_windows_after_dense_layers_by_absolute_index():
    """gemma2-style alternation on an MoE model with a dense first layer:
    the scanned layers' windows start at layer 1, and the loss over 16
    tokens (past the 4-token window) equals the reference's."""
    pair = build_pair("kimi-k2-1t-a32b", sliding_window=4,
                      local_global_alternate=True)
    assert pair.port._windows(3, offset=1) == [0, 4, 0]
    assert pair.port._windows(3, offset=1) == np.asarray(
        pair.ref._windows(3, offset=1)).tolist()
    batch = numpy_batch(pair.cfg, 2, 16, seed=6)
    ref_loss, _ = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, _ = pair.port.loss(to_torch(batch))
    assert_close("windowed MoE loss", ref_loss, loss)
