"""The port's Mamba2 LM and Zamba2 hybrid against the JAX package's, on
the CPU.

As ``test_torch_models_dense``: the reference's ``init(PRNGKey(0))``
parameters through ``params_from_numpy``, the same numpy batch, 1e-5
relative in float32 for ``loss``, prefill logits and caches (SSM and
conv states; the hybrid's per-site KV caches) and ``decode_step``.  The
SSD blocks (chunked dual form with padding and a carried state, the
causal conv, the decode step) are held the same way, and
``tests/test_models.py``'s prefill-against-decode checks are mirrored
(5e-5; the decode chain 1e-3).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.models import ssm
from torch_lm_reference import (assert_caches_close, assert_close,
                                build_pair, numpy_batch, to_jax, to_torch)

SSM = ["mamba2-780m", "zamba2-2.7b"]


@pytest.fixture(scope="module")
def pairs():
    return {a: build_pair(a) for a in SSM}


@pytest.mark.parametrize("arch", SSM)
def test_loss_matches_reference(pairs, arch):
    pair = pairs[arch]
    batch = numpy_batch(pair.cfg, 2, 64, seed=1)    # two SSD chunks of 32
    ref_loss, ref_m = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, m = pair.port.loss(to_torch(batch))
    assert_close(f"{arch} loss", ref_loss, loss)
    assert_close(f"{arch} ce", ref_m["ce"], m["ce"])


@pytest.mark.parametrize("arch", SSM)
def test_prefill_and_decode_match_reference(pairs, arch):
    pair = pairs[arch]
    batch = numpy_batch(pair.cfg, 2, 9, seed=2)
    ref_logits, ref_cache = pair.ref.prefill(pair.ref_params, to_jax(batch),
                                             max_len=12)
    logits, cache = pair.port.prefill(to_torch(batch), max_len=12)
    assert_close(f"{arch} prefill logits", ref_logits, logits)
    assert_caches_close(f"{arch} prefill", ref_cache, cache)
    rng = np.random.default_rng(3)
    for step in range(2):
        nxt = rng.integers(0, pair.cfg.vocab, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = pair.ref.decode_step(
            pair.ref_params, jnp.asarray(nxt), ref_cache)
        logits, cache = pair.port.decode_step(torch.from_numpy(nxt), cache)
        assert_close(f"{arch} decode {step} logits", ref_logits, logits)
        assert_caches_close(f"{arch} decode {step}", ref_cache, cache)


@pytest.mark.parametrize("arch", SSM)
def test_prefill_decode_consistency(pairs, arch):
    port = pairs[arch].port
    batch = to_torch(numpy_batch(pairs[arch].cfg, 2, 9, seed=4))
    logits_a, _ = port.prefill(batch, max_len=16)
    _, cache = port.prefill(dict(batch, tokens=batch["tokens"][:, :8]),
                            max_len=16)
    logits_b, cache2 = port.decode_step(batch["tokens"][:, 8:9], cache)
    rel = float((logits_a - logits_b).abs().max() / logits_a.abs().max())
    assert rel < 5e-5, f"{arch}: rel={rel}"
    assert cache2["len"] == 9


@pytest.mark.parametrize("arch", SSM)
def test_ssm_decode_chain_matches_prefill(pairs, arch):
    """Token-by-token decode reproduces the prefill logits (1e-3)."""
    port = pairs[arch].port
    toks = to_torch(numpy_batch(pairs[arch].cfg, 1, 6, seed=5))["tokens"]
    full, _ = port.prefill({"tokens": toks}, max_len=8)
    _, cache = port.prefill({"tokens": toks[:, :1]}, max_len=8)
    for t in range(1, 6):
        logits, cache = port.decode_step(toks[:, t:t + 1], cache)
    rel = float((full - logits).abs().max() / full.abs().max())
    assert rel < 1e-3, f"{arch}: rel={rel}"


@pytest.mark.parametrize("arch", SSM)
def test_train_step_finite_and_grads(pairs, arch):
    pair = pairs[arch]
    port = pair.port
    port.zero_grad()
    loss, m = port.loss(to_torch(numpy_batch(pair.cfg, 2, 16, seed=6)))
    assert abs(float(m["ce"].detach()) - math.log(pair.cfg.vocab)) < 1.0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in port.parameters())
    port.zero_grad()


def test_hybrid_sites_share_weights_not_caches(pairs):
    pair = pairs["zamba2-2.7b"]
    assert pair.port.n_sites == 2
    # one copy of the attention weights; Mamba layers as (sites, every)
    assert pair.port.shared_attn.wq.shape == (
        pair.cfg.d_model, pair.cfg.n_heads * pair.cfg.hd())
    assert pair.port.layers.ln.scale.shape == (2, 2, pair.cfg.d_model)
    _, cache = pair.port.prefill(
        to_torch(numpy_batch(pair.cfg, 1, 5, seed=7)), max_len=8)
    assert cache["k"].shape[0] == 2
    assert not torch.equal(cache["k"][0], cache["k"][1])


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def _ssd_inputs(seed, B=2, S=48, H=3, P=4, N=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(
                np.float32),
            -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(chunk, with_h0):
    """S 48 over chunks of 8 and 16 (6 and 3 chunks) and of 64 (clipped
    to S); a carried state h0 enters the first chunk."""
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(chunk)
    h0 = h0 if with_h0 else None
    ref_y, ref_h = ref_ssm._ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
        None if h0 is None else jnp.asarray(h0))
    y, h = ssm._ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                            chunk, None if h0 is None
                            else torch.from_numpy(h0))
    assert y.shape == (2, 48, 3, 4) and h.shape == (2, 3, 4, 5)
    assert_close(f"ssd y chunk {chunk}", ref_y, y)
    assert_close(f"ssd h chunk {chunk}", ref_h, h)


def test_ssd_chunked_pads_a_ragged_last_chunk():
    """S 37 over chunks of 16: the port pads every input along S (the
    reference's pad of dt raises there, ROADMAP Queue 3), and the zero
    padding leaves y and the final state those of one unpadded chunk."""
    x, dt, A, Bm, Cm, h0 = (torch.from_numpy(a[:, :37] if a.ndim > 1
                                             and a.shape[1] == 48 else a)
                            for a in _ssd_inputs(3))
    y, h = ssm._ssd_chunked(x, dt, A, Bm, Cm, 16, h0)
    y1, h1 = ssm._ssd_chunked(x, dt, A, Bm, Cm, 37, h0)
    assert y.shape == (2, 37, 3, 4)
    assert_close("ragged y", y1, y)
    assert_close("ragged h", h1, h)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(8)
    xbc = rng.standard_normal((2, 7, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        ref = ref_ssm._causal_conv(
            *map(jnp.asarray, (xbc, w, b)),
            None if state is None else jnp.asarray(state))
        got = ssm._causal_conv(
            *map(torch.from_numpy, (xbc, w, b)),
            None if state is None else torch.from_numpy(state))
        assert_close("conv y", ref[0], got[0])
        assert_close("conv state", ref[1], got[1])


def test_mamba_step_matches_reference(pairs):
    """One layer's decode step from a random state (the conv window
    rolls; the SSM state stays float32)."""
    pair = pairs["mamba2-780m"]
    cfg = pair.cfg
    lp = {k: np.array(v[0])
          for k, v in pair.ref_params["layers"]["mamba"].items()}
    rng = np.random.default_rng(9)
    u = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = {"ssm": rng.standard_normal(
                 (2, cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state)
             ).astype(np.float32),
             "conv": rng.standard_normal(
                 (2, cfg.conv_kernel - 1, cfg.d_inner() + 2 * cfg.ssm_state)
             ).astype(np.float32)}
    ref_y, ref_st = ref_ssm.mamba_step(
        {k: jnp.asarray(v) for k, v in lp.items()}, cfg, jnp.asarray(u),
        {k: jnp.asarray(v) for k, v in state.items()})
    y, st = ssm.mamba_step(
        {k: torch.from_numpy(v) for k, v in lp.items()}, cfg,
        torch.from_numpy(u),
        {k: torch.from_numpy(v) for k, v in state.items()})
    assert st["ssm"].dtype == torch.float32
    assert_close("mamba_step y", ref_y, y)
    assert_caches_close("mamba_step", ref_st, st)
