"""The port's Whisper-style encoder-decoder against the JAX package's,
on the CPU.

As ``test_torch_models_dense``: the reference's ``init(PRNGKey(0))``
parameters through ``params_from_numpy``, the same numpy batch (tokens
and stub frame embeddings), 1e-5 relative in float32 for the encoder
states, ``loss``, prefill logits and caches (self and cross K/V) and
``decode_step``.  The engine's ``run`` passes only tokens, so in both
packages it cannot serve this family (``KeyError: 'frames'``); greedy
``generate`` with frames in the batch serves it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import ServeEngine as RefServeEngine
from repro.serve import generate as ref_generate
from repro_torch.serve import ServeEngine, generate
from torch_lm_reference import (assert_caches_close, assert_close,
                                assert_greedy_matches, build_pair,
                                numpy_batch, to_jax, to_torch)

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def pair():
    return build_pair(ARCH)


def test_encoder_matches_reference(pair):
    frames = numpy_batch(pair.cfg, 2, 4, seed=1)["frames"]
    ref = pair.ref.encode(pair.ref_params, jnp.asarray(frames))
    got = pair.port.encode(pair.port.params(), torch.from_numpy(frames))
    assert_close("encoder states", ref, got)


def test_loss_matches_reference(pair):
    batch = numpy_batch(pair.cfg, 2, 16, seed=2)
    ref_loss, ref_m = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, m = pair.port.loss(to_torch(batch))
    assert_close("loss", ref_loss, loss)
    assert_close("ce", ref_m["ce"], m["ce"])


def test_prefill_and_decode_match_reference(pair):
    batch = numpy_batch(pair.cfg, 2, 9, seed=3)
    ref_logits, ref_cache = pair.ref.prefill(pair.ref_params, to_jax(batch),
                                             max_len=12)
    logits, cache = pair.port.prefill(to_torch(batch), max_len=12)
    assert_close("prefill logits", ref_logits, logits)
    assert_caches_close("prefill", ref_cache, cache)
    nxt = np.random.default_rng(4).integers(
        0, pair.cfg.vocab, (2, 1)).astype(np.int32)
    ref_logits, ref_cache = pair.ref.decode_step(pair.ref_params,
                                                 jnp.asarray(nxt), ref_cache)
    logits, cache = pair.port.decode_step(torch.from_numpy(nxt), cache)
    assert_close("decode logits", ref_logits, logits)
    assert_caches_close("decode", ref_cache, cache)


def test_prefill_decode_consistency(pair):
    batch = to_torch(numpy_batch(pair.cfg, 2, 9, seed=5))
    logits_a, _ = pair.port.prefill(batch, max_len=16)
    _, cache = pair.port.prefill(dict(batch, tokens=batch["tokens"][:, :8]),
                                 max_len=16)
    logits_b, cache2 = pair.port.decode_step(batch["tokens"][:, 8:9], cache)
    rel = float((logits_a - logits_b).abs().max() / logits_a.abs().max())
    assert rel < 5e-5, f"rel={rel}"
    assert cache2["len"] == 9


def test_train_step_finite_and_grads(pair):
    port = pair.port
    port.zero_grad()
    loss, m = port.loss(to_torch(numpy_batch(pair.cfg, 2, 16, seed=6)))
    assert abs(float(m["ce"].detach()) - math.log(pair.cfg.vocab)) < 1.0
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in port.parameters())
    port.zero_grad()


def test_greedy_generate_with_frames_matches_reference(pair):
    batch = numpy_batch(pair.cfg, 2, 6, seed=7)
    batch = {k: batch[k] for k in ("tokens", "frames")}
    ref = np.asarray(ref_generate(pair.ref, pair.ref_params, to_jax(batch),
                                  max_new=8))
    got = generate(pair.port, to_torch(batch), max_new=8).numpy()
    assert got.shape == ref.shape == (2, 8)
    assert_greedy_matches(pair, batch, ref, got)


def test_engine_cannot_serve_without_frames(pair):
    """Both engines prefill with tokens only: KeyError 'frames'."""
    prompt = np.arange(4, dtype=np.int32)
    ref_eng = RefServeEngine(pair.ref, pair.ref_params, slots=2,
                             prompt_len=4, max_new=2)
    eng = ServeEngine(pair.port, slots=2, prompt_len=4, max_new=2)
    for e in (ref_eng, eng):
        e.submit(0, prompt)
        with pytest.raises(KeyError, match="frames"):
            e.run()
