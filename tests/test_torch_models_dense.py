"""The port's dense decoder LMs against the JAX package's, on the CPU.

Each reduced arch runs with the reference's ``init(PRNGKey(0))``
parameters loaded through ``params_from_numpy`` and the same numpy
batch: ``loss`` and ``ce``, prefill logits and caches, and the next
``decode_step`` must agree within 1e-5 (max|d| / max|ref|, float32).
The blocks (RoPE, M-RoPE, the streaming attention form, the chunked CE)
are held the same way, and ``tests/test_models.py``'s own checks
(prefill against decode to 5e-5, finite grads) are mirrored in the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as ref_blocks
from repro.models import transformer as ref_transformer
from repro_torch.models import blocks, params_from_numpy, params_to_numpy
from repro_torch.models import transformer
from repro_torch.train import remat_context
from torch_lm_reference import (assert_caches_close, assert_close,
                                build_pair, flat_params, numpy_batch,
                                to_jax, to_torch)

DENSE = ["qwen2-0.5b", "gemma2-9b", "starcoder2-7b", "nemotron-4-15b",
         "qwen2-vl-72b"]


@pytest.fixture(scope="module")
def pairs():
    return {a: build_pair(a) for a in DENSE}


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference(pairs, arch):
    pair = pairs[arch]
    batch = numpy_batch(pair.cfg, 2, 16, seed=1)
    ref_loss, ref_m = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, m = pair.port.loss(to_torch(batch))
    assert_close(f"{arch} loss", ref_loss, loss)
    assert_close(f"{arch} ce", ref_m["ce"], m["ce"])


@pytest.mark.parametrize("arch", DENSE)
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(pairs, arch):
    """tests/test_models.py's check in the port: prefill(9) against
    prefill(8) + decode_step, 5e-5 relative."""
    port = pairs[arch].port
    batch = to_torch(numpy_batch(pairs[arch].cfg, 2, 9, seed=4))
    b8 = dict(batch, tokens=batch["tokens"][:, :8])
    if "mrope_positions" in batch:
        # the decode step's three streams all take the cache length
        b8["mrope_positions"] = batch["mrope_positions"][:, :, :8]
        batch["mrope_positions"][:, :, 8] = 8
    logits_a, _ = port.prefill(batch, max_len=16)
    _, cache = port.prefill(b8, max_len=16)
    logits_b, cache2 = port.decode_step(batch["tokens"][:, 8:9], cache)
    rel = float((logits_a - logits_b).abs().max() / logits_a.abs().max())
    assert rel < 5e-5, f"{arch}: rel={rel}"
    assert cache2["len"] == 9


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_finite_and_grads(pairs, arch):
    """Loss near ln(vocab) at random init, every gradient finite."""
    pair = pairs[arch]
    port = pair.port
    port.zero_grad()
    loss, m = port.loss(to_torch(numpy_batch(pair.cfg, 2, 16, seed=5)))
    assert abs(float(m["ce"].detach()) - math.log(pair.cfg.vocab)) < 1.0
    loss.backward()
    grads = [p.grad for p in port.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    port.zero_grad()


def test_state_dict_keys_are_reference_paths(pairs):
    for arch, pair in pairs.items():
        want = flat_params(pair.ref_params)
        got = params_to_numpy(pair.port)
        assert sorted(got) == sorted(want), arch
        for path, arr in want.items():
            assert got[path].dtype == arr.dtype
            np.testing.assert_array_equal(got[path], arr)
        assert sorted(k.replace(".", "/") for k in
                      pair.port.state_dict()) == sorted(want)


def test_params_from_numpy_rejects_missing_extra_and_mismatch(pairs):
    pair = pairs["qwen2-0.5b"]
    flat = flat_params(pair.ref_params)
    missing = dict(flat)
    missing.pop("layers/attn/bq")
    with pytest.raises(KeyError, match="layers/attn/bq"):
        params_from_numpy(pair.port, missing)
    with pytest.raises(KeyError, match="layers/attn/extra"):
        params_from_numpy(pair.port, dict(flat, **{
            "layers/attn/extra": np.zeros(3, np.float32)}))
    bad = dict(flat, embed=flat["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(pair.port, bad)
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(pair.port,
                          dict(flat, embed=flat["embed"].astype(np.float64)))
    params_from_numpy(pair.port, flat)     # leaves the model as it was


def test_params_numpy_roundtrip_in_bfloat16():
    """A bfloat16 model's arrays leave and return in numpy's bfloat16
    (ml_dtypes, as JAX's arrays carry it), bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("gemma2-9b").reduced(),
                              dtype="bfloat16", param_dtype="bfloat16")
    src = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
    flat = params_to_numpy(src)
    assert {a.dtype.name for a in flat.values()} == {"bfloat16"}
    dst = params_from_numpy(build_model(cfg, "cpu"), flat)
    for (name, a), (_, b) in zip(src.named_parameters(),
                                 dst.named_parameters()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b), name


def test_gemma_windows_alternate_by_absolute_layer(pairs):
    pair = pairs["gemma2-9b"]
    for n, off in ((4, 0), (3, 1), (5, 2)):
        want = np.asarray(pair.ref._windows(n, offset=off)).tolist()
        assert pair.port._windows(n, offset=off) == want


def test_vlm_extra_embeds_match_reference(pairs):
    pair = pairs["qwen2-vl-72b"]
    batch = numpy_batch(pair.cfg, 2, 8, seed=6)
    batch["extra_embeds"] = np.random.default_rng(7).standard_normal(
        (2, 8, pair.cfg.d_model)).astype(np.float32)
    ref_loss, _ = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, _ = pair.port.loss(to_torch(batch))
    assert_close("extra_embeds loss", ref_loss, loss)


def test_train_kv_chunk_env_matches_reference(pairs, monkeypatch):
    """REPRO_TRAIN_KV_CHUNK forces the streaming form in ``loss`` in
    both packages; the loss stays the plain form's."""
    pair = pairs["gemma2-9b"]
    batch = numpy_batch(pair.cfg, 2, 16, seed=8)
    plain, _ = pair.port.loss(to_torch(batch))
    monkeypatch.setenv("REPRO_TRAIN_KV_CHUNK", "4")
    ref_loss, _ = pair.ref.loss(pair.ref_params, to_jax(batch))
    loss, _ = pair.port.loss(to_torch(batch))
    assert_close("streamed loss", ref_loss, loss)
    assert_close("streamed against plain", plain.detach(), loss)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_policies_keep_loss_and_grads(pairs, policy):
    pair = pairs["starcoder2-7b"]
    batch = to_torch(numpy_batch(pair.cfg, 2, 8, seed=9))

    def loss_and_grads():
        pair.port.zero_grad()
        loss, _ = pair.port.loss(batch)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in
                 pair.port.named_parameters()}
        pair.port.zero_grad()
        return loss.detach(), grads

    loss0, g0 = loss_and_grads()
    with remat_context(policy):
        loss1, g1 = loss_and_grads()
    assert torch.equal(loss0, loss1)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-6, atol=0)


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------
def _attn_inputs(seed, B=2, Sq=5, Skv=13, H=4, K=2, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, K, hd)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Sq) + 6, (B, Sq)).astype(np.int32)
    # the last slots are invalid cache positions, so the last chunk of 4
    # is fully masked
    kv_pos = np.arange(Skv).astype(np.int32)
    kv_pos[9:] = 2**30
    return q, k, v, q_pos, np.broadcast_to(kv_pos, (B, Skv)).copy()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 50.0), (0, 20.0)])
@pytest.mark.parametrize("kv_chunk", [0, 4, 5])
def test_attention_core_matches_reference(window, cap, kv_chunk):
    q, k, v, qp, kp = _attn_inputs(10 + kv_chunk)
    kw = dict(causal=True, window=window, attn_cap=cap, kv_chunk=kv_chunk)
    ref = ref_blocks.attention_core(*map(jnp.asarray, (q, k, v, qp, kp)),
                                    **kw)
    got = blocks.attention_core(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                **kw)
    assert bool(torch.isfinite(got).all())
    assert_close("attention_core", ref, got)
    if kv_chunk:
        plain = blocks.attention_core(
            *map(torch.from_numpy, (q, k, v, qp, kp)),
            **dict(kw, kv_chunk=0))
        assert_close("streamed against plain", plain, got)


def test_rope_and_mrope_match_reference():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 7)).astype(np.int32)
    assert_close("rope", ref_blocks.rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e4),
                 blocks.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4))
    pos3 = rng.integers(0, 50, (3, 2, 7)).astype(np.int32)
    for hd in (16, 128):          # reduced (rescaled sections) and full
        xx = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
        assert_close(f"mrope hd {hd}",
                     ref_blocks.mrope(jnp.asarray(xx), jnp.asarray(pos3),
                                      1e6),
                     blocks.mrope(torch.from_numpy(xx),
                                  torch.from_numpy(pos3), 1e6))


def test_chunked_ce_matches_reference():
    """The seq-chunked CE (vocab >= 65536 at S > 512) at S 1024."""
    rng = np.random.default_rng(12)
    h = rng.standard_normal((1, 1024, 8)).astype(np.float32)
    w = rng.standard_normal((8, 16)).astype(np.float32)
    t = rng.integers(0, 16, (1, 1024)).astype(np.int32)
    m = (rng.random((1, 1024)) < 0.8).astype(np.float32)
    ref, ref_n = ref_transformer._chunked_ce(
        lambda hh: hh @ jnp.asarray(w), jnp.asarray(h), jnp.asarray(t),
        jnp.asarray(m), chunked=True)
    tw = torch.from_numpy(w)
    for chunked in (True, False):
        got, n = transformer._chunked_ce(
            lambda hh: hh @ tw, torch.from_numpy(h), torch.from_numpy(t),
            torch.from_numpy(m), chunked=chunked)
        assert float(n) == float(ref_n)
        assert_close(f"chunked={chunked}", ref, got)
