"""The port's blockwise int8 quantization and error feedback against the
JAX package's on the same seeded numpy inputs (int8 equal, scales within
1e-7 relative), and mirrors of ``tests/test_substrate.py``'s compression
tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.dist import ef_compress as ref_ef_compress
from repro.dist import ef_compress_tree as ref_ef_compress_tree
from repro.dist import quantize_blockwise as ref_quantize_blockwise
from repro_torch.dist import (dequantize_blockwise, ef_compress,
                              ef_compress_tree, quantize_blockwise)
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.double().numpy()
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("n,block", [(1, 256), (255, 256), (513, 256),
                                     (4096, 256), (1000, 64), (7, 4)])
def test_quantize_blockwise_matches_reference(n, block):
    x = (np.random.default_rng(n).standard_normal(n) * 5).astype(np.float32)
    if n > block:
        x[:block] = 0.0                 # an all-zero block: scale 0
    q, s = ref_quantize_blockwise(jnp.asarray(x), block)
    tq, ts = quantize_blockwise(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tq.shape == q.shape and ts.shape == s.shape
    assert np.array_equal(np.asarray(q), tq.numpy())
    assert _rel(s, ts) <= 1e-7


def test_ef_compress_tree_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 100)).astype(np.float32),
            "b": {"c": rng.standard_normal(700).astype(np.float32)}}
    err = {"a": rng.standard_normal((3, 100)).astype(np.float32) * 1e-2,
           "b": {"c": rng.standard_normal(700).astype(np.float32) * 1e-2}}
    j = jax.tree.map(jnp.asarray, tree)
    je = jax.tree.map(jnp.asarray, err)
    t = jax.tree.map(torch.from_numpy, tree)
    te = jax.tree.map(torch.from_numpy, err)
    for ref, got in ((ref_ef_compress_tree(j), ef_compress_tree(t)),
                     (ref_ef_compress_tree(j, je), ef_compress_tree(t, te))):
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
            assert b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    gh, e = ef_compress(t["b"]["c"])
    rgh, re_ = ref_ef_compress(j["b"]["c"])
    assert _rel(rgh, gh) <= 1e-6


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 2000), st.integers(0, 5))
def test_quantize_roundtrip_bounded(n, seed):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    q, s = quantize_blockwise(torch.from_numpy(x))
    y = dequantize_blockwise(q, s, (n,)).numpy()
    blk_max = np.abs(x).max() if n else 0.0
    assert np.abs(x - y).max() <= blk_max / 127 * 1.01 + 1e-9


def test_error_feedback_identity():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(513)
                         .astype(np.float32))
    gh, err = ef_compress(g)
    assert float(((gh + err) - g).abs().max()) < 1e-6


def test_error_feedback_converges():
    """EF compression preserves the long-run gradient sum."""
    gs = [torch.from_numpy(np.random.default_rng(i).standard_normal(256)
                           .astype(np.float32)) * 0.1 for i in range(50)]
    err = torch.zeros(256)
    total_hat = torch.zeros(256)
    for g in gs:
        gh, err = ef_compress(g, err)
        total_hat += gh
    total = sum(gs)
    assert float((total_hat + err - total).abs().max()) < 1e-4
