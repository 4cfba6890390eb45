"""Helpers shared by the LM parity tests (``test_torch_models_*``,
``test_torch_serve_engine``): the JAX package's reference models on the
CPU, their parameters carried into the port as flat numpy dicts, seeded
numpy batches fed to both, and the comparisons.

Tolerance: ``max|d| / max|ref|`` at most 1e-5 in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.utils import keystr_path
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy

F32_TOL = 1e-5
# a reference step whose top-2 logits lie closer than this (relative to
# the row's max |logit|) is a near tie: compare by teacher forcing
TIE_GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """Run a module's tests with torch on one thread (autouse where a test
    module imports it).  With pytest-xdist's workers sharing the cores,
    each worker's own torch thread pool oversubscribes them: a training
    loop of small ops that takes 1 s alone took minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_params(params) -> Dict[str, np.ndarray]:
    """The reference's parameter tree as ``{'a/b/0': array}``."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {keystr_path(kp): np.asarray(v) for kp, v in leaves}


@dataclasses.dataclass
class Pair:
    """One reduced arch built in both frameworks with the reference's
    ``init(PRNGKey(0))`` parameters."""

    arch: str
    cfg: object
    ref: object
    ref_params: object
    port: object


def build_pair(arch: str, **overrides) -> Pair:
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), **overrides)
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref = ref_build_model(ref_cfg)
    ref_params = ref.init(jax.random.PRNGKey(0))
    port = build_model(cfg, "cpu")
    params_from_numpy(port, flat_params(ref_params))
    return Pair(arch, cfg, ref, ref_params, port)


def numpy_batch(cfg, B: int, S: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """A training/prefill batch from seeded numpy, in the reference's
    dtypes."""
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "mask": (rng.random((B, S)) < 0.9).astype(np.float32),
    }
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        t = np.arange(S, dtype=np.int32)
        batch["mrope_positions"] = np.stack(
            [np.broadcast_to(t, (B, S)),
             np.broadcast_to(t // 2, (B, S)),
             np.broadcast_to(t % 3, (B, S))]).astype(np.int32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def rel(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def assert_close(what, ref, got, tol=F32_TOL):
    r = rel(ref, got)
    assert r <= tol, f"{what}: max|d|/max|ref| = {r:.3g} > {tol}"


def assert_caches_close(what, ref_cache, cache, tol=F32_TOL):
    assert sorted(ref_cache) == sorted(cache), (sorted(ref_cache),
                                                sorted(cache))
    for k in ref_cache:
        if k == "len":
            assert int(ref_cache[k]) == int(cache[k]), what
        else:
            assert_close(f"{what} cache {k}", ref_cache[k], cache[k], tol)


def _top2_gap(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)[:, -2:]
    return (top[:, 1] - top[:, 0]) / np.maximum(np.abs(logits).max(-1),
                                                1e-30)


def assert_greedy_matches(pair: Pair, batch: Dict[str, np.ndarray],
                          ref_toks: np.ndarray, port_toks: np.ndarray):
    """The port's greedy tokens against the reference's for one batch.

    Teacher-forces both models along the reference's tokens: each row
    must equal the reference's up to its first near-tie step (a top-2
    gap below ``TIE_GAP``), and from there the port's argmax must equal
    the reference's token at every step that is not a near tie; each
    step's logits agree within ``F32_TOL``."""
    B, n = ref_toks.shape
    S = batch["tokens"].shape[1]
    ref_logits, cache = pair.ref.prefill(pair.ref_params, to_jax(batch),
                                         max_len=S + n)
    logits, pcache = pair.port.prefill(to_torch(batch), max_len=S + n)
    first_tie = np.full(B, n)
    for t in range(n):
        rl = np.asarray(ref_logits)
        assert_close(f"{pair.arch} greedy step {t} logits", rl, logits)
        assert np.array_equal(rl.argmax(-1), ref_toks[:, t])
        tie = _top2_gap(rl) < TIE_GAP
        first_tie = np.where(tie & (first_tie == n), t, first_tie)
        got = logits.argmax(-1).numpy()
        assert np.array_equal(got[~tie], ref_toks[~tie, t]), (pair.arch, t)
        if t + 1 < n:
            nxt = ref_toks[:, t:t + 1]
            ref_logits, cache = pair.ref.decode_step(
                pair.ref_params, jnp.asarray(nxt), cache)
            logits, pcache = pair.port.decode_step(
                torch.from_numpy(nxt.astype(np.int64)), pcache)
    for b in range(B):
        t = first_tie[b]
        assert np.array_equal(port_toks[b, :t], ref_toks[b, :t]), (
            pair.arch, b, port_toks[b], ref_toks[b])
