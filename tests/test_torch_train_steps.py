"""Whole train steps of the port against the JAX package's, the same
weights and seeded-numpy batches in float32: three steps of every arch
at ``.reduced()``, and the step's knobs on qwen2-0.5b reduced
(microbatches, the remat policies, bfloat16 accumulation, int8 gradient
compression, 8-bit moments).

Tolerance: each step's loss and grad norm within 1e-4 relative of the
reference's.  Parameters are not compared after a step: each package
updates from its own gradients, and where a gradient is near 0 Adam's
first update (about ``lr * sign(g)``) can differ by ``2 * lr`` on
roundoff alone (``test_torch_train_step.py`` holds the update from the
same gradients)."""

import jax
import pytest

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt as ref_init_opt
from repro.optim import init_opt_q8 as ref_init_opt_q8
from repro.train import TrainStepConfig as RefTrainStepConfig
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import list_archs
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamWConfig, init_opt, init_opt_q8
from repro_torch.train import TrainStepConfig, make_train_step
from torch_lm_reference import (build_pair, flat_params, numpy_batch, rel,
                                to_jax, to_torch, torch_one_thread)  # noqa: F401

STEPS_TOL = 1e-4
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


def _steps_agree(pair, n, tol=STEPS_TOL, lr=1e-3, **knobs):
    """``n`` steps in both packages from the same weights; each step's
    loss and grad norm within ``tol``.  Returns the largest rel."""
    kw = dict(total_steps=20, warmup_steps=2, **knobs)
    ref_step = jax.jit(ref_make_train_step(
        pair.ref, RefAdamWConfig(lr=lr), RefTrainStepConfig(**kw)))
    step = make_train_step(pair.port, AdamWConfig(lr=lr),
                           TrainStepConfig(**kw))
    q8 = kw.get("quantized_moments", False)
    rp = pair.ref_params
    ro = (ref_init_opt_q8 if q8 else ref_init_opt)(rp)
    p = pair.port.params()
    o = (init_opt_q8 if q8 else init_opt)(p)
    worst = 0.0
    for i in range(n):
        batch = numpy_batch(pair.cfg, B, S, seed=10 + i)
        rp, ro, rm = ref_step(rp, ro, to_jax(batch))
        p, o, m = step(p, o, to_torch(batch))
        assert sorted(m) == sorted(rm)
        assert all(not v.requires_grad for v in m.values())
        for key in ("loss", "grad_norm"):
            r = rel(rm[key], m[key])
            worst = max(worst, r)
            assert r <= tol, f"{pair.arch} {knobs} step {i} {key}: rel {r:.3g}"
    assert int(o.step) == n and type(o).__name__ == type(ro).__name__
    return worst


@pytest.mark.parametrize("arch", list_archs())
def test_three_steps_losses_match_reference(pairs, arch):
    _steps_agree(pairs(arch), 3, remat="none")


KNOBS = [dict(remat="none"), dict(remat="full"), dict(remat="dots"),
         dict(remat="none", microbatches=2),
         dict(remat="none", microbatches=2, accum_dtype="bfloat16"),
         dict(remat="none", compress_grads_bits=8),
         dict(remat="none", quantized_moments=True),
         dict(remat="full", microbatches=2, quantized_moments=True)]


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()))
def test_knobs_match_reference(pairs, knobs):
    _steps_agree(pairs("qwen2-0.5b"), 2, **knobs)
