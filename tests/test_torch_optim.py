"""The port's optimizers against the JAX package's on the same seeded
numpy params, grads and states: AdamW (float32 moments) and its 8-bit
variant, the global-norm clip, the decay mask's paths and the warmup
cosine schedule; and mirrors of ``tests/test_substrate.py``'s optimizer
tests and ``tests/test_autotune_hlo.py``'s three q8 tests.

Tolerance: parameters, moments, scales and the grad norm within 1e-6
relative (max|d| / max|ref|); int8 states byte-equal."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import apply_updates_q8 as ref_apply_updates_q8
from repro.optim import init_opt as ref_init_opt
from repro.optim import init_opt_q8 as ref_init_opt_q8
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.quantized import quantize_rows as ref_quantize_rows
from repro.utils import keystr_path as ref_keystr_path
from repro_torch.optim import (AdamWConfig, OptState, QuantOptState,
                               apply_updates, apply_updates_q8,
                               clip_by_global_norm, global_norm, init_opt,
                               init_opt_q8, warmup_cosine)
from repro_torch.optim import adamw as port_adamw
from repro_torch.optim.adamw import default_decay_mask
from repro_torch.optim.quantized import dequantize_rows, quantize_rows
from repro_torch.utils import leaves_with_paths, tree_map, unflatten_like
from torch_lm_reference import torch_one_thread  # noqa: F401  (autouse)

TOL = 1e-6


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max(initial=0.0)
                 / max(np.abs(ref).max(initial=0.0), 1e-30))


def _np_tree(seed, scale=1.0):
    """A parameter-shaped tree whose paths hit and miss the decay
    pattern: 0-d, 1-d, 2-d and stacked 3-d leaves."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": a(33, 8), "final_norm": {"scale": a(8)},
            "layers": {"attn": {"wq": a(2, 8, 12), "bq": a(2, 12)},
                       "mamba": {"A_log": a(2, 4), "D": a(2, 4),
                                 "dt_bias": a(2, 4)},
                       "mlp": {"w_up": a(2, 8, 16)}},
            "gate": a()}


def _torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(what, ref_tree, got_tree, tol=TOL):
    ref = dict((ref_keystr_path(kp), v) for kp, v in
               jax.tree_util.tree_flatten_with_path(ref_tree)[0])
    got = dict(leaves_with_paths(got_tree))
    assert sorted(ref) == sorted(got), what
    for path in ref:
        r = _rel(ref[path], got[path])
        assert r <= tol, f"{what} {path}: rel {r:.3g} > {tol}"


def _port_state(ref_state, params):
    """The reference's state carried into the port's NamedTuple."""
    leaves = iter(torch.from_numpy(np.array(x))
                  for x in jax.tree.leaves(ref_state))
    like = (init_opt_q8(params) if hasattr(ref_state, "mu_q")
            else init_opt(params))
    return unflatten_like(like, leaves)


CFGS = [dict(), dict(lr=1e-2, clip_norm=0.5, weight_decay=0.3),
        dict(lr=3e-3, clip_norm=100.0)]


@pytest.mark.parametrize("kw", CFGS, ids=["default", "clipped", "unclipped"])
@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_update_matches_reference_from_the_same_state(kw, q8):
    """Three steps, each taken by both packages from the reference's
    state: params, moments (int8 states byte-equal, scales) and the grad
    norm."""
    ref_cfg, cfg = RefAdamWConfig(**kw), AdamWConfig(**kw)
    pn = _np_tree(0)
    jp = _jax(pn)
    if q8:
        ref_fn = jax.jit(functools.partial(ref_apply_updates_q8, ref_cfg))
        ref_state = ref_init_opt_q8(jp)
    else:
        ref_fn = jax.jit(functools.partial(ref_apply_updates, ref_cfg))
        ref_state = ref_init_opt(jp)
    port_fn = apply_updates_q8 if q8 else apply_updates
    for i in range(3):
        gn = _np_tree(10 + i, scale=0.3 * (i + 1))
        lr_scale = np.float32(0.5 + 0.2 * i)
        params = _torch(jax.tree.map(np.asarray, jp))
        state = _port_state(ref_state, params)
        got_p, got_s, got_m = port_fn(cfg, params, _torch(gn), state,
                                      lr_scale=torch.tensor(lr_scale))
        jp, ref_state, ref_m = ref_fn(jp, _jax(gn), ref_state,
                                      lr_scale=jnp.asarray(lr_scale))
        assert got_p is params
        _assert_tree_close(f"step {i} params", jp, got_p)
        assert int(got_s.step) == int(ref_state.step) == i + 1
        r = _rel(ref_m["grad_norm"], got_m["grad_norm"])
        assert r <= TOL, f"grad_norm rel {r:.3g}"
        if q8:
            for name in ("mu_q", "nu_q"):
                for (kp, a), b in zip(
                        jax.tree_util.tree_flatten_with_path(
                            getattr(ref_state, name))[0],
                        jax.tree.leaves(getattr(got_s, name))):
                    assert b.dtype == torch.int8
                    assert np.array_equal(np.asarray(a), b.numpy()), (
                        name, ref_keystr_path(kp))
            _assert_tree_close("mu_s", ref_state.mu_s, got_s.mu_s)
            _assert_tree_close("nu_s", ref_state.nu_s, got_s.nu_s)
        else:
            _assert_tree_close("mu", ref_state.mu, got_s.mu)
            _assert_tree_close("nu", ref_state.nu, got_s.nu)


def test_update_in_row_blocks_equals_whole_leaves(monkeypatch):
    """A leaf updated a block of rows at a time gives the same values
    as whole (the f32 and the q8 update)."""
    pn, gn = _np_tree(3), _np_tree(4)
    cfg = AdamWConfig(lr=1e-2)
    outs = []
    for block in (port_adamw.BLOCK_ELEMS, 16):
        monkeypatch.setattr(port_adamw, "BLOCK_ELEMS", block)
        for fn, init in ((apply_updates, init_opt),
                         (apply_updates_q8, init_opt_q8)):
            p = _torch(pn)
            s = init(p)
            for _ in range(2):
                p, s, m = fn(cfg, p, _torch(gn), s)
            outs.append([t.clone() for t in jax.tree.leaves((p, s))])
    whole, blocks = outs[:2], outs[2:]
    for a_run, b_run in zip(whole, blocks):
        for a, b in zip(a_run, b_run):
            if a.dtype == torch.int8:
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_update_from_bf16_grads_and_params():
    """``grads`` of any dtype: bf16 grads into f32 params match the
    reference's; bf16 params stay bf16, each within a bf16 rounding of
    the reference's."""
    import ml_dtypes
    pn, gn = _np_tree(5), _np_tree(6)
    gb = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16), gn)
    cfg = RefAdamWConfig(lr=1e-2)
    ref_p, ref_s, _ = jax.jit(functools.partial(ref_apply_updates, cfg))(
        _jax(pn), _jax(gb), ref_init_opt(_jax(pn)))
    tg = tree_map(lambda x: torch.from_numpy(
        np.array(x).view(np.int16)).view(torch.bfloat16), gb)
    p = _torch(pn)
    p, s, _ = apply_updates(AdamWConfig(lr=1e-2), p, tg, init_opt(p))
    _assert_tree_close("params", ref_p, p)
    _assert_tree_close("mu", ref_s.mu, s.mu)
    # bf16 parameters
    pb = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16), pn)
    ref_p, _, _ = jax.jit(functools.partial(ref_apply_updates, cfg))(
        _jax(pb), _jax(gn), ref_init_opt(_jax(pb)))
    p = tree_map(lambda x: torch.from_numpy(
        np.array(x).view(np.int16)).view(torch.bfloat16), pb)
    p, _, _ = apply_updates(AdamWConfig(lr=1e-2), p, _torch(gn), init_opt(p))
    for (kp, a), b in zip(jax.tree_util.tree_flatten_with_path(ref_p)[0],
                          jax.tree.leaves(p)):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a, np.float32)
        d = np.abs(a - b.float().numpy())
        assert np.all(d <= 2.0 ** -8 * np.abs(a) + 1e-30), ref_keystr_path(kp)


def test_decay_mask_paths_match_the_reference():
    """Every reduced arch: the port's decayed paths are the reference's
    (its ``keystr_path`` over its parameter tree, its pattern)."""
    from repro.configs import get_config as ref_get_config
    from repro.configs import list_archs
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import params_specs
    pat = re.compile(RefAdamWConfig().no_decay_pattern)
    cfg = AdamWConfig()
    for arch in list_archs():
        shapes = jax.eval_shape(
            ref_build_model(ref_get_config(arch).reduced()).init,
            jax.random.PRNGKey(0))
        want = {ref_keystr_path(kp): 0.0 if pat.search(
            ref_keystr_path(kp)) else 1.0 for kp, _ in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
        got = dict(leaves_with_paths(default_decay_mask(
            cfg, params_specs(get_config(arch).reduced()))))
        assert got == want, arch
        assert 0.0 in got.values() and 1.0 in got.values(), arch


def test_warmup_cosine_matches_reference_at_many_steps():
    for warmup, total, floor in ((10, 100, 0.1), (1, 40, 0.0),
                                 (100, 10000, 0.1), (5, 5, 0.2)):
        steps = np.arange(0, total + 20, dtype=np.int32)
        want = np.asarray(jax.jit(functools.partial(
            ref_warmup_cosine, warmup=warmup, total=total, floor=floor))(
            jnp.asarray(steps)))
        got = warmup_cosine(torch.from_numpy(steps), warmup=warmup,
                            total=total, floor=floor)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-7)
        for s in (0, warmup, total):    # Python ints too
            assert float(warmup_cosine(s, warmup=warmup, total=total,
                                       floor=floor)) == pytest.approx(
                float(ref_warmup_cosine(s, warmup=warmup, total=total,
                                        floor=floor)), rel=TOL)


def test_quantize_rows_matches_reference():
    rng = np.random.default_rng(7)
    for shape in ((), (5,), (3, 7), (2, 3, 64)):
        x = np.asarray(rng.standard_normal(shape) * 3, np.float32)
        if len(shape) == 2:
            x[1] = 0.0                  # an all-zero row: the 1e-20 floor
        q, s = ref_quantize_rows(jnp.asarray(x))
        tq, ts = quantize_rows(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and tq.shape == x.shape
        assert np.array_equal(np.asarray(q), tq.numpy())
        assert _rel(s, ts) <= TOL
        back = dequantize_rows(tq, ts)
        assert back.shape == x.shape
    # round half to even, as jnp.round
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5]])
    q, _ = quantize_rows(x)
    assert q.tolist() == [[127, 0, 2, 2, 0]]


# ----------------------------------------------------------------------
# mirrors of tests/test_substrate.py
# ----------------------------------------------------------------------
def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "scale": torch.tensor([2.0])}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=10.0)
    state = init_opt(params)
    for _ in range(200):
        g = {"w": 2 * params["w"], "scale": 2 * (params["scale"] - 1.0)}
        params, state, m = apply_updates(cfg, params, g, state)
    assert float(params["w"].abs().max()) < 1e-2
    assert float((params["scale"] - 1.0).abs().max()) < 1e-2
    assert isinstance(state, OptState) and int(state.step) == 200


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert clipped["a"].dtype == torch.float32


def test_warmup_cosine_shape():
    assert float(warmup_cosine(0, warmup=10, total=100)) == pytest.approx(0.0)
    assert float(warmup_cosine(10, warmup=10, total=100)) == pytest.approx(1.0)
    assert float(warmup_cosine(100, warmup=10, total=100)) == pytest.approx(0.1)


# ----------------------------------------------------------------------
# mirrors of tests/test_autotune_hlo.py's 8-bit moment tests
# ----------------------------------------------------------------------
def test_q8_matches_fp32_trajectory():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    p32 = {"w": torch.tensor([[3.0, -2.0, 1.0, 4.0]] * 2)}
    pq8 = {"w": p32["w"].clone()}
    s32, sq8 = init_opt(p32), init_opt_q8(pq8)
    for _ in range(100):
        p32, s32, _ = apply_updates(cfg, p32, {"w": 2 * p32["w"]}, s32)
        pq8, sq8, _ = apply_updates_q8(cfg, pq8, {"w": 2 * pq8["w"]}, sq8)
    assert float(p32["w"].abs().max()) < 0.05
    assert float(pq8["w"].abs().max()) < 0.05
    assert isinstance(sq8, QuantOptState)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in jax.tree.leaves(tree))


def test_q8_state_is_4x_smaller():
    params = {"w": torch.zeros((1024, 1024), dtype=torch.bfloat16)}
    assert _nbytes(init_opt(params)) / _nbytes(init_opt_q8(params)) > 3.9


def test_q8_trains_real_lm():
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import TrainStepConfig, make_train_step
    cfg = get_config("qwen2-0.5b").reduced()
    model = build_model(cfg, "cpu")
    params = model.params()
    step = make_train_step(model, AdamWConfig(lr=1e-3),
                           TrainStepConfig(remat="none",
                                           quantized_moments=True,
                                           total_steps=40))
    opt = init_opt_q8(params)
    src = SyntheticLM(vocab=cfg.vocab, seed=5)
    losses = []
    for i in range(30):
        b = src.batch(step=i, shard=0, n_shards=1, batch=8, seq=32)
        params, opt, m = step(params, opt,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.02
