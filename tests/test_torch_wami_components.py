"""The PyTorch WAMI application against the JAX package's: the 13
full-frame functions, Lucas-Kanade, the frame-stream driver, and the
synthesis models (CDFG facts and component specs).

Inputs come from seeded numpy and feed both packages.  Tolerance: the
reference's ``_close`` — max|Δ| / max(1, max|ref|) < 1e-5 — except
where a sum's order differs (Hessian, sd_update: 1e-4; the Gauss-Jordan
inverse and the LK parameters: 1e-4 after six chained float32 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps.wami.components as J
import repro.apps.wami.pipeline as JP
from repro.apps.wami.cdfg import analyze_kernel
import repro_torch.apps.wami.components as T
import repro_torch.apps.wami.pipeline as TP
from repro_torch.apps.wami.cdfg import WAMI_KERNEL_FACTS

N = 64


def _close(a, b, tol=1e-5):
    fa, fb = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert fa.shape == fb.shape
    scale = max(1.0, float(np.abs(fb).max()))
    assert float(np.abs(fa - fb).max()) / scale < tol


def _smooth_image(rng, n=N):
    """A smooth 0-100 image (box-blurred noise), like the reference's
    LK fixture: gradients are informative and the warp is well posed."""
    raw = rng.uniform(size=(n + 4, n + 4))
    k = np.ones(5) / 5.0
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 0, raw)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "valid"), 1, img)
    return (img * 100.0).astype(np.float32)


# shear small enough that every warp source fraction stays inside
# (0, 1): the floor() cell choice is then the same in both packages
P_AFFINE = np.array([1 / 1024, -1 / 2048, 0.5, 1 / 2048, -1 / 1024, 0.5],
                    np.float32)


def _args(name):
    rng = np.random.default_rng(5)
    f32 = np.float32
    gray = (rng.uniform(size=(N, N)) * 100.0).astype(f32)
    if name == "debayer":
        return ((rng.uniform(size=(N, N)) * 1023.0).astype(f32),)
    if name == "grayscale":
        return ((rng.uniform(size=(N, N, 3)) * 255.0).astype(f32),)
    if name == "gradient":
        return (gray,)
    if name == "steepest_descent":
        return (rng.standard_normal((N, N)).astype(f32),
                rng.standard_normal((N, N)).astype(f32))
    if name == "hessian":
        return (rng.standard_normal((N, N, 6)).astype(f32),)
    if name == "sd_update":
        return (rng.standard_normal((N, N, 6)).astype(f32),
                rng.standard_normal((N, N)).astype(f32))
    if name in ("matrix_add", "matrix_sub", "matrix_mul"):
        return (rng.standard_normal((6, 6)).astype(f32),
                rng.standard_normal((6, 6)).astype(f32))
    if name == "matrix_invert":
        return ((rng.standard_normal((6, 6)) + 6 * np.eye(6)).astype(f32),)
    if name == "warp_affine":
        return (gray, P_AFFINE)
    if name == "change_detection":
        mu = (gray[..., None]
              + rng.standard_normal((N, N, 3)) * 8.0).astype(f32)
        mu[:8, :8] += 200.0                 # a patch that matches nothing
        var = np.full((N, N, 3), 36.0, f32)
        w = rng.uniform(0.1, 1.0, size=(N, N, 3)).astype(f32)
        return (gray, mu, var, w / w.sum(-1, keepdims=True))
    raise KeyError(name)


TOL = {"hessian": 1e-4, "sd_update": 1e-4, "matrix_invert": 1e-4}
FUNCS = ["debayer", "grayscale", "gradient", "steepest_descent", "hessian",
         "sd_update", "matrix_add", "matrix_sub", "matrix_mul",
         "matrix_reshape", "matrix_invert", "warp_affine",
         "change_detection"]


@pytest.mark.parametrize("name", FUNCS)
def test_full_frame_function_matches_reference(name):
    if name == "matrix_reshape":
        a = np.arange(36, dtype=np.float32).reshape(6, 6)
        got = T.matrix_reshape(torch.from_numpy(a), (-1,))
        want = J.matrix_reshape(jnp.asarray(a), (-1,))
        _close(got.numpy(), want)
        return
    args = _args(name)
    got = getattr(T, name)(*(torch.from_numpy(a) for a in args))
    want = getattr(J, name)(*(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool:                 # the change-detection mask
            assert g.dtype == torch.bool
            assert np.array_equal(g.numpy(), w)
            assert 0 < w.sum() < w.size     # both outcomes exercised
        else:
            _close(g.numpy(), w, TOL.get(name, 1e-5))


def test_lucas_kanade_recovers_the_same_p():
    img = _smooth_image(np.random.default_rng(0))
    p_true = np.array([0.01, -0.005, 0.8, 0.004, 0.008, -0.5], np.float32)
    moved = np.array(J.warp_affine(jnp.asarray(img), jnp.asarray(p_true)))
    want = np.asarray(JP.lucas_kanade(jnp.asarray(moved), jnp.asarray(img),
                                      n_iters=30))
    got = TP.lucas_kanade(torch.from_numpy(moved), torch.from_numpy(img),
                          n_iters=30).numpy()
    assert float(np.abs(got - p_true).max()) < 1e-3
    _close(got, want, 1e-4)


def test_wami_app_gives_the_same_masks_and_p():
    rng = np.random.default_rng(1)
    base = _smooth_image(rng) * 10.0
    frames = np.stack([base, base, base.copy()])
    frames[2, 10:20, 10:20] += 1500.0
    masks_j, ps_j = JP.wami_app(jnp.asarray(frames), n_iters=4)
    masks_t, ps_t = TP.wami_app(frames, n_iters=4, device="cpu")
    assert masks_t.shape == (2, N, N) and masks_t.dtype == torch.bool
    _close(ps_t.numpy(), np.asarray(ps_j), 1e-4)
    assert np.array_equal(masks_t.numpy(), np.asarray(masks_j))
    assert float(masks_t[1, 10:20, 10:20].float().mean()) > 0.5


def test_wami_app_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.wami_app(np.zeros((2, 8, 8), np.float32))


@pytest.mark.parametrize("name", sorted(WAMI_KERNEL_FACTS))
def test_frozen_cdfg_facts_equal_live_analysis(name):
    comp = J.build_components()[name]
    live = analyze_kernel(comp.kernel, comp.kernel_args)
    frozen = WAMI_KERNEL_FACTS[name]
    assert (frozen.reads_per_input, frozen.writes, frozen.arith_ops,
            frozen.dep_depth, frozen.live_values) == (
        live.reads_per_input, live.writes, live.arith_ops, live.dep_depth,
        live.live_values)


@pytest.mark.parametrize("tile,frame", [(128, 512), (64, 512), (64, 128)])
def test_component_specs_equal_reference(tile, frame):
    ref = J.build_components(tile=tile, frame=frame)
    port = T.build_components(tile=tile, frame=frame)
    assert list(port) == list(ref)
    for name in ref:
        assert repr(port[name].spec()) == repr(ref[name].spec())
        assert repr(port[name].knobs) == repr(ref[name].knobs)


def test_wami_tmg_equals_reference():
    ref, port = JP.wami_tmg(), TP.wami_tmg()
    assert [t.name for t in port.transitions] == [
        t.name for t in ref.transitions]
    assert repr(port.places) == repr(ref.places)
    delays = {t.name: 1.0 + 0.1 * i for i, t in enumerate(ref.transitions)}
    assert port.throughput(delays) == ref.throughput(delays)
