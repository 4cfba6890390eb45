"""The chunked SSD's backward: the plain mirror of ``csrc/ssd_scan_bwd.cu``
(``ssd_chunked_bwd_ref``) against ``torch.autograd`` of the model's plain
body in float64 on the CPU, the route in ``models/ssm.py::_ssd_local``
and ``ssd_train``'s choice of plan, the launch plan, its C limits and the
binding; on the card (marked ``card``, skipped without one) the kernel
route against autograd of the plain body, a prefill's forward alone, and
one training step of the benchmark's Mamba2-780M cell.

Run the card tests on a card with
``python -m pytest tests/test_torch_ssd_backward.py -m card``.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.build import CSRC_DIR, SOURCES
from repro_torch.kernels.route import route_counts
from repro_torch.kernels.ssd_scan import (pad_to_chunks, ssd_bwd_smem_bytes,
                                          ssd_bwd_scratch_floats,
                                          ssd_chunked_bwd_ref, ssd_grad_plan,
                                          ssd_scan_bwd_kernel,
                                          ssd_scan_cuda, ssd_scan_kernel)
from repro_torch.kernels.ssd_scan import grad as ssd_grad
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models import ssm

H100_SMS, H100_SMEM_OPTIN = 132, 232448
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _counts():
    """The SSD's route on the card: the forward's and the backward's
    launches and the calls that took the plain body."""
    c = route_counts()
    return c["ssd_scan.launches"], c["ssd_scan_bwd.launches"], c["ssd.plain"]


def _inputs(Bz, S, H, P, N, seed=0, dtype=torch.float64, device="cpu"):
    """x, dt, A, B, C as the SSD tests draw them, then dy and dh_final."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((Bz, S, H, P)),
            np.logaddexp(0.0, rng.standard_normal((Bz, S, H)) * 0.5),
            -np.exp(rng.standard_normal((H,)) * 0.3),
            rng.standard_normal((Bz, S, N)) * 0.3,
            rng.standard_normal((Bz, S, N)) * 0.3,
            rng.standard_normal((Bz, S, H, P)),
            rng.standard_normal((Bz, H, P, N)))
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrs]


def _plain_grads(x, dt, A, B, C, dy, dh, chunk):
    """(y, h_final, dx, ddt, dA, dB, dC) by autograd of the plain body."""
    ins = [t.detach().clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, h = ssm._ssd_plain(*ins, chunk, None)
    loss = (y * dy).sum() + ((h * dh).sum() if dh is not None else 0.0)
    return (y.detach(), h.detach()) + torch.autograd.grad(loss, ins)


def _assert_close(what, got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        scale = max(1.0, float(w.abs().max()))
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * scale, (f"{what} {name}: max|d| {err:.3g} "
                                    f"against {tol * scale:.3g}")


# ----------------------------------------------------------------------
# the plain mirror of the backward kernel, on the CPU in float64
# ----------------------------------------------------------------------
# (Bz, S, H, P, N, the model's chunk, the kernel's sub-chunk): several
# chunks and sub-chunks, one chunk alone, sub-chunks off the 16-row grid
MIRROR_CASES = [(2, 48, 3, 4, 5, 48, 16), (2, 48, 3, 4, 5, 16, 8),
                (1, 64, 2, 8, 16, 64, 64), (2, 96, 2, 4, 8, 32, 32),
                (2, 48, 3, 4, 5, 48, 12), (1, 40, 2, 3, 7, 40, 10)]


@pytest.mark.parametrize("with_dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_backward_mirror_matches_autograd_of_the_plain_body(case, with_dh):
    """The kernel's passes (chunk pass, reverse state pass, per-chunk
    pass, the reverse cumulative sum for ddt and dA) at the sub-chunk
    give the gradient of the plain body at the model's chunk: the two
    differ by float64 rounding alone."""
    Bz, S, H, P, N, chunk, sub = case
    x, dt, A, B, C, dy, dh = _inputs(Bz, S, H, P, N)
    dh = dh if with_dh else None
    want = _plain_grads(x, dt, A, B, C, dy, dh, chunk)[2:]
    got = ssd_chunked_bwd_ref(x, dt, A, B, C, dy, dh, chunk=sub)
    _assert_close(f"mirror {case}", got, want, 1e-12)


@pytest.mark.parametrize("with_dh", [False, True], ids=["no_dh", "dh"])
@pytest.mark.parametrize("S,chunk", [(37, 16), (50, 64), (70, 32)])
def test_backward_mirror_over_the_routes_padding(S, chunk, with_dh):
    """An S the chunk does not divide: the route pads x, dt, B and C with
    zeros to whole chunks (``pad_to_chunks``) and cuts y back; the
    mirror over the padded inputs, with dy 0 on the padded rows, gives
    the plain body's gradient at the unpadded S."""
    x, dt, A, B, C, dy, dh = _inputs(2, S, 3, 4, 6, seed=1)
    dh = dh if with_dh else None
    want = _plain_grads(x, dt, A, B, C, dy, dh, chunk)[2:]
    q = min(chunk, S)
    xp, dtp, Bp, Cp = pad_to_chunks(q, x, dt, B, C)
    (dyp,) = pad_to_chunks(q, dy, dt, B, C)[:1]
    assert xp.shape[1] % q == 0 and xp.shape[1] - S < q
    dx, ddt, dA, dB, dC = ssd_chunked_bwd_ref(xp, dtp, A, Bp, Cp, dyp, dh,
                                              chunk=q)
    got = (dx[:, :S], ddt[:, :S], dA, dB[:, :S], dC[:, :S])
    _assert_close(f"padded S {S} chunk {chunk}", got, want, 1e-12)


# ----------------------------------------------------------------------
# the route: the plain body on the CPU, nothing counted on the card's
# counters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True], ids=["no_h0", "h0"])
def test_route_takes_the_plain_body_on_the_cpu(with_h0):
    x, dt, A, B, C, _, h0 = _inputs(2, 40, 3, 4, 5, seed=2,
                                    dtype=torch.float32)
    h0 = h0 if with_h0 else None
    before = route_counts()
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, h = ssm._ssd_chunked(*ins, 16, h0)
    g = torch.autograd.grad((y.sum() + h.sum()), ins)
    want_y, want_h = ssm._ssd_plain(x, dt, A, B, C, 16, h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert all(bool(torch.isfinite(t).all()) for t in g)
    assert route_counts() == before


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad",
                                  "grad"])
def test_train_call_runs_the_forward_alone_where_no_gradient_is_asked(
        monkeypatch, mode):
    """``ssd_train`` (stubbed launches: this host has no card) runs the
    forward alone at its own plan where no gradient will be asked for (a
    prefill under ``no_grad``, or inputs that require none), and the
    autograd Function at the grad plan otherwise; both over the inputs
    padded to whole chunks, y cut back to S."""
    taken = []

    def forward_alone(x, dt, A, B, C, *, chunk):
        taken.append(("forward", x.shape[1], chunk))
        return x * 2, x.new_zeros(x.shape[0], x.shape[2], x.shape[3],
                                  B.shape[-1])

    def with_grad(x, dt, A, B, C, plan):
        taken.append(("grad", x.shape[1], plan))
        return x * 2, x.new_zeros(x.shape[0], x.shape[2], x.shape[3],
                                  B.shape[-1])
    monkeypatch.setattr(ssd_grad, "ssd_scan_cuda", forward_alone)
    monkeypatch.setattr(ssd_grad._SsdScan, "apply", with_grad)
    monkeypatch.setattr(ssd_grad, "_card",
                        lambda dev: (H100_SMS, H100_SMEM_OPTIN))
    x, dt, A, B, C = _inputs(2, 40, 3, 4, 5, seed=4,
                             dtype=torch.float32)[:5]
    if mode != "no_input_requires_grad":
        x.requires_grad_()
    with torch.set_grad_enabled(mode != "no_grad"):
        y, h = ssd_grad.ssd_train(x, dt, A, B, C, chunk=16)
    assert y.shape == x.shape and torch.equal(y, x.detach() * 2)
    assert h.shape == (2, 3, 4, 5)
    if mode == "grad":
        assert taken == [("grad", 48, ssd_grad_plan(
            2, 48, 3, 4, 5, 16, H100_SMS, H100_SMEM_OPTIN))]
    else:
        assert taken == [("forward", 48, 16)]


# ----------------------------------------------------------------------
# the plan and the binding
# ----------------------------------------------------------------------
def test_plan_mirrors_the_c_limits():
    """The Python plan's copies of the C limits (the chunk count up to
    which the forward walks the states; the backward's largest padded
    chunk) equal the constants the sources define."""
    with open(os.path.join(CSRC_DIR, "ssd_common.cuh")) as f:
        common = f.read()
    with open(os.path.join(CSRC_DIR, "ssd_scan_bwd.cu")) as f:
        bwd = f.read()
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            common).group(1))
    walk = int(re.search(r"constexpr int kWalkChunks = (\d+);",
                         common).group(1))
    assert re.search(r"constexpr int kMaxQp = kThreads / 2;", bwd)
    assert (ssd_kernel._WALK_CHUNKS, ssd_kernel._BWD_MAX_QP) == (
        walk, threads // 2)
    assert ssd_kernel._WARPS == threads // 32
    for name in ("ssd_scan.cu", "ssd_scan_bwd.cu"):
        with open(os.path.join(CSRC_DIR, name)) as f:
            assert '#include "ssd_common.cuh"' in f.read()
    from repro_torch.kernels import build
    assert "ssd_common.cuh" in build._HEADERS


@pytest.mark.parametrize("shape,chunk,run,hpc,walk", [
    # the benchmark's cell: one mamba2-780m layer, 20 rows of 2,048
    ((20, 2048, 48, 64, 128), 256, 64, 4, False),
    # zamba2-2.7b's SSD: the forward alone runs 2 x 128, both 4 x 64
    ((4, 512, 80, 64, 64), 256, 64, 4, True),
    ((4, 2048, 80, 64, 64), 256, 64, 4, False),
    # chip_smoke's reduced archs (H 8, P 16, N 16, chunk 32 clipped to S)
    ((4, 16, 8, 16, 16), 16, 16, 1, False),
    ((2, 64, 8, 16, 16), 32, 32, 1, True),
], ids=["mamba2-cell", "zamba2-512", "zamba2-2048", "reduced-16",
        "reduced-64"])
def test_grad_plan_runs_both_passes_at_one_chunk(shape, chunk, run, hpc,
                                                 walk):
    Bz, S, H, P, N = shape
    plan = ssd_grad_plan(Bz, S, H, P, N, chunk, H100_SMS, H100_SMEM_OPTIN)
    assert (plan.fwd.chunk, plan.heads_per_cta, plan.walk) == (run, hpc,
                                                               walk)
    assert plan.fwd.smem <= H100_SMEM_OPTIN
    assert ssd_bwd_smem_bytes(plan.fwd.chunk, P, N) <= H100_SMEM_OPTIN


def test_backward_staging_and_scratch():
    """The per-chunk pass stages 193,568 B at the cell's chunk 64 (a CTA
    an SM); at chunk 128 and N 64 it would need 337 KB, so zamba2's
    backward halves the forward's sub-chunk.  The scratch at the cell:
    g (1.0 GB), 64 partial dots a (batch, chunk, head), the dB and dC
    partials over 12 groups of heads, the dA partials."""
    assert ssd_bwd_smem_bytes(64, 64, 128) == 193568
    assert ssd_bwd_smem_bytes(128, 64, 64) > H100_SMEM_OPTIN
    states = 20 * 32 * 48 * 64 * 128
    assert ssd_bwd_scratch_floats(20, 2048, 48, 64, 128, 64, 4, False) == (
        states + 20 * 32 * 48 * 64 + 2 * 20 * 2048 * 12 * 128
        + 20 * 32 * 48)
    assert ssd_bwd_scratch_floats(2, 64, 2, 3, 5, 16, 1, True) == (
        2 * 2 * 4 * 2 * 15 + 2 * 4 * 2 * 8 + 2 * 2 * 64 * 2 * 5 + 2 * 4 * 2)


def test_grad_plan_raises_where_no_chunk_stages():
    with pytest.raises(ValueError):
        ssd_grad_plan(1, 256, 2, 256, 512, 256, H100_SMS, H100_SMEM_OPTIN)


def test_backward_binding_matches_the_c_entry_point():
    """One argtype per parameter of the exported C function (the source
    is parsed; it cannot be compiled here)."""
    kernel = ssd_scan_bwd_kernel
    assert kernel.library in SOURCES
    with open(os.path.join(CSRC_DIR, f"{kernel.library}.cu")) as f:
        src = f.read()
    m = re.search(r"KERNEL_EXPORT int " + kernel.symbol + r"\(([^)]*)\)",
                  src)
    assert m, f"{kernel.symbol} not exported by {kernel.library}.cu"
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in params]
    assert kernel.argtypes == want


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (Bz, S, H, P, N, the model's chunk): one layer of the benchmark's cell;
# zamba2-2.7b's SSD (N 64, chunk 256) at its training and served shapes
# (a prefill of 136 tokens runs 2 x 68); chip_smoke.py's reduced archs
# (H 8, P 16, N 16, chunk 32) at the training and serving lengths
CARD_CASES = [(20, 2048, 48, 64, 128, 256), (4, 512, 80, 64, 64, 256),
              (4, 136, 80, 64, 64, 256), (4, 16, 8, 16, 16, 32),
              (2, 64, 8, 16, 16, 32), (2, 37, 8, 16, 16, 32)]


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_kernel_route_matches_autograd_of_the_plain_body(case):
    """The kernels' y, h_final and gradients against autograd of the
    plain body in float64 (at chunk 64 where the model's is larger: the
    same function, less memory), within 1e-4 x max(1, max|ref|): the
    3xTF32 products keep float32 accuracy (1-10e-6 measured on the
    H100, the plain body's own float32 gradients 0.1-2.3e-5), and the
    forward's tolerance is the same; dh_final given."""
    dev = _card()
    Bz, S, H, P, N, chunk = case
    f32 = _inputs(Bz, S, H, P, N, seed=3, dtype=torch.float32, device=dev)
    x, dt, A, B, C, dy, dh = f32
    before = (ssd_scan_kernel.launches, ssd_scan_bwd_kernel.launches)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, h = ssm._ssd_chunked(*ins, chunk, None)
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    torch.cuda.synchronize()
    assert (ssd_scan_kernel.launches - before[0],
            ssd_scan_bwd_kernel.launches - before[1]) == (1, 1)
    ref = _plain_grads(*(t.double() for t in f32), min(chunk, 64))
    _assert_close(f"{case} outputs", (y, h), ref[:2], 1e-4)
    _assert_close(f"{case} gradients", got, ref[2:], 1e-4)
    again = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip(
            ssm._ssd_chunked(*ins, chunk, None), (dy, dh))), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "two runs of one input differ"


@pytest.mark.card
@pytest.mark.parametrize("case", [(4, 136, 80, 64, 64, 256),
                                  (4, 512, 80, 64, 64, 256),
                                  (2, 37, 8, 16, 16, 32)],
                         ids=lambda c: "x".join(map(str, c)))
def test_prefill_route_runs_the_forward_alone(case):
    """Under ``no_grad`` (a prefill) the route launches the forward alone,
    at its own plan (2 x 128 at zamba2's N 64), bit for bit the forward
    kernel's call on the padded inputs, within 1e-4 x max(1, max|ref|)
    of the plain body in float64."""
    dev = _card()
    Bz, S, H, P, N, chunk = case
    x, dt, A, B, C = _inputs(Bz, S, H, P, N, seed=5, dtype=torch.float32,
                             device=dev)[:5]
    before = _counts()
    with torch.no_grad():
        y, h = ssm._ssd_chunked(x, dt, A, B, C, chunk, None)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    q = min(chunk, S)
    padded = [t.contiguous() for t in pad_to_chunks(q, x, dt, B, C)]
    want_y, want_h = ssd_scan_cuda(padded[0], padded[1], A, padded[2],
                                   padded[3], chunk=q)
    assert torch.equal(y, want_y[:, :S]) and torch.equal(h, want_h)
    ref = ssm._ssd_plain(*(t.double() for t in (x, dt, A, B, C)),
                         min(chunk, 64), None)
    _assert_close(f"{case} outputs", (y, h), ref, 1e-4)


@pytest.mark.card
def test_one_training_step_of_the_cell_launches_the_kernels():
    """Mamba2-780M at full width, 20 rows of 2,048 tokens, remat full,
    AdamW: 48 layers, each forward and recompute through the forward
    kernel (96) and backward through the backward kernel (48); no call
    takes the plain body on the card."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.train import TrainStepConfig, make_train_step
    cfg = get_config("mamba2-780m")
    model = build_model(cfg, dev, generator=torch.Generator(dev)
                        .manual_seed(0))
    params = model.params()
    opt = init_opt(params)
    step = make_train_step(model, AdamWConfig(), TrainStepConfig(remat="full"))
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(1, cfg.vocab, (20, 2049))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": rows[:, :-1].contiguous(),
             "targets": rows[:, 1:].contiguous(),
             "mask": torch.ones((20, 2048), dtype=torch.float32, device=dev)}
    before = _counts()
    params, opt, m = step(params, opt, batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (96, 48, 0)
    assert bool(torch.isfinite(m["loss"]))
    del model, params, opt, step
    torch.cuda.empty_cache()
