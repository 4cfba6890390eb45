"""The Mamba2 mixer's epilogue (D skip, SiLU gate, gated RMSNorm): the
plain mirror of ``csrc/mamba_gate_norm.cu``'s backward
(``gate_norm_bwd_ref``) against ``torch.autograd`` of the model's plain
lines in float64 on the CPU, the route in ``models/ssm.py::_gate_norm``,
the checks before a launch and the binding; on the card
(marked ``card``, skipped without one) the kernels against the plain
chain in float32, the model's strided views, two runs bit for bit, a
prefill's forward alone and one training step of the benchmark's
Mamba2-780M cell.

Run the card tests on a card with
``python -m pytest tests/test_torch_gate_norm.py -m card``.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CSRC_DIR, SOURCES
from repro_torch.kernels.mamba_gate_norm import (
    gate_norm_aligned, gate_norm_bwd_kernel, gate_norm_bwd_ref,
    gate_norm_bwd_scratch_floats, gate_norm_kernel, gate_norm_operand,
    gate_norm_ref)
from repro_torch.kernels.mamba_gate_norm import grad as gn_grad
from repro_torch.kernels.mamba_gate_norm import kernel as gn_kernel
from repro_torch.kernels import route as routing
from repro_torch.kernels.route import route_counts
from repro_torch.models import blocks, ssm

GRAD_NAMES = ("dy", "dxh", "dz", "dD", "dscale")
EPS = 1e-5


def _counts():
    """The epilogue's route on the card: the forward's and the backward's
    launches and the calls that took the plain lines."""
    c = route_counts()
    return (c["gate_norm.launches"], c["gate_norm_bwd.launches"],
            c["gate_norm.plain"])


def _inputs(Bz, S, H, P, seed=0, dtype=torch.float64, device="cpu",
            model_dtype=None, N=8):
    """y (float32 values), xh and z as the model's views (xh of the conv's
    output beside B and C, z of in_proj's output beside xbc and dt), D,
    scale and dout, drawn in float32 from seeded numpy and held in
    ``dtype`` (y, D) and ``model_dtype`` (the rest; ``dtype`` if None)."""
    md = dtype if model_dtype is None else model_dtype
    W = H * P
    rng = np.random.default_rng(seed)

    def draw(shape, s=1.0):
        return torch.tensor((rng.standard_normal(shape) * s)
                            .astype(np.float32), device=device)
    y = draw((Bz, S, H, P)).to(dtype)
    xbc = draw((Bz, S, W + 2 * N)).to(md)
    proj = draw((Bz, S, 2 * W + 2 * N + H), 2.0).to(md)
    xh = xbc[..., :W].reshape(Bz, S, H, P)
    z = proj[..., :W]
    D = (1 + draw((H,), 0.3)).to(dtype)
    scale = draw((W,), 0.2).to(md)
    dout = draw((Bz, S, W)).to(md)
    return y, xh, z, D, scale, dout


def _chain(y, xh, z, D, scale, eps):
    """The model's lines op for op, in the inputs' precision throughout:
    no rounding on the way."""
    Bz, S, H, P = y.shape
    v = (y + D[None, None, :, None] * xh).reshape(Bz, S, H * P)
    g = v * F.silu(z)
    return g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps) * (
        1 + scale)


def _autograd(fn, y, xh, z, D, scale, dout):
    ins = [t.detach().clone().requires_grad_() for t in (y, xh, z, D, scale)]
    out = fn(*ins)
    return (out.detach(),) + torch.autograd.grad(out, ins, dout)


def _assert_close(what, got, want, tol, names=GRAD_NAMES):
    for name, g, w in zip(names, got, want):
        scale = float(w.double().abs().max())
        err = float((g.detach().double() - w.double()).abs().max())
        assert err <= tol * scale, (f"{what} {name}: max|d| {err:.3g} "
                                    f"against {tol * scale:.3g}")


# ----------------------------------------------------------------------
# the plain mirror of the backward kernel, on the CPU in float64
# ----------------------------------------------------------------------
# (Bz, S, H, P): one row of mamba2-780m's and of zamba2-2.7b's layer
# (H 48 and 80, P 64) over a few tokens; a ragged row count at narrow
# heads
MIRROR_CASES = [(1, 3, 48, 64), (1, 2, 80, 64), (3, 7, 3, 16)]


@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_backward_mirror_matches_autograd_of_the_chain_in_float64(case):
    """The kernel's backward formulas (dg = r (dn - n mean(dn n)), the
    gate's and the skip's terms, the parameters' sums) are the gradient
    of the chain: the two differ by float64 rounding alone; so does the
    forward mirror."""
    x = _inputs(*case, seed=1)
    want = _autograd(lambda *a: _chain(*a, EPS), *x)
    assert float(want[0].abs().max()) > 0.5
    got = gate_norm_bwd_ref(*x[:3], x[5], *x[3:5], EPS)
    _assert_close(f"mirror {case}", got, want[1:], 1e-12)
    _assert_close(f"mirror {case}", (gate_norm_ref(*x[:5], EPS),),
                  want[:1], 1e-12, ("out",))


@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_backward_mirror_matches_autograd_of_the_models_plain_lines(case):
    """Against autograd of the model's own lines (``_gate_norm_plain``)
    on float64 inputs that float32 holds exactly: those lines take the
    norm in float32 (``apply_norm`` upcasts with ``.float()``), so the
    two differ by float32 rounding, within 1e-6 of each output's max."""
    x = _inputs(*case, seed=2)
    want = _autograd(lambda *a: ssm._gate_norm_plain(*a, EPS,
                                                     torch.float64), *x)
    got = gate_norm_bwd_ref(*x[:3], x[5], *x[3:5], EPS)
    _assert_close(f"plain lines {case}", got, want[1:], 1e-6)
    _assert_close(f"plain lines {case}", (gate_norm_ref(*x[:5], EPS),),
                  want[:1], 1e-6, ("out",))


# ----------------------------------------------------------------------
# the route: the plain lines on the CPU, nothing counted
# ----------------------------------------------------------------------
def _old_lines(y, xh, z, D, scale, eps, dtype):
    """``mamba_sequence``'s epilogue as it was written inline."""
    B, S, H, P = xh.shape
    y = y + D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, H * P).to(dtype)
    y = y * F.silu(z)
    return blocks.apply_norm({"scale": scale}, y, "rmsnorm", eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_route_takes_the_plain_lines_on_the_cpu(dtype):
    x = _inputs(2, 5, 4, 16, seed=3, dtype=torch.float32, model_dtype=dtype)
    before = route_counts()
    want = _autograd(lambda *a: _old_lines(*a, EPS, dtype), *x)
    got = _autograd(lambda *a: ssm._gate_norm(*a, EPS, dtype), *x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert route_counts() == before


def test_mamba_sequence_on_the_cpu_counts_nothing():
    """A reduced Mamba2 layer forward and backward on the CPU: the SSD's
    and the epilogue's plain bodies, no launch, no call on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-780m").reduced()
    model = build_model(cfg, torch.device("cpu"),
                        generator=torch.Generator().manual_seed(0))
    lp = blocks.layer_params(model.params()["layers"], 0)["mamba"]
    lp = {k: v.detach().float().requires_grad_() for k, v in lp.items()}
    u = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    before = route_counts()
    out, _ = ssm.mamba_sequence(lp, cfg, u)
    grads = torch.autograd.grad(out.square().sum(), [u] + list(lp.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert route_counts() == before


def _card_fakes(dtype, P, H=4, D_dtype=torch.float32, scale_dtype=None):
    """The epilogue's operands as fakes on the card's device (a trace's
    FakeTensorMode must be active)."""
    return (torch.empty(2, 5, H, P, device="cuda"),
            torch.empty(2, 5, H, P, device="cuda", dtype=dtype),
            torch.empty(2, 5, H * P, device="cuda", dtype=dtype),
            torch.empty(H, device="cuda", dtype=D_dtype),
            torch.empty(H * P, device="cuda", dtype=scale_dtype or dtype))


@pytest.mark.parametrize("dtype,dtensor,route", [
    (torch.bfloat16, False, "kernel"), (torch.float32, False, "kernel"),
    (torch.bfloat16, True, "plain")], ids=["bf16", "f32", "dtensor"])
def test_route_on_card_tensors(monkeypatch, dtype, dtensor, route):
    """Tensors on the card (fakes passed off as real here) take the
    kernels; DTensors on the card the plain lines; each call counts once,
    in ``gate_norm.kernel`` or ``gate_norm.plain``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(routing, "on_card", lambda t: True)
    monkeypatch.setattr(ssm, "is_dtensor", lambda t: dtensor)
    monkeypatch.setattr(ssm, "gate_norm", lambda *args: "kernel")
    monkeypatch.setattr(ssm, "_gate_norm_plain", lambda *args: "plain")
    before = route_counts()
    with FakeTensorMode():
        x = _card_fakes(dtype, 16)
        assert ssm._gate_norm(*x, EPS, dtype) == route
    after = route_counts()
    assert (after["gate_norm.kernel"] - before["gate_norm.kernel"],
            after["gate_norm.plain"] - before["gate_norm.plain"]) == (
        (route == "kernel"), (route == "plain"))


# operands the kernels refuse, and the words of the ValueError: the
# dtypes, then the heads, which the C library judges (its answer stubbed
# here: 0 floats for P 12)
REFUSED = [
    (dict(dtype=torch.float16, P=16), "bf16 or float32"),
    (dict(dtype=torch.float64, P=16), "bf16 or float32"),
    (dict(dtype=torch.bfloat16, P=16, D_dtype=torch.bfloat16), "D:"),
    (dict(dtype=torch.bfloat16, P=16, scale_dtype=torch.float32),
     "scale:"),
    (dict(dtype=torch.bfloat16, P=12), "P=12"),
]


@pytest.mark.parametrize("case,words", REFUSED,
                         ids=["f16", "f64", "D-bf16", "scale-f32", "P12"])
def test_route_raises_for_card_tensors_the_kernels_refuse(
        monkeypatch, case, words):
    """A card call the kernels cannot take raises ``ValueError`` before
    any launch, in place of running the plain lines on the card; nothing
    is counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(routing, "on_card", lambda t: True)
    monkeypatch.setattr(gn_kernel, "gate_norm_bwd_scratch_floats",
                        lambda H, P, dtype, dev: 0 if P % 8 else 1 << 20)
    before = route_counts()
    with FakeTensorMode():
        x = _card_fakes(**case)
        with pytest.raises(ValueError, match=re.escape(words)):
            ssm._gate_norm(*x, EPS, case["dtype"])
    assert route_counts() == before


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad",
                                  "grad"])
def test_call_runs_the_forward_alone_where_no_gradient_is_asked(
        monkeypatch, mode):
    """``gate_norm`` (stubbed launches: this host has no card) runs the
    forward alone, saving no r, where no gradient will be asked for (a
    prefill under ``no_grad``, or inputs that require none), and the
    autograd Function otherwise."""
    taken = []

    def forward_alone(y, xh, z, D, scale, eps, *, save_rstd):
        taken.append(("forward", save_rstd))
        return "out", None
    monkeypatch.setattr(gn_grad, "gate_norm_fwd_cuda", forward_alone)
    monkeypatch.setattr(gn_grad._GateNorm, "apply",
                        lambda *args: taken.append(("grad",)) or "out")
    y, xh, z, D, scale, _ = _inputs(1, 3, 2, 8, seed=4, dtype=torch.float32)
    if mode != "no_input_requires_grad":
        D.requires_grad_()
    with torch.set_grad_enabled(mode != "no_grad"):
        assert gn_grad.gate_norm(y, xh, z, D, scale, EPS) == "out"
    assert taken == ([("grad",)] if mode == "grad"
                     else [("forward", False)])


# ----------------------------------------------------------------------
# the scratch, the operands and the binding
# ----------------------------------------------------------------------
class _Query:
    """A stand-in for the C library's scratch query: records its calls and
    answers ``floats``."""

    def __init__(self, floats):
        self.floats, self.calls = floats, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.floats


@pytest.mark.parametrize("dtype,floats", [
    (torch.bfloat16, 528 * 5760), (torch.float32, 264 * 5760),
    (torch.bfloat16, 0)], ids=["bf16", "f32", "refused"])
def test_scratch_floats_come_from_the_c_library(monkeypatch, dtype, floats):
    """The backward's scratch is the C library's answer for the heads and
    the dtype on the given card (0 where it refuses them), asked once for
    each."""
    query = _Query(floats)
    lib = type("Lib", (), {"mamba_gate_norm_bwd_scratch_floats": query})
    monkeypatch.setattr(gn_kernel, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: _Null())
    gn_kernel._scratch_floats.cache_clear()
    try:
        for _ in range(2):
            assert gate_norm_bwd_scratch_floats(
                80, 64, dtype, torch.device("cuda", 1)) == floats
    finally:
        gn_kernel._scratch_floats.cache_clear()
    assert query.calls == [(80, 64, int(dtype == torch.bfloat16))]
    assert query.restype == ctypes.c_longlong


def test_scratch_query_raises_on_a_cuda_error(monkeypatch):
    lib = type("Lib", (),
               {"mamba_gate_norm_bwd_scratch_floats": _Query(-700)})
    monkeypatch.setattr(gn_kernel, "load_library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda index: _Null())
    gn_kernel._scratch_floats.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            gate_norm_bwd_scratch_floats(48, 64, torch.bfloat16, "cuda:0")
    finally:
        gn_kernel._scratch_floats.cache_clear()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_operands_read_in_16_byte_words_are_aligned_first(dtype):
    """scale and dout, which the kernels read in 16-byte words from their
    start, are passed as they are where they start on the grid, else as a
    copy that does."""
    base = torch.arange(80, dtype=dtype)
    assert gate_norm_aligned(base) is base
    off = base[1:65]
    assert off.data_ptr() % 16 != 0
    got = gate_norm_aligned(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)


def test_c_entry_points_refuse_misaligned_words():
    """Both entry points refuse, as cudaErrorInvalidValue, a scale (and
    the backward a dout) off the 16-byte grid (the source is parsed; it
    cannot be compiled here)."""
    with open(os.path.join(CSRC_DIR, "mamba_gate_norm.cu")) as f:
        src = f.read()
    valid = re.search(r"bool valid\(([^)]*)\) \{(.*?)\n\}", src, re.S)
    assert valid and "aligned(scale, 0, 0, esize)" in valid.group(2)
    for symbol in ("mamba_gate_norm_fwd", "mamba_gate_norm_bwd"):
        body = src[src.index(f"KERNEL_EXPORT int {symbol}("):]
        body = body[:body.index("\n}\n")]
        assert re.search(r"!valid\([^;]*\bscale,", body), symbol
    assert "!aligned(dout, 0, 0, esize)" in src


def test_operands_are_read_in_place_where_rows_are_aligned():
    """The model's views (z of in_proj's output, xh of the conv's, y cut
    from a padded buffer) are passed as they are, with their strides;
    a view whose rows start off the 16-byte grid is copied."""
    # rows of in_proj's output 2 W + 2 N + H = 280 features (560 B)
    y, xh, z, _, _, _ = _inputs(2, 5, 8, 16, seed=5, dtype=torch.float32,
                                model_dtype=torch.bfloat16, N=8)
    for t, inner in ((xh, 2), (z, 1)):
        got, sb, ss = gate_norm_operand(t, inner)
        assert got.data_ptr() == t.data_ptr() and (sb, ss) == (
            t.stride(0), t.stride(1))
    # at H 4 they are 148 features, 296 B: copied
    z = _inputs(2, 5, 4, 16, seed=5, model_dtype=torch.bfloat16, N=8)[2]
    got, sb, ss = gate_norm_operand(z, 1)
    assert got.is_contiguous() and torch.equal(got, z) and ss == 64
    padded = torch.zeros(2, 8, 4, 16)
    got, sb, ss = gate_norm_operand(padded[:, :5], 2)
    assert got.data_ptr() == padded.data_ptr() and (sb, ss) == (512, 64)
    odd = torch.zeros(2, 5, 72, dtype=torch.bfloat16)[..., 1:65]
    got, sb, ss = gate_norm_operand(odd, 1)
    assert got.is_contiguous() and (sb, ss) == (320, 64)
    assert torch.equal(got, odd)


_ENTRIES = [(gate_norm_kernel.symbol, gate_norm_kernel.argtypes,
             ctypes.c_int),
            (gate_norm_bwd_kernel.symbol, gate_norm_bwd_kernel.argtypes,
             ctypes.c_int), gn_kernel._SCRATCH_QUERY]


@pytest.mark.parametrize("entry", _ENTRIES,
                         ids=["forward", "backward", "scratch"])
def test_binding_matches_the_c_entry_point(entry):
    """The source is listed in ``SOURCES``; one argtype per parameter of
    the exported C function, and its result type (the source is parsed;
    it cannot be compiled here)."""
    symbol, argtypes, restype = entry
    assert gate_norm_kernel.library == gate_norm_bwd_kernel.library == (
        "mamba_gate_norm") and "mamba_gate_norm" in SOURCES
    with open(os.path.join(CSRC_DIR, "mamba_gate_norm.cu")) as f:
        src = f.read()
    m = re.search(r"KERNEL_EXPORT (int|long long) " + symbol
                  + r"\(([^)]*)\)", src)
    assert m, f"{symbol} not exported by mamba_gate_norm.cu"
    params = [" ".join(p.split()) for p in m.group(2).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
            for p in params]
    assert argtypes == want and restype == kinds[m.group(1)]


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (Bz, S, H, P, model dtype): one layer of each training cell in bf16;
# chip_smoke.py's reduced archs (H 8, P 16) in float32 over a ragged row
# count, and in bf16
CARD_CASES = [(20, 2048, 48, 64, torch.bfloat16),
              (8, 4096, 80, 64, torch.bfloat16),
              (2, 37, 8, 16, torch.float32), (2, 37, 8, 16, torch.bfloat16)]
# float32 outputs within 1e-4 of their own max|ref|; each element of a
# bf16 output within one bf16 rounding (2^-8) of its own |ref| and of the
# RMS of ref (room where it is near 0)
F32_TOL, BF16_TOL = 1e-4, 2.0 ** -8


def _assert_elementwise(what, got, want, tol):
    w = want.detach().double()
    room = w.abs() + w.square().mean().sqrt()
    worst = float(((got.detach().double() - w).abs() / room).max())
    assert worst <= tol, (f"{what}: worst |d| / (|ref| + rms) {worst:.3g} "
                          f"against {tol:.3g}")


def _card_case(case, seed):
    Bz, S, H, P, md = case
    dev = _card()
    return _inputs(Bz, S, H, P, seed=seed, dtype=torch.float32,
                   device=dev, model_dtype=md, N=64)


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=lambda c: "x".join(map(str, c[:4]))
                         + ("-bf16" if c[4] == torch.bfloat16 else "-f32"))
def test_kernels_match_the_plain_chain_in_float32(case):
    """The kernels' out and gradients against autograd of the chain in
    float32 from the same inputs, a float32 output within 1e-4 of its
    max|ref|, each element of a bf16 one within 2^-8 of its own size;
    two runs give the same bits."""
    x = _card_case(case, 6)
    dout = x[5]
    ins = [t.detach().clone().requires_grad_() for t in x[:5]]
    before = _counts()
    out = gn_grad.gate_norm(*ins, EPS)
    got = (out,) + torch.autograd.grad(out, ins, dout)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 1, 0)
    want = _autograd(lambda *a: _chain(*a, EPS), *(t.float() for t in x))
    for name, g, w in zip(("out",) + GRAD_NAMES, got, want):
        assert g.dtype == (torch.float32 if name in ("dy", "dD")
                           else case[4]), name
        if g.dtype == torch.float32:
            _assert_close(f"{case}", (g,), (w,), F32_TOL, (name,))
        else:
            _assert_elementwise(f"{case} {name}", g, w, BF16_TOL)
    out2 = gn_grad.gate_norm(*ins, EPS)
    again = (out2,) + torch.autograd.grad(out2, ins, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "two runs of one input differ"


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES[1:3],
                         ids=lambda c: "x".join(map(str, c[:4])))
def test_kernels_read_the_models_views_in_place(case):
    """The model's views (xh of the conv's output, z of in_proj's, y cut
    from a buffer padded to whole chunks) are read in place and give the
    same bits as contiguous copies of them."""
    y, xh, z, D, scale, dout = _card_case(case, 7)
    Bz, S, H, P = y.shape
    padded = torch.zeros((Bz, S + 11, H, P), device=y.device)
    padded[:, :S] = y
    bases = [t.detach().requires_grad_() for t in (padded, xh._base,
                                                   z._base)]
    views = [bases[0][:, :S], bases[1][..., :H * P].reshape(Bz, S, H, P),
             bases[2][..., :H * P]]
    assert not any(t.is_contiguous() for t in views)
    for t, inner in zip(views, (2, 2, 1)):
        assert gate_norm_operand(t, inner)[0].data_ptr() == t.data_ptr()
    copies = [t.detach().contiguous().requires_grad_() for t in views]
    got = []
    for first in (views, copies):
        ins = first + [t.detach().requires_grad_() for t in (D, scale)]
        out = gn_grad.gate_norm(*ins, EPS)
        got.append((out,) + torch.autograd.grad(out, ins, dout))
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.card
def test_prefill_runs_the_forward_alone():
    """Under ``no_grad`` (a prefill) the epilogue launches the forward
    alone, the same bits as under grad."""
    y, xh, z, D, scale, _ = _card_case(CARD_CASES[3], 8)
    before = _counts()
    with torch.no_grad():
        out = ssm._gate_norm(y, xh, z, D, scale, EPS, torch.bfloat16)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    want = gn_grad.gate_norm(y, xh, z, D.clone().requires_grad_(), scale,
                             EPS)
    assert torch.equal(out, want.detach())


# (arch, rows, tokens a row, forward and backward launches a step,
# gradients the same bits in two passes): the two training cells, remat
# full.  Zamba2's shared attention runs SDPA's library backward, whose dq
# differs in its last bits from run to run (measured on an H100 at the
# cell's shape), so only its loss is compared bit for bit
STEP_CASES = [("mamba2-780m", 20, 2048, 96, 48, True),
              ("zamba2-2.7b-published", 8, 4096, 108, 54, False)]


@pytest.mark.card
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_one_training_step_of_the_cell_launches_the_kernels(case):
    """A training cell's model at full width and depth, remat full: each
    Mamba layer's forward and recompute through the forward kernel and
    its backward through the backward kernel (96 and 48 a step of
    Mamba2-780M's 48 layers, 108 and 54 of Zamba2-2.7B's 54); no call on
    the card takes the plain lines; a second pass from the same state
    gives the same loss and, where every kernel sums in a fixed order,
    the same gradients, bit for bit."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import make_loss_fn
    arch, B, S, fwd, bwd, same_grads = case
    cfg = get_config(arch)
    model = build_model(cfg, dev, generator=torch.Generator(dev)
                        .manual_seed(0))
    params = model.params()
    leaves = torch.utils._pytree.tree_leaves(params)
    loss_fn = make_loss_fn(model, "full")
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S + 1))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": rows[:, :-1].contiguous(),
             "targets": rows[:, 1:].contiguous(),
             "mask": torch.ones((B, S), dtype=torch.float32, device=dev)}
    runs = []
    for _ in range(2):
        before = _counts()
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_counts(), before)) == (
            fwd, bwd, 0)
        runs.append((loss.detach(), grads))
        del loss, grads
    (l1, g1), (l2, g2) = runs
    assert bool(torch.isfinite(l1)) and torch.equal(l1, l2)
    if same_grads:
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    del model, params, leaves, runs, g1, g2
    torch.cuda.empty_cache()
