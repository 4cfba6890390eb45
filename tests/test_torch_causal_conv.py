"""The Mamba2 mixer's depthwise causal conv with its bias and SiLU
(``csrc/mamba_causal_conv.cu``): on the CPU, the binding's checks before
any launch, the operands it reads in place, its agreement with the C
entry points, the new conv state against the model's plain lines
(``models/ssm.py::_causal_conv``) and the choice between the forward
alone and the autograd Function; on the card (marked ``card``, skipped
without one) the kernels against the plain lines run in float32 at both
training cells' widths and at the edges of what they take, a chunked
prefill, and one training step of each cell.

Run the card tests on a card with
``python -m pytest tests/test_torch_causal_conv.py -m card``.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels.build import CSRC_DIR, SOURCES
from repro_torch.kernels.causal_conv import (
    MAX_TAPS, causal_conv_bwd_kernel, causal_conv_kernel, conv_new_state,
    conv_operand)
from repro_torch.kernels.causal_conv import grad as cc_grad
from repro_torch.kernels.causal_conv import kernel as cc_kernel
from repro_torch.kernels.route import route_counts
from repro_torch.models import ssm

GRAD_NAMES = ("dx", "dw", "db", "dstate")


def _counts():
    """The conv's route on the card: the forward's and the backward's
    launches and the calls that took the plain lines."""
    c = route_counts()
    return (c["causal_conv.launches"], c["causal_conv_bwd.launches"],
            c["conv.plain"])


def _inputs(Bz, S, C, K, seed=0, dtype=torch.float32, device="cpu",
            state=True, cols=None):
    """xbc as the model's view, a column slice of in_proj's output
    (``cols``: its width and where xbc starts in it, z before and dt
    after; C + 16 and 8 if None), w, b, a state (or None) and dy, drawn
    in float32 from seeded numpy and held in ``dtype``."""
    rng = np.random.default_rng(seed)
    wide, lo = (C + 16, 8) if cols is None else cols

    def draw(shape, s=1.0):
        return torch.tensor((rng.standard_normal(shape) * s)
                            .astype(np.float32), device=device).to(dtype)
    proj = draw((Bz, S, wide))
    xbc = proj[..., lo:lo + C]
    w, b = draw((K, C), 0.4), draw((C,), 0.3)
    st = draw((Bz, K - 1, C)) if state else None
    return xbc, w, b, st, draw((Bz, S, C))


# ----------------------------------------------------------------------
# the binding's checks, before any launch
# ----------------------------------------------------------------------
def _no_library(name):
    raise AssertionError("the library was asked for before the checks")


def _card_fakes(dtype=torch.bfloat16, C=64, K=4, w_shape=None,
                w_dtype=None, b_shape=None, state_shape=None,
                state_dtype=None, xbc_dims=3, w_strided=False,
                b_strided=False):
    """The conv's operands as fakes on the card's device (a trace's
    FakeTensorMode must be active; on this host a fake CUDA tensor takes
    no view, so strided ones are made so), one of them off as asked."""
    Bz, S = 2, 5

    def empty(shape, dt=dtype, strides=None):
        if strides is None:
            return torch.empty(shape, device="cuda", dtype=dt)
        return torch.empty_strided(shape, strides, device="cuda", dtype=dt)
    x = (empty((Bz, S, C), strides=(S * (C + 16), C + 16, 1))
         if xbc_dims == 3 else empty((S, C)))
    w = empty(w_shape or (K, C), w_dtype or dtype,
              (1, K) if w_strided else None)
    b = empty(b_shape or (C,), strides=(2,) if b_strided else None)
    st = empty(state_shape or (Bz, K - 1, C), state_dtype or dtype)
    return x, w, b, st


# operands the binding refuses, and the words of its ValueError
REFUSED = [
    (dict(dtype=torch.float16), "bf16 or float32"),
    (dict(dtype=torch.float64), "bf16 or float32"),
    (dict(K=9, w_shape=(9, 64)), "1 <= K <= 8"),
    (dict(w_shape=(0, 64)), "1 <= K <= 8"),
    (dict(w_shape=(4, 32)), "w: expected shape (4, 64)"),
    (dict(w_dtype=torch.float32), "w: expected torch.bfloat16"),
    (dict(b_shape=(63,)), "b: expected shape (64,)"),
    (dict(state_shape=(2, 4, 64)), "state: expected shape (2, 3, 64)"),
    (dict(state_dtype=torch.float32), "state: expected torch.bfloat16"),
    (dict(xbc_dims=2), "xbc: expected (Bz, S, C)"),
    (dict(w_strided=True), "w: expected a contiguous tensor"),
    (dict(b_strided=True), "b: expected a contiguous tensor"),
]


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("case,words", REFUSED, ids=[
    "f16", "f64", "K9", "K0", "w-width", "w-dtype", "b-width",
    "state-rows", "state-dtype", "xbc-2d", "w-strided", "b-strided"])
def test_binding_refuses_before_any_launch(monkeypatch, direction, case,
                                           words):
    """Dtypes, taps, shapes and strides the kernels do not take raise
    ``ValueError`` before the library is asked for anything."""
    monkeypatch.setattr(cc_kernel, "load_library", _no_library)
    with FakeTensorMode():
        x, w, b, st = _card_fakes(**case)
        with pytest.raises(ValueError, match=re.escape(words)):
            if direction == "forward":
                cc_kernel.causal_conv_fwd_cuda(x, w, b, st)
            else:
                cc_kernel.causal_conv_bwd_cuda(x, w, b, st, torch.empty(
                    x.shape, device="cuda", dtype=x.dtype))


def test_backward_refuses_a_dy_unlike_xbc(monkeypatch):
    monkeypatch.setattr(cc_kernel, "load_library", _no_library)
    with FakeTensorMode():
        x, w, b, st = _card_fakes()
        for dy in (torch.empty((2, 4, 64), device="cuda",
                               dtype=torch.bfloat16),
                   torch.empty((2, 5, 64), device="cuda")):
            with pytest.raises(ValueError, match="dy: expected"):
                cc_kernel.causal_conv_bwd_cuda(x, w, b, st, dy)


def test_route_raises_for_card_tensors_the_kernels_refuse(monkeypatch):
    """A card call the kernels cannot take (float16 here) raises in place
    of running the plain lines on the card; nothing is counted."""
    from repro_torch.kernels import route as routing
    monkeypatch.setattr(routing, "on_card", lambda t: True)
    monkeypatch.setattr(cc_kernel, "load_library", _no_library)
    before = route_counts()
    with FakeTensorMode():
        x, w, b, st = _card_fakes(dtype=torch.float16)
        with pytest.raises(ValueError, match="bf16 or float32"):
            ssm._conv(x, w, b, st)
    assert route_counts() == before


# ----------------------------------------------------------------------
# the new conv state, the operands, the call
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K,S,state", [
    (4, 9, True), (4, 9, False), (4, 2, True), (4, 2, False), (2, 5, True),
    (1, 5, True), (1, 5, False), (8, 3, True)],
    ids=["K4", "K4-no_state", "S2", "S2-no_state", "K2", "K1",
         "K1-no_state", "K8-S3"])
def test_new_state_is_the_plain_lines(K, S, state):
    """The trailing K - 1 rows of [state, xbc] as the wrapper builds them
    equal the plain lines' bit for bit, with or without a state, and where
    S < K - 1 (part of the state carries over); a gradient reaches xbc and
    the state through them as through the plain lines'."""
    xbc, w, b, st, _ = _inputs(2, S, 24, K, seed=1, state=state)
    ins = [xbc.detach().requires_grad_()] + (
        [st.detach().requires_grad_()] if state else [])
    got = conv_new_state(ins[0], ins[1] if state else None, K)
    want = ssm._causal_conv(ins[0], w, b, ins[1] if state else None)[1]
    assert got.shape == want.shape == (2, K - 1, 24)
    assert torch.equal(got, want)
    if K > 1:
        probe = torch.randn(want.shape, generator=torch.Generator()
                            .manual_seed(2))
        g_got = torch.autograd.grad(got, ins, probe, allow_unused=True,
                                    materialize_grads=True)
        g_want = torch.autograd.grad(want, ins, probe, allow_unused=True,
                                     materialize_grads=True)
        assert all(torch.equal(a, c) for a, c in zip(g_got, g_want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_operands_are_read_in_place_where_rows_are_aligned(dtype):
    """xbc as the cells' column slice of in_proj's output (rows of 6,448
    and 10,448 features, the slice at 3,072 and 5,120) is passed as it
    is, with its strides; a slice whose rows start off the 16-byte grid,
    or whose channels are strided, is copied; at C % 8 != 0 the view is
    read in place element by element."""
    for wide, lo, C in ((6448, 3072, 3328), (10448, 5120, 5248)):
        proj = torch.zeros((2, 3, wide), dtype=dtype)
        xbc = proj[..., lo:lo + C]
        got, sb, ss = conv_operand(xbc)
        assert got.data_ptr() == xbc.data_ptr()
        assert (sb, ss) == (3 * wide, wide)
    odd = torch.arange(2 * 3 * 72, dtype=dtype).reshape(2, 3, 72)[..., 1:65]
    got, sb, ss = conv_operand(odd)
    assert got.is_contiguous() and (sb, ss) == (192, 64)
    assert torch.equal(got, odd)
    strided = torch.zeros((2, 3, 128), dtype=dtype)[..., ::2]
    got, _, _ = conv_operand(strided)
    assert got.is_contiguous() and torch.equal(got, strided)
    narrow = torch.zeros((2, 3, 120), dtype=dtype)[..., 3:103]
    got, sb, ss = conv_operand(narrow)
    assert got.data_ptr() == narrow.data_ptr() and (sb, ss) == (360, 120)


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad",
                                  "grad", "state_requires_grad"])
def test_call_runs_the_forward_alone_where_no_gradient_is_asked(
        monkeypatch, mode):
    """``causal_conv`` (stubbed launches: this host has no card) runs the
    forward alone where no gradient will be asked for (a prefill under
    ``no_grad``, or inputs that require none), and the autograd Function
    otherwise; the new state comes from the plain lines' rows."""
    taken = []
    monkeypatch.setattr(cc_grad, "causal_conv_fwd_cuda",
                        lambda *a: taken.append("forward") or "y")
    monkeypatch.setattr(cc_grad._CausalConv, "apply",
                        lambda *a: taken.append("grad") or "y")
    xbc, w, b, st, _ = _inputs(2, 6, 16, 4, seed=3)
    if mode == "grad":
        w.requires_grad_()
    if mode == "state_requires_grad":
        st.requires_grad_()
    with torch.set_grad_enabled(mode != "no_grad"):
        y, new_state = cc_grad.causal_conv(xbc, w, b, st)
    assert y == "y"
    assert taken == (["grad"] if mode in ("grad", "state_requires_grad")
                     else ["forward"])
    assert torch.equal(new_state, ssm._causal_conv(xbc, w, b, st)[1])


def test_backward_gives_the_state_a_gradient_only_where_asked(monkeypatch):
    """The Function's backward asks the kernel for the state's gradient
    where the state requires one, and hands back each input's."""
    asked = []

    def bwd(xbc, w, b, state, dy, *, state_grad):
        asked.append(state_grad)
        return (torch.zeros_like(xbc), torch.zeros_like(w),
                torch.zeros_like(b),
                torch.zeros_like(state) if state_grad else None)
    monkeypatch.setattr(cc_grad, "causal_conv_fwd_cuda",
                        lambda xbc, w, b, st: torch.zeros_like(xbc))
    monkeypatch.setattr(cc_grad, "causal_conv_bwd_cuda", bwd)
    for state_grad in (False, True):
        xbc, w, b, st, dy = _inputs(2, 6, 16, 4, seed=4)
        ins = [t.requires_grad_() for t in (xbc, w, b)]
        if state_grad:
            st.requires_grad_()
        y, _ = cc_grad.causal_conv(*ins, st)
        grads = torch.autograd.grad(y, ins + ([st] if state_grad else []),
                                    dy)
        assert len(grads) == 3 + state_grad
    assert asked == [False, True]


# ----------------------------------------------------------------------
# the binding against the C source
# ----------------------------------------------------------------------
def _source():
    with open(os.path.join(CSRC_DIR, "mamba_causal_conv.cu")) as f:
        return f.read()


_ENTRIES = [(causal_conv_kernel.symbol, causal_conv_kernel.argtypes,
             ctypes.c_int),
            (causal_conv_bwd_kernel.symbol, causal_conv_bwd_kernel.argtypes,
             ctypes.c_int), cc_kernel._SCRATCH_QUERY]


@pytest.mark.parametrize("entry", _ENTRIES,
                         ids=["forward", "backward", "scratch"])
def test_binding_matches_the_c_entry_point(entry):
    """The source is listed in ``SOURCES``; one argtype per parameter of
    the exported C function, and its result type (the source is parsed;
    it cannot be compiled here)."""
    symbol, argtypes, restype = entry
    assert causal_conv_kernel.library == causal_conv_bwd_kernel.library == (
        "mamba_causal_conv") and "mamba_causal_conv" in SOURCES
    m = re.search(r"KERNEL_EXPORT (int|long long) " + symbol
                  + r"\(([^)]*)\)", _source())
    assert m, f"{symbol} not exported by mamba_causal_conv.cu"
    params = [" ".join(p.split()) for p in m.group(2).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
            for p in params]
    assert argtypes == want and restype == kinds[m.group(1)]


def test_the_binding_knows_the_c_librarys_taps():
    assert re.search(r"constexpr int kMaxTaps = (\d+);",
                     _source()).group(1) == str(MAX_TAPS)


def test_scratch_floats_come_from_the_c_library(monkeypatch):
    calls = []

    def query(*args):
        calls.append(args)
        return 1234
    lib = type("Lib", (), {"mamba_causal_conv_bwd_scratch_floats": query})
    monkeypatch.setattr(cc_kernel, "load_library", lambda name: lib)
    cc_kernel.causal_conv_bwd_scratch_floats.cache_clear()
    try:
        for _ in range(2):
            assert cc_kernel.causal_conv_bwd_scratch_floats(
                20, 2048, 3328, 4) == 1234
    finally:
        cc_kernel.causal_conv_bwd_scratch_floats.cache_clear()
    assert calls == [(20, 2048, 3328, 4)]
    assert query.restype == ctypes.c_longlong


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# (Bz, S, C, K, dtype, state, cols): a layer of each training cell in bf16
# (xbc the column slice of in_proj's output at the cell's widths: rows of
# 6,448 and 10,448 features, xbc from 3,072 and 5,120), with and
# without a state; the edges: C off the 8-channel words, float32, K 2 and
# 5 (the 8-tap body) and 1, S < K - 1, a row count off the blocks
CARD_CASES = [
    (20, 2048, 3328, 4, torch.bfloat16, True, (6448, 3072)),
    (8, 4096, 5248, 4, torch.bfloat16, False, (10448, 5120)),
    (3, 77, 100, 4, torch.bfloat16, True, (130, 15)),
    (2, 101, 64, 4, torch.float32, True, None),
    (2, 67, 48, 2, torch.bfloat16, True, None),
    (2, 67, 48, 5, torch.bfloat16, True, None),
    (2, 33, 40, 1, torch.float32, False, None),
    (2, 2, 64, 4, torch.bfloat16, True, None),
    (1, 600, 72, 4, torch.float32, False, None),
]
CARD_IDS = ["mamba2-layer", "zamba2-layer-no_state", "C100", "f32", "K2",
            "K5", "K1-no_state", "S2", "S600"]
# float32 outputs within 1e-5 of their own max|ref|; each element of a
# bf16 output within one bf16 rounding (2^-8) of its own |ref| and of the
# RMS of ref (room where it is near 0): the kernels sum in float32 and
# round once, at the output
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -8


def _assert_close(what, got, want, dtype):
    w = want.detach().double()
    d = (got.detach().double() - w).abs()
    if dtype == torch.float32:
        worst = float(d.max() / w.abs().max().clamp_min(1e-30))
        assert worst <= F32_TOL, f"{what}: max|d| / max|ref| {worst:.3g}"
    else:
        room = w.abs() + w.square().mean().sqrt()
        worst = float((d / room).max())
        assert worst <= BF16_TOL, (f"{what}: worst |d| / (|ref| + rms) "
                                   f"{worst:.3g} against {BF16_TOL:.3g}")


def _plain_f32(xbc, w, b, st, dy):
    """The plain lines in float32 on float32 copies of the inputs, and
    autograd of them: y, the new state, dx, dw, db and the state's
    gradient (None without a state)."""
    ins = [t.detach().float().requires_grad_() for t in (xbc, w, b)]
    s = None if st is None else st.detach().float().requires_grad_()
    y, new_state = ssm._causal_conv(*ins, s)
    grads = torch.autograd.grad(y, ins + ([s] if s is not None else []), dy)
    return (y, new_state) + tuple(grads) + ((None,) if s is None else ())


@pytest.mark.card
@pytest.mark.parametrize("case", CARD_CASES, ids=CARD_IDS)
def test_kernels_match_the_plain_lines_in_float32(case):
    """y, the new state and every gradient (the state's where it requires
    one) against the plain lines run in float32 from the same inputs; the
    new state bit for bit; one launch of each kernel a call, no plain
    call; two runs give the same bits."""
    Bz, S, C, K, dtype, state, cols = case
    dev = _card()
    xbc, w, b, st, dy = _inputs(Bz, S, C, K, seed=6, dtype=dtype,
                                device=dev, state=state, cols=cols)
    want = _plain_f32(xbc, w, b, st, dy.float())
    runs = []
    for _ in range(2):
        ins = [t.detach().requires_grad_() for t in (xbc._base, w, b)]
        lo = xbc.storage_offset()
        view = ins[0][..., lo:lo + C]
        s = None if st is None else st.detach().requires_grad_()
        before = _counts()
        y, new_state = ssm._conv(view, ins[1], ins[2], s)
        grads = torch.autograd.grad(
            y, [view] + ins[1:] + ([s] if s is not None else []), dy)
        torch.cuda.synchronize()
        assert tuple(a - c for a, c in zip(_counts(), before)) == (1, 1, 0)
        runs.append((y, new_state) + tuple(grads)
                    + ((None,) if s is None else ()))
    got = runs[0]
    assert torch.equal(got[1], want[1].to(dtype))
    for name, g, ref in zip(("y",) + GRAD_NAMES, got[:1] + got[2:],
                            want[:1] + want[2:]):
        if ref is None:
            assert g is None, name
            continue
        assert g.dtype == dtype and g.shape == ref.shape, name
        _assert_close(f"{CARD_IDS[CARD_CASES.index(case)]} {name}", g, ref,
                      dtype)
    assert all(a is None and c is None or torch.equal(a, c)
               for a, c in zip(*runs)), "two runs of one input differ"


@pytest.mark.card
def test_the_kernels_are_closer_to_float32_than_the_bf16_plain_lines():
    """At mamba2-780m's layer in bf16, y and dx of the kernels (float32
    inside, one rounding) lie no farther from the float32 plain lines
    than the bf16 plain lines' own do."""
    dev = _card()
    xbc, w, b, st, dy = _inputs(20, 2048, 3328, 4, seed=9,
                                dtype=torch.bfloat16, device=dev,
                                cols=(6448, 3072))
    want = _plain_f32(xbc, w, b, st, dy.float())
    errs = []
    for fn in (ssm._conv, ssm._causal_conv):
        x = xbc.detach().requires_grad_()
        y, _ = fn(x, w, b, st)
        dx, = torch.autograd.grad(y, [x], dy)
        errs.append([float((g.double() - r.double()).abs().max())
                     for g, r in ((y, want[0]), (dx, want[2]))])
    assert all(k <= p for k, p in zip(*errs)), errs


@pytest.mark.card
def test_prefill_runs_the_forward_alone_and_chunks_carry_the_state():
    """Under ``no_grad`` (a prefill) the conv launches the forward alone;
    a prefill in two chunks, the second from the first's new state, gives
    the same bits as one prefill of the whole."""
    dev = _card()
    xbc, w, b, st, _ = _inputs(2, 300, 3328, 4, seed=8,
                               dtype=torch.bfloat16, device=dev,
                               cols=(6448, 3072))
    before = _counts()
    with torch.no_grad():
        whole, whole_state = ssm._conv(xbc, w, b, st)
        first, mid = ssm._conv(xbc[:, :129], w, b, st)
        second, last = ssm._conv(xbc[:, 129:], w, b, mid)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_counts(), before)) == (3, 0, 0)
    assert torch.equal(torch.cat([first, second], 1), whole)
    assert torch.equal(last, whole_state)


# (arch, rows, tokens a row, forward and backward launches a step): the
# two training cells, remat full
STEP_CASES = [("mamba2-780m", 20, 2048, 96, 48),
              ("zamba2-2.7b-published", 8, 4096, 108, 54)]


@pytest.mark.card
@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c[0])
def test_one_training_step_of_the_cell_launches_the_kernels(case):
    """A training cell's model at full width and depth, remat full: each
    Mamba layer's conv in the forward and the recompute through the
    forward kernel and in the backward through the backward kernel (96
    and 48 a step of Mamba2-780M's 48 layers, 108 and 54 of
    Zamba2-2.7B's 54); no call on the card takes the plain lines."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.step import make_loss_fn
    arch, B, S, fwd, bwd = case
    cfg = get_config(arch)
    model = build_model(cfg, dev, generator=torch.Generator(dev)
                        .manual_seed(0))
    params = model.params()
    leaves = torch.utils._pytree.tree_leaves(params)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.integers(1, cfg.vocab, (B, S + 1))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": rows[:, :-1].contiguous(),
             "targets": rows[:, 1:].contiguous(),
             "mask": torch.ones((B, S), dtype=torch.float32, device=dev)}
    before = _counts()
    loss, _ = make_loss_fn(model, "full")(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_counts(), before)) == (fwd, bwd, 0)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    del model, params, leaves, grads, loss
    torch.cuda.empty_cache()
