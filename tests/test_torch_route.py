"""Where the LM path's calls run, kernel or plain version
(``repro_torch.kernels.route``), for each of its four routes: the SSD
(``models/ssm.py::_ssd_local``), the mixer's epilogue
(``models/ssm.py::_gate_norm``), the mixer's causal conv
(``models/ssm.py::_conv``) and attention
(``models/blocks.py::attention_core``).  On the CPU and over a trace's
fake tensors every call takes the plain version and counts nothing; a
call on the card (fakes passed off as real here) counts once, in the
counter of the version it took.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import route
from repro_torch.kernels.route import route_counts
from repro_torch.models import blocks, ssm

EPS = 1e-5


class _Taken(Exception):
    """Raised by the stub of a route's plain version."""


def _stub_versions(monkeypatch, name):
    """The route's kernel stubbed to return "kernel", its plain version
    to raise ``_Taken("plain")`` (attention's einsum is stubbed at its
    mask, in place of which nothing could be returned)."""
    _, _, (kmod, kname), (pmod, pname) = ROUTES[name]
    monkeypatch.setattr(kmod, kname, lambda *a, **k: "kernel")

    def plain(*args):
        raise _Taken("plain")
    monkeypatch.setattr(pmod, pname, plain)


def _taken(call, *args, **kwargs):
    """What ``call`` returned, or "plain" where the plain stub raised."""
    try:
        return call(*args, **kwargs)
    except _Taken as e:
        return str(e)


def _ssd_args(device, h0=False):
    g = torch.Generator().manual_seed(0) if device == "cpu" else None

    def draw(*shape):
        if g is None:
            return torch.empty(*shape, device=device)
        return torch.randn(*shape, generator=g) * 0.3
    x, dt, A = draw(2, 40, 3, 4), draw(2, 40, 3).abs(), -draw(3).abs()
    B, C = draw(2, 40, 5), draw(2, 40, 5)
    return (x, dt, A, B, C, 16, draw(2, 3, 4, 5) if h0 else None)


def _gate_norm_args(device):
    g = torch.Generator().manual_seed(1) if device == "cpu" else None
    bf16 = torch.bfloat16

    def draw(*shape, dtype=torch.float32):
        if g is None:
            return torch.empty(*shape, device=device, dtype=dtype)
        return torch.randn(*shape, generator=g).to(dtype)
    return (draw(2, 5, 4, 16), draw(2, 5, 4, 16, dtype=bf16),
            draw(2, 5, 64, dtype=bf16), 1 + draw(4), draw(64, dtype=bf16),
            EPS, bf16)


def _conv_args(device):
    g = torch.Generator().manual_seed(3) if device == "cpu" else None

    def draw(*shape):
        if g is None:
            return torch.empty(*shape, device=device, dtype=torch.bfloat16)
        return torch.randn(*shape, generator=g).to(torch.bfloat16)
    return draw(2, 9, 24), draw(4, 24), draw(24), draw(2, 3, 24)


def _attention_args(device):
    g = torch.Generator().manual_seed(2) if device == "cpu" else None
    if g is None:
        q, k, v = (torch.empty(2, 16, 4, 8, device=device,
                               dtype=torch.bfloat16) for _ in range(3))
        pos = torch.empty(2, 16, device=device, dtype=torch.long)
    else:
        q, k, v = (torch.randn(2, 16, 4, 8, generator=g).to(torch.bfloat16)
                   for _ in range(3))
        pos = blocks.make_positions(2, 16)
    return q, k, v, pos, pos


# route -> (the call, its inputs, where its kernel and its plain version
# are looked up: (module, name) each; attention's plain version is the
# einsum inside attention_core, stubbed at its mask, which only it builds)
ROUTES = {
    "ssd": (ssm._ssd_local, _ssd_args, (ssm, "ssd_train"),
            (ssm, "_ssd_plain")),
    "gate_norm": (ssm._gate_norm, _gate_norm_args, (ssm, "gate_norm"),
                  (ssm, "_gate_norm_plain")),
    "conv": (ssm._conv, _conv_args, (ssm, "causal_conv"),
             (ssm, "_causal_conv")),
    "attention": (lambda *a: blocks.attention_core(*a, fused_ok=True),
                  _attention_args, (blocks, "_attention_fused"),
                  (blocks, "_mask_bias")),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_gives_a_traces_fake_card_tensors_the_plain_version(
        monkeypatch, name):
    """The dry run traces the model over fake tensors on the card's
    device: they hold no data to launch on, so they take the plain
    version (a stub here: this host cannot run it on fake CUDA tensors)
    and count as no call on the card."""
    call, args, _, _ = ROUTES[name]
    _stub_versions(monkeypatch, name)
    before = route_counts()
    with FakeTensorMode():
        ins = args("cuda")
        assert ins[0].is_cuda and not route.on_card(ins[0])
        assert _taken(call, *ins) == "plain"
    assert route_counts() == before


@pytest.mark.parametrize("name", list(ROUTES))
def test_route_on_the_cpu_takes_the_plain_version_and_counts_nothing(name):
    call, args, _, (module, plain) = ROUTES[name]
    ins = args("cpu")
    before = route_counts()
    got = call(*ins)
    if name == "attention":
        want = blocks.attention_core(*ins, fused_ok=False)
    else:
        want = getattr(module, plain)(*ins)
    for g, w in zip(*((t,) if torch.is_tensor(t) else t
                      for t in (got, want))):
        assert torch.equal(g, w)
    assert route_counts() == before


@pytest.mark.parametrize("name,case,want", [
    ("ssd", dict(h0=False), "kernel"), ("ssd", dict(h0=True), "plain"),
    ("attention", dict(fused_ok=True), "kernel"),
    ("attention", dict(fused_ok=False), "plain"),
    ("conv", dict(dtensor=False), "kernel"),
    ("conv", dict(dtensor=True), "plain"),
], ids=["ssd-no_h0", "ssd-h0", "attention-fused_ok", "attention-not_fused",
        "conv-tensor", "conv-dtensor"])
def test_a_call_on_the_card_counts_once_in_the_version_it_took(
        monkeypatch, name, case, want):
    """Fakes passed off as holding data on the card: the SSD takes the
    kernels without an incoming state and the plain body with one;
    attention takes the fused kernel where its caller allows it; the conv
    takes its kernels unless it is a DTensor.  The epilogue's cases are
    in ``tests/test_torch_gate_norm.py``."""
    monkeypatch.setattr(route, "on_card", lambda t: True)
    _stub_versions(monkeypatch, name)
    if name == "conv":
        monkeypatch.setattr(ssm, "is_dtensor", lambda t: case["dtensor"])
    before = route_counts()
    with FakeTensorMode():
        if name == "ssd":
            got = _taken(ssm._ssd_local, *_ssd_args("cuda", h0=case["h0"]))
        elif name == "conv":
            got = _taken(ssm._conv, *_conv_args("cuda"))
        else:
            got = _taken(blocks.attention_core, *_attention_args("cuda"),
                         fused_ok=case["fused_ok"])
    assert got == want
    after = route_counts()
    grew = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert grew == {f"{name}.{want}": 1}


def test_route_counts_holds_every_counter_and_launch():
    counts = route_counts()
    assert set(counts) == {
        f"{r}.{v}" for r in ("ssd", "gate_norm", "conv", "attention")
        for v in ("kernel", "plain")} | {
        f"{k}.launches" for k in ("ssd_scan", "ssd_scan_bwd", "gate_norm",
                                  "gate_norm_bwd", "causal_conv",
                                  "causal_conv_bwd")}
    assert all(isinstance(n, int) and n >= 0 for n in counts.values())
