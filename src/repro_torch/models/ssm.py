"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

The JAX package's ``models/ssm.py`` in PyTorch: the chunked SSD dual
form for training/prefill (quadratic within a chunk, linear across
chunks: every chunk's own terms at once, then a loop over chunks for
the carried state in place of its ``lax.scan``) and the
O(1)-per-token recurrence for decode.  On the card, the chunked SSD of
a call with no incoming state (training, a prefill from an empty cache)
runs as the hand-written kernels, forward and backward
(``csrc/ssd_scan.cu``, ``csrc/ssd_scan_bwd.cu``, through
``repro_torch.kernels.ssd_scan.ssd_train``); every other call, and every
call on the CPU, runs the plain body :func:`_ssd_plain`, the JAX
package's arithmetic, which the kernels are held against.  The LM
models start training and prefill from an SSM state of None for that.
The mixer's epilogue after the SSD (the D skip, the SiLU gate and the
gated RMSNorm, :func:`_gate_norm`) runs on the card as one pair of
hand-written kernels, forward and backward (``csrc/mamba_gate_norm.cu``,
through ``repro_torch.kernels.mamba_gate_norm.gate_norm``); on the CPU,
and on DTensors, as the plain lines :func:`_gate_norm_plain`.  So does
the depthwise causal conv before the SSD, with its bias and SiLU
(:func:`_conv`: ``csrc/mamba_causal_conv.cu`` through
``repro_torch.kernels.causal_conv.causal_conv``; the plain lines
:func:`_causal_conv`).  Decode's rolling window (:func:`mamba_step`)
stays plain.

While a ``torch.profiler`` records, the mixer (:func:`mamba_sequence`),
its conv (:func:`_conv`) and its chunked SSD (the local body of
:func:`_ssd_chunked`) run inside the ranges ``mamba.mixer``,
``mamba.conv`` and ``mamba.ssd``
(:func:`repro_torch.core.obs.device_range`).  Each covers its forward,
its recompute under remat and, through autograd hooks, its backward,
which runs on autograd's thread; nothing else changes.

Shapes: heads H = d_inner / head_dim P, single B/C group (G=1), state N.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.obs.ranges import device_range
from ..dist.sharding import (batch_heads_placements, batch_only,
                             constrain_residual, gather_grad_unless_divides,
                             gather_unless_divides, is_dtensor, local_call)
from ..kernels import route
from ..kernels.causal_conv import causal_conv
from ..kernels.mamba_gate_norm import gate_norm
from ..kernels.ssd_scan import ssd_train
from .blocks import Leaf, Params, _dense_init, apply_norm

__all__ = ["init_mamba", "mamba_sequence", "mamba_step", "init_ssm_state"]


def init_mamba(cfg: ModelConfig, dtype) -> Params:
    d, di = cfg.d_model, cfg.d_inner()
    N, H, K = cfg.ssm_state, cfg.ssm_heads(), cfg.conv_kernel
    conv_ch = di + 2 * N                       # x + B + C go through conv
    out_std = 0.02 / math.sqrt(2 * max(1, cfg.n_layers))
    f32 = torch.float32
    return {
        "in_proj": _dense_init((d, 2 * di + 2 * N + H), dtype),
        "conv_w": _dense_init((K, conv_ch), dtype, std=0.2),
        "conv_b": Leaf((conv_ch,), dtype, "zeros"),
        "dt_bias": Leaf((H,), f32, "zeros"),
        "A_log": Leaf((H,), f32, "log_linspace"),
        "D": Leaf((H,), f32, "ones"),
        "norm_scale": Leaf((di,), dtype, "zeros"),
        "out_proj": _dense_init((di, d), dtype, std=out_std),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, N, H = cfg.d_inner(), cfg.ssm_state, cfg.ssm_heads()
    z, xbc, dt = torch.split(proj, [di, di + 2 * N, H], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xbc: (B, S, C), w: (K, C).

    Returns (y, new_state) where state carries the trailing K-1 inputs.
    """
    K = w.shape[0]
    S = xbc.shape[1]
    if state is None:
        state = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    ext = torch.cat([state, xbc], dim=1)                      # (B, K-1+S, C)
    y = sum(ext[:, i:i + S, :] * w[i] for i in range(K))
    new_state = ext[:, -(K - 1):, :] if K > 1 else state
    return F.silu(y + b), new_state


@device_range("mamba.conv")
def _conv(xbc, w, b, state):
    """The mixer's depthwise causal conv with its bias and SiLU, as
    :func:`_causal_conv`.  Tensors on the card take the hand-written
    kernels (``causal_conv``: forward and backward), which raise
    ``ValueError`` for dtypes or taps they do not take; DTensors on the
    card, the CPU and a trace's fakes take :func:`_causal_conv`
    (``kernels/route.py``'s ``conv`` route)."""
    if route.on_card(xbc):
        if not is_dtensor(xbc):
            out = causal_conv(xbc, w, b, state)
            route.count("conv", kernel=True)
            return out
        route.count("conv", kernel=False)
    return _causal_conv(xbc, w, b, state)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    H, P, N, K = (cfg.ssm_heads(), cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.conv_kernel)
    di = cfg.d_inner()
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, K - 1, di + 2 * N), dtype=dtype,
                            device=device),
    }


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD dual-form over chunks.

    x:  (B, S, H, P)   inputs per head
    dt: (B, S, H)      positive step sizes
    A:  (H,)           negative decay rates
    Bm, Cm: (B, S, N)  input/output projections (G=1, shared over heads)
    Returns (y (B,S,H,P) float32, h_final (B,H,P,N) float32).  On
    DTensors each rank scans its batch rows and, where 'model' divides
    H, its heads.
    """
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh = x.device_mesh
        row, head = batch_heads_placements(mesh, x.shape[0], (x.shape[2],))
        a_pl = tuple(Shard(0) if p.is_shard() and p.dim == 2
                     else Replicate() for p in head)
        state_pl = tuple(Shard(1) if p.is_shard() and p.dim == 2 else p
                         for p in head)

        def body(x, dt, A, Bm, Cm, h0):
            return _ssd_chunked(x, dt, A, Bm, Cm, chunk, h0)

        return local_call(body, mesh, (x, dt, A, Bm, Cm, h0),
                          (head, head, a_pl, row, row,
                           None if h0 is None else state_pl),
                          (head, state_pl))
    return _ssd_local(x, dt, A, Bm, Cm, chunk, h0)


@device_range("mamba.ssd")
def _ssd_local(x, dt, A, Bm, Cm, chunk, h0):
    """:func:`_ssd_chunked` on one device's tensors: the hand-written
    kernels (``ssd_train``: the forward and its backward) for tensors on
    the card with no incoming state, else :func:`_ssd_plain`
    (``kernels/route.py``'s ``ssd`` route)."""
    if route.on_card(x):
        if h0 is None:
            out = ssd_train(x, dt, A, Bm, Cm, chunk=chunk)
            route.count("ssd", kernel=True)
            return out
        route.count("ssd", kernel=False)
    return _ssd_plain(x, dt, A, Bm, Cm, chunk, h0)


def _ssd_plain(x, dt, A, Bm, Cm, chunk, h0):
    """The chunked SSD in plain PyTorch, in float32 (float64 for float64
    inputs): the plain version the kernels are held against."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    n_chunks = (S + Q - 1) // Q
    pad = n_chunks * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))

    def chunks(t):
        return t.reshape((Bsz, n_chunks, Q) + t.shape[2:])

    xc, dtc = chunks(x.to(f)), chunks(dt)           # (B,c,Q,H,P), (B,c,Q,H)
    Bc, Cc = chunks(Bm.to(f)), chunks(Cm.to(f))     # (B,c,Q,N)
    a = dtc * A                                     # (B, c, Q, H) log-decay
    cum = torch.cumsum(a, dim=2)                    # within-chunk cumsum

    # every chunk's own terms at once; only the carried state is a loop
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # decay matrix L[i, j] = exp(cum_i - cum_j) for i >= j else 0.
    # Mask BEFORE exp: masked entries have diff > 0 and overflow to
    # inf, and where(c, inf, 0) poisons the backward with 0*inf=NaN.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,c,Q,Q,H)
    L = torch.exp(torch.where(causal, diff, -1e30))
    # intra-chunk: scores (B,c,Q,Q) from C_i . B_j; weight by L and dt_j
    s = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = s[..., None] * L * dtc[:, :, None, :, :]             # (B,c,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    # each chunk's state increment: sum_j exp(cum_Q - cum_j) dt_j B_j x_j
    total = cum[:, :, -1, :]                                 # (B,c,H)
    rem = torch.exp(total[:, :, None, :] - cum)              # (B,c,Q,H)
    contrib = torch.einsum("bcjh,bcjn,bcjhp->bchpn", rem * dtc, Bc, xc)
    decays = torch.exp(total)[..., None, None]               # (B,c,H,1,1)

    # the carried state: h' = exp(sum a) h + increment, chunk by chunk
    h = (torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
         if h0 is None else h0)
    h_in = []
    for d, inc in zip(torch.unbind(decays, 1), torch.unbind(contrib, 1)):
        h_in.append(h)
        h = d * h + inc
    # inter-chunk: contribution of the state each chunk starts from
    decay_in = torch.exp(cum)                                # (B,c,Q,H)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc,
                           torch.stack(h_in, dim=1), decay_in)
    ys = y_intra + y_inter
    y = ys.reshape(Bsz, n_chunks * Q, H, P)
    return y[:, :S], h


@device_range("mamba.mixer")
def mamba_sequence(p: Params, cfg: ModelConfig, u: torch.Tensor,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   norm_eps: float = 1e-6
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence Mamba2 block (training / prefill).

    u: (B, S, d_model) -> (y, final_state); ``norm_eps`` is the gated
    RMSNorm's epsilon.
    """
    B, S, d = u.shape
    di, N, H, P = cfg.d_inner(), cfg.ssm_state, cfg.ssm_heads(), cfg.ssm_head_dim
    proj = batch_only(u) @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    conv_state = state["conv"] if state else None
    xbc, conv_state = _conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,S,H)
    A = -torch.exp(p["A_log"])                                    # (H,)
    xh = gather_unless_divides(xs, 2, H).reshape(B, S, H, P)
    h0 = state["ssm"] if state else None
    y, h_fin = _ssd_chunked(xh.float(), dt, A, Bm, Cm, cfg.ssm_chunk, h0)
    y = _gate_norm(y, xh, z, p["D"], p["norm_scale"], norm_eps, u.dtype)
    out = constrain_residual(y @ p["out_proj"])
    return out, {"ssm": h_fin, "conv": conv_state}


def _gate_norm(y, xh, z, D, scale, eps, dtype):
    """The mixer's epilogue, from the SSD's float32 y (B,S,H,P) to the
    out_proj input (B,S,H P) in ``dtype``: the D skip, the SiLU gate and
    the gated RMSNorm.  Tensors on the card take the hand-written kernels
    (``gate_norm``: forward and backward), which raise ``ValueError`` for
    dtypes or widths they do not take; DTensors on the card, the CPU and
    a trace's fakes take :func:`_gate_norm_plain` (``kernels/route.py``'s
    ``gate_norm`` route)."""
    if route.on_card(y):
        if not is_dtensor(y):
            out = gate_norm(y, xh, z, D, scale, eps)
            route.count("gate_norm", kernel=True)
            return out
        route.count("gate_norm", kernel=False)
    return _gate_norm_plain(y, xh, z, D, scale, eps, dtype)


def _gate_norm_plain(y, xh, z, D, scale, eps, dtype):
    """:func:`_gate_norm` in plain PyTorch, the JAX package's lines: the
    kernels are held against it."""
    B, S, H, _ = xh.shape
    y = y + D[None, None, :, None] * xh.float()
    y = gather_grad_unless_divides(y.reshape(B, S, -1), 2, H).to(dtype)
    y = y * F.silu(z)
    return apply_norm({"scale": scale}, y, "rmsnorm", eps)


def mamba_step(p: Params, cfg: ModelConfig, u: torch.Tensor,
               state: Dict[str, torch.Tensor], norm_eps: float = 1e-6
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token recurrent step (decode).  u: (B, 1, d_model).  The
    SSM state stays float32 whatever the model dtype."""
    B, _, d = u.shape
    di, N, H, P = cfg.d_inner(), cfg.ssm_state, cfg.ssm_heads(), cfg.ssm_head_dim
    proj = u[:, 0] @ p["in_proj"]                                 # (B, .)
    z, xbc, dt = _split_proj(cfg, proj)
    # conv step: append to the rolling window
    win = torch.cat([state["conv"], xbc[:, None, :]], dim=1)      # (B,K,C)
    y_conv = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(y_conv)
    new_conv = win[:, 1:, :]
    xs, Bm, Cm = torch.split(xbc1, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    A = -torch.exp(p["A_log"])
    xh = gather_unless_divides(xs, 1, H).reshape(B, H, P).float()
    h = state["ssm"]                                              # (B,H,P,N)
    decay = torch.exp(dt * A)[:, :, None, None]
    h_new = h * decay + torch.einsum("bh,bn,bhp->bhpn", dt, Bm.float(), xh)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h_new)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(B, di).to(u.dtype) * F.silu(z)
    y = apply_norm({"scale": p["norm_scale"]}, y, "rmsnorm", norm_eps)
    out = constrain_residual((y @ p["out_proj"])[:, None, :])
    return out, {"ssm": h_new, "conv": new_conv}
