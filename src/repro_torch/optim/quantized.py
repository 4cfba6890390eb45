"""8-bit AdamW moments (row-wise quantized state).

The JAX package's ``optim/quantized.py``: int8 moments with an absmax
scale per last-dim row, dequantized, updated in float32 and requantized
inside the step; 1/4 of the float32 state's bytes and a bit more.  The
int8 tensor keeps the parameter's shape and the scales drop its last
dim.

As in the reference, the update decays every leaf (it takes no decay
mask), and rounds half to even (``torch.round``, as ``jnp.round``).
Parameters and states are updated in place, a block of rows at a time
(quantization is per row, so blocks of whole rows give the same bits).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..dist.sharding import is_dtensor
from ..utils import tree_map
from .adamw import (AdamWConfig, _leaves, _require_contiguous,
                    bias_corrections, clip_scale, global_norm, row_blocks,
                    rows, step0)

__all__ = ["QuantOptState", "init_opt_q8", "apply_updates_q8",
           "quantize_rows", "dequantize_rows"]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., n) -> (int8 same shape, f32 scales (...,))."""
    xf = x.float()
    if xf.ndim == 0:
        s = torch.clamp(torch.abs(xf), min=1e-12) / 127.0
        return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s
    s = torch.amax(torch.abs(xf), dim=-1) / 127.0
    s = torch.clamp(s, min=1e-20)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    if q.ndim == 0:
        return q.float() * s
    return q.float() * s[..., None]


class QuantOptState(NamedTuple):
    step: torch.Tensor
    mu_q: Any          # int8 tree, param-shaped
    mu_s: Any          # fp32 row scales, param.shape[:-1]
    nu_q: Any
    nu_s: Any


def _zeros_q(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.int8, device=p.device)


def _zeros_s(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape[:-1] if p.ndim else (), dtype=torch.float32,
                       device=p.device)


def init_opt_q8(params: Any) -> QuantOptState:
    return QuantOptState(step=step0(params),
                         mu_q=tree_map(_zeros_q, params),
                         mu_s=tree_map(_zeros_s, params),
                         nu_q=tree_map(_zeros_q, params),
                         nu_s=tree_map(_zeros_s, params))


@torch.no_grad()
def apply_updates_q8(cfg: AdamWConfig, params: Any, grads: Any,
                     state: QuantOptState, lr_scale=1.0
                     ) -> Tuple[Any, QuantOptState, Dict[str, torch.Tensor]]:
    """One AdamW step over 8-bit moments; updates ``params`` and
    ``state``'s tensors in place."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    b1c, b2c = bias_corrections(cfg, step)
    lr = cfg.lr * lr_scale

    for p, g, mq, ms, vq, vs in zip(*_leaves(
            params, grads, state.mu_q, state.mu_s, state.nu_q, state.nu_s)):
        _require_contiguous(p, mq, ms, vq, vs)
        if p.ndim == 0:                 # a scalar: its own quantizer
            _update_q8(cfg, p, g, mq, ms, vq, vs, scale, b1c, b2c, lr)
            continue
        p2, g2, mq2, vq2 = rows(p), rows(g), rows(mq), rows(vq)
        ms2, vs2 = ((ms, vs) if is_dtensor(p)
                    else (ms.reshape(-1), vs.reshape(-1)))
        for b in row_blocks(p):
            _update_q8(cfg, p2[b], g2[b], mq2[b], ms2[b], vq2[b], vs2[b],
                       scale, b1c, b2c, lr)
    return params, QuantOptState(step, state.mu_q, state.mu_s, state.nu_q,
                                 state.nu_s), {"grad_norm": gnorm}


def _update_q8(cfg, p, g, mq, ms, vq, vs, scale, b1c, b2c, lr):
    """The reference's per-leaf q8 update on views, written in place."""
    g = g.float() * scale
    m = dequantize_rows(mq, ms)
    v = dequantize_rows(vq, vs)
    m = cfg.b1 * m + (1.0 - cfg.b1) * g
    v = cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g)
    delta = (m / b1c) / (torch.sqrt(torch.clamp(v, min=0.0) / b2c) + cfg.eps)
    pf = p.float()
    p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
    for q, s, x in ((mq, ms, m), (vq, vs, v)):
        q2, s2 = quantize_rows(x)
        q.copy_(q2)
        s.copy_(s2)
