"""Plain float32 reference of Zamba2 in its published form
(arXiv:2411.15242; transformers' ``models/zamba2/modeling_zamba2.py``)
that the benchmark trains.

Written from the published equations, not from the measured program,
and importing nothing of it.  The Mamba2 layers are ``ssm_ref``'s
(its mixer with this model's norm epsilon, its chunked SSD); at each
hybrid layer j one of ``num_mem_blocks`` shared blocks (j mod their
count) runs on [h, h0], the residual stream beside the embeddings:

    t = RMSNorm(cat([h, h0]))
    a = softmax(rope(t Wq) rope(t Wk)^T / sqrt(hd / 2) + causal) (t Wv) Wo
    g, up = split(RMSNorm(a) Wgu + (RMSNorm(a) A_j) B_j)
    t = ((gelu(g) * up) Wdown) L_j
    h = h + Mamba(RMSNorm(h + t))

The attention is exact softmax over blocks of queries (each block sees
the keys up to its last query), so that a row of 4,096 fits; layers are
recomputed in backward.  Everything runs in float32 with TF32 off
(``ssm_ref.configure``).  For the controls, :class:`Variant` puts a
fault in the program's place: another attention scale, or the shared
blocks fed [h, 0].

Parameters are a flat dict ``{path: tensor}`` with the paths of
:func:`param_spec`, stacked on a leading axis: ``layers/...`` on the
layer, ``shared/...`` on the block, ``sites/...`` on the hybrid layer.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import ssm_ref
from .ssm_ref import INIT_STD, AdamW, Precision, configure, rmsnorm

__all__ = ["Arch", "Variant", "Precision", "AdamW", "configure",
           "param_spec", "hidden", "loss_sum", "train_steps"]

Q_BLOCK = 1024          # queries a block of the reference's attention


@dataclass(frozen=True)
class Arch:
    family: str                 # "zamba2"
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float
    ssm_state: int
    ssm_head_dim: int
    ssm_expand: int
    conv_kernel: int
    norm_eps: float
    adapter_rank: int
    num_mem_blocks: int
    hybrid_layer_ids: Tuple[int, ...]
    tie_embeddings: bool = True
    dtype: str = "bfloat16"     # storage of every leaf but A, D, dt_bias

    @classmethod
    def from_json(cls, model: dict) -> "Arch":
        if model["family"] != "zamba2":
            raise ValueError(f"no reference for family {model['family']!r}")
        if not model.get("tie_embeddings", True):
            raise ValueError("the published form ties its embeddings")
        keys = cls.__dataclass_fields__
        args = {k: v for k, v in model.items() if k in keys}
        args["hybrid_layer_ids"] = tuple(args["hybrid_layer_ids"])
        return cls(**args)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def mamba_arch(self) -> ssm_ref.Arch:
        """The Mamba2 part, as ``ssm_ref`` takes it."""
        return ssm_ref.Arch(
            family="ssm", n_layers=self.n_layers, d_model=self.d_model,
            vocab=self.vocab, ssm_state=self.ssm_state,
            ssm_head_dim=self.ssm_head_dim, ssm_expand=self.ssm_expand,
            conv_kernel=self.conv_kernel, norm_eps=self.norm_eps,
            tie_embeddings=True, dtype=self.dtype)


@dataclass(frozen=True)
class Variant:
    """A fault in the program's place, for the controls: the attention
    scale (None: the published ``1 / sqrt(hd / 2)``), and whether the
    shared blocks see the embeddings (else [h, 0])."""
    attn_scale: Optional[float] = None
    embeddings_in: bool = True


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def param_spec(a: Arch) -> Dict[str, Tuple[Tuple[int, ...], str, str, float]]:
    """``{path: (shape, dtype, fill, std)}`` (``ssm_ref.param_spec``'s
    form): the Mamba2 model's leaves, then the shared blocks' and the
    sites'.  RMSNorm scales are stored as scale - 1."""
    d, f, r, bf = a.d_model, a.d_ff, a.adapter_rank, a.dtype
    width, kv = a.n_heads * a.head_dim, a.n_kv_heads * a.head_dim
    out_std = INIT_STD / math.sqrt(2 * a.n_layers)
    M, T = (a.num_mem_blocks,), (len(a.hybrid_layer_ids),)
    spec = dict(ssm_ref.param_spec(a.mamba_arch()))
    block = {
        "attn_norm/scale": ((2 * d,), "zeros", 0.0),
        "attn/wq": ((2 * d, width), "normal", INIT_STD),
        "attn/wk": ((2 * d, kv), "normal", INIT_STD),
        "attn/wv": ((2 * d, kv), "normal", INIT_STD),
        "attn/wo": ((width, d), "normal", out_std),
        "mlp_norm/scale": ((d,), "zeros", 0.0),
        "mlp/w_gate_up": ((d, 2 * f), "normal", INIT_STD),
        "mlp/w_down": ((f, d), "normal", out_std),
    }
    site = {
        "adapter_a": ((d, r), "normal", INIT_STD),
        "adapter_b": ((r, 2 * f), "normal", INIT_STD),
        "linear": ((d, d), "normal", INIT_STD),
    }
    for k, (shape, fill, std) in block.items():
        spec["shared/" + k] = (M + shape, bf, fill, std)
    for k, (shape, fill, std) in site.items():
        spec["sites/" + k] = (T + shape, bf, fill, std)
    return dict(sorted(spec.items()))


def _split(W: Dict[str, torch.Tensor], prefix: str, n: int
           ) -> List[Dict[str, torch.Tensor]]:
    """The leaves under ``prefix``, stacked on n, as n dicts (one
    ``unbind`` a leaf)."""
    parts = {k[len(prefix):]: torch.unbind(v, 0) for k, v in W.items()
             if k.startswith(prefix)}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (b, s, h, hd) at positions 0..s-1, the
    halves of each head rotated as pairs (i, i + hd / 2)."""
    s, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Exact causal softmax attention, q (b, s, h, hd), k and v (b, s,
    kv, hd), a block of :data:`Q_BLOCK` queries at a time."""
    s, h = q.shape[1], q.shape[2]
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    out = []
    for i0 in range(0, s, Q_BLOCK):
        i1 = min(s, i0 + Q_BLOCK)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, i0:i1], k[:, :i1]) * scale
        qi = torch.arange(i0, i1, device=q.device)[:, None]
        ki = torch.arange(i1, device=q.device)[None, :]
        sc = sc.masked_fill(ki > qi, -torch.inf)
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                v[:, :i1]))
    return torch.cat(out, dim=1)


def shared(a: Arch, bp: Dict[str, torch.Tensor], sp: Dict[str, torch.Tensor],
           h: torch.Tensor, h0: torch.Tensor, prec: Precision,
           var: Variant) -> torch.Tensor:
    """Shared block ``bp`` at the site ``sp``: what it adds to the next
    Mamba layer's input.  h, h0 (b, s, d)."""
    b, s, d = h.shape
    H, K, hd = a.n_heads, a.n_kv_heads, a.head_dim
    q, mm = prec.q, prec.mm
    ctx = h0 if var.embeddings_in else torch.zeros_like(h0)
    t = rmsnorm(torch.cat([h, ctx], dim=-1), bp["attn_norm/scale"],
                a.norm_eps)
    qh = rope(q(mm(t, bp["attn/wq"])).reshape(b, s, H, hd), a.rope_theta)
    kh = rope(q(mm(t, bp["attn/wk"])).reshape(b, s, K, hd), a.rope_theta)
    vh = q(mm(t, bp["attn/wv"])).reshape(b, s, K, hd)
    scale = (1.0 / math.sqrt(hd / 2) if var.attn_scale is None
             else var.attn_scale)
    o = q(causal_attention(q(qh), q(kh), vh, scale)).reshape(b, s, H * hd)
    u = rmsnorm(q(mm(o, bp["attn/wo"])), bp["mlp_norm/scale"], a.norm_eps)
    gu = mm(u, bp["mlp/w_gate_up"]) + mm(q(mm(u, sp["adapter_a"])),
                                         sp["adapter_b"])
    g, up = torch.chunk(q(gu), 2, dim=-1)
    y = q(mm(q(F.gelu(g) * up), bp["mlp/w_down"]))
    return q(mm(y, sp["linear"]))


def hidden(a: Arch, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prec: Precision, var: Variant = Variant(),
           remat: bool = True) -> torch.Tensor:
    """Final-normed hidden states (b, s, d) of ``tokens`` (b, s).  With
    ``remat`` each layer (a hybrid layer with its shared block) is
    recomputed in the backward pass."""
    run = ((lambda f, *xs: checkpoint(f, *xs, use_reentrant=False))
           if remat else (lambda f, *xs: f(*xs)))
    ma = a.mamba_arch()
    site_of = {i: j for j, i in enumerate(a.hybrid_layer_ids)}
    blocks = _split(W, "shared/", a.num_mem_blocks)
    sites = _split(W, "sites/", len(a.hybrid_layer_ids))

    def layer(p, j, x, x0):
        u = x
        if j is not None:
            u = x + shared(a, blocks[j % a.num_mem_blocks], sites[j], x, x0,
                           prec, var)
        return x + ssm_ref.mamba(ma, p, rmsnorm(u, p["ln/scale"], a.norm_eps),
                                 prec)

    x0 = prec.q(W["embed"][tokens])
    x = x0
    for i, p in enumerate(ssm_ref._layers(ma, W)):
        x = prec.q(run(lambda x, x0, p=p, j=site_of.get(i): layer(p, j, x, x0),
                       x, x0))
    return rmsnorm(x, W["final_norm/scale"], a.norm_eps)


def loss_sum(a: Arch, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, prec: Precision,
             var: Variant = Variant(), remat: bool = True) -> torch.Tensor:
    """Summed next-token cross-entropy of a block of rows (logits through
    the tied embedding)."""
    h = hidden(a, W, tokens, prec, var, remat=remat)
    logits = prec.mm(h, W["embed"].t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

def train_steps(a: Arch, W: Dict[str, torch.Tensor], dtypes: Dict[str, str],
                batches: List[Tuple[torch.Tensor, torch.Tensor]],
                opt: AdamW, prec: Precision, rows_per_block: int = 1,
                var: Variant = Variant()) -> Dict[str, object]:
    """``ssm_ref.train_steps`` for this model: ``len(batches)`` AdamW
    steps from the float32 weights ``W`` (updated in place, rounded after
    each step to ``dtypes[path]``), each batch's mean loss summed over
    blocks of ``rows_per_block`` rows.  The update runs in place, leaf by
    leaf, so that at most two temporaries of a leaf live beside the
    moments.  Returns each step's loss and the first step's clipped
    gradient as per-leaf norms."""
    paths = list(W)
    pat = re.compile(opt.no_decay)
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for t, (tokens, targets) in enumerate(batches):
        for w in W.values():
            w.requires_grad_(True)
            w.grad = None
        total = 0.0
        n_tok = tokens.numel()
        for r in range(0, tokens.shape[0], rows_per_block):
            part = loss_sum(a, W, tokens[r:r + rows_per_block],
                            targets[r:r + rows_per_block], prec, var) / n_tok
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {k: W[k].grad for k in paths}
            gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                                  for g in grads.values()))
            scale = min(1.0, opt.clip_norm / max(gnorm, 1e-9))
            if t == 0:
                first_grad = {k: float(g.norm()) * scale
                              for k, g in grads.items()}
            lr = opt.lr_at(t)
            b1c, b2c = 1 - opt.b1 ** (t + 1), 1 - opt.b2 ** (t + 1)
            for k in paths:
                w = W[k]
                w.requires_grad_(False)
                g = grads[k].mul_(scale)
                w.grad = None
                m[k].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                v2[k].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                del g
                upd = m[k] / b1c
                upd.div_((v2[k] / b2c).sqrt_().add_(opt.eps))
                if not pat.search(k):
                    upd.add_(w, alpha=opt.weight_decay)
                w.sub_(upd, alpha=lr)
                del upd
                w.copy_(w.to(getattr(torch, dtypes[k])).float())
            del grads
    return {"losses": losses, "first_grad": first_grad}
