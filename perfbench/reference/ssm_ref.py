"""Plain float32 reference of the Mamba2 language model (attention-free
SSD blocks, arXiv:2405.21060) that the benchmark trains.

Written from the paper's equations, not from the measured program, and
importing nothing of it: the SSD is the paper's minimal chunked form
(``segsum`` and the state passing as one matrix of chunk decays), the
causal convolution is ``conv1d``.  Everything runs in float32 with TF32
off (:func:`configure`).  For the benchmark's controls it runs one step
of precision down: ``Precision("fp8")`` (float8 where the program holds
bf16) or ``Precision("bf16ssd")`` (the SSD in bf16, everything else
float32).

Parameters are a flat dict ``{path: tensor}`` with the paths of
:func:`param_spec`; layers are stacked on a leading axis ``(L, ...)``.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["Arch", "Precision", "configure", "param_spec", "hidden",
           "loss_sum", "AdamW", "train_steps"]

SSD_BLOCK = 64          # the reference's own chunk: exact for any length
INIT_STD = 0.02


def configure() -> None:
    """float32 products stay float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Arch:
    family: str                 # "ssm"
    n_layers: int
    d_model: int
    vocab: int
    ssm_state: int
    ssm_head_dim: int
    ssm_expand: int
    conv_kernel: int
    norm_eps: float
    tie_embeddings: bool = True
    dtype: str = "bfloat16"     # storage of every leaf but A, D, dt_bias

    @classmethod
    def from_json(cls, model: dict) -> "Arch":
        if model["family"] != "ssm":
            raise ValueError(f"no reference for family {model['family']!r}")
        keys = cls.__dataclass_fields__
        return cls(**{k: v for k, v in model.items() if k in keys})

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` after scaling the tensor so
    that its largest magnitude is the format's largest."""
    s = largest / t.abs().amax().clamp(min=1e-30)
    return (t * s).to(dtype).to(torch.float32) / s


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3 forward, gradients to e5m2 backward (the
    usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Precision:
    """How the reference computes: ``"f32"`` exactly; ``"fp8"``, where
    every product's operands, and every activation that the program
    holds in bf16 (projections, the conv, the gated SSD output, block
    outputs, the residual stream), are rounded to float8 e4m3 and their
    gradients to e5m2, each tensor scaled to its format's range, the
    SSD and norms staying float32 (the program's bf16, one step down);
    or ``"bf16ssd"``, where the SSD alone runs in bf16 (its inputs,
    decays, segment sums and products) and everything else in float32
    (the program's float32 SSD, one step down)."""

    KINDS = ("f32", "fp8", "bf16ssd")

    def __init__(self, kind: str = "f32"):
        if kind not in self.KINDS:
            raise ValueError(kind)
        self.kind = kind
        self.ssd_dtype = torch.bfloat16 if kind == "bf16ssd" else torch.float32

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.kind == "fp8" else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def param_spec(a: Arch) -> Dict[str, Tuple[Tuple[int, ...], str, str, float]]:
    """``{path: (shape, dtype, fill, std)}``; fill is ``normal`` (std),
    ``zeros``, ``ones`` or ``log_linspace`` (Mamba2's A: log of 1..16
    spread over the heads).  RMSNorm scales are stored as scale - 1.
    Leaves are stored in ``a.dtype``, the SSD's per-head A, D and dt bias
    in float32."""
    d, di, N, H, K = a.d_model, a.d_inner, a.ssm_state, a.heads, a.conv_kernel
    lead = (a.n_layers,)
    out_std = INIT_STD / math.sqrt(2 * a.n_layers)
    bf, f32 = a.dtype, "float32"
    layer = {
        "ln/scale": ((d,), bf, "zeros", 0.0),
        "mamba/in_proj": ((d, 2 * di + 2 * N + H), bf, "normal", INIT_STD),
        "mamba/conv_w": ((K, di + 2 * N), bf, "normal", 0.2),
        "mamba/conv_b": ((di + 2 * N,), bf, "zeros", 0.0),
        "mamba/dt_bias": ((H,), f32, "zeros", 0.0),
        "mamba/A_log": ((H,), f32, "log_linspace", 0.0),
        "mamba/D": ((H,), f32, "ones", 0.0),
        "mamba/norm_scale": ((di,), bf, "zeros", 0.0),
        "mamba/out_proj": ((di, d), bf, "normal", out_std),
    }
    spec = {"embed": ((a.vocab, d), bf, "normal", INIT_STD),
            "final_norm/scale": ((d,), bf, "zeros", 0.0)}
    for k, (shape, dt, fill, std) in layer.items():
        spec["layers/" + k] = (lead + shape, dt, fill, std)
    if not a.tie_embeddings:
        spec["head"] = ((d, a.vocab), bf, "normal", INIT_STD)
    return dict(sorted(spec.items()))


def _layers(a: Arch, W: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Each Mamba2 layer's leaves (``in_proj``, ``ln/scale``, ...), in
    order, each stacked leaf split by one ``unbind`` (so its gradient is
    gathered by one ``stack``)."""
    split = {k.split("/", 1)[1].replace("mamba/", ""): torch.unbind(v, 0)
             for k, v in W.items() if k.startswith("layers/")}
    return [{k: v[i] for k, v in split.items()} for i in range(a.n_layers)]


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale_minus_1: torch.Tensor,
            eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * (1.0 + scale_minus_1)


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum(x[..., j+1 : i+1])`` for i >= j, -inf above
    the diagonal (the paper's stable segment sum)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~keep, -torch.inf)


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        block: int = SSD_BLOCK) -> torch.Tensor:
    """Mamba2's SSD, the paper's minimal chunked form.  X (b, s, h, p)
    (inputs times dt), A (b, s, h) (dt times the decay rate), B, C
    (b, s, n) shared by the heads; s a multiple of ``block``.  Returns Y
    (b, s, h, p) from a zero initial state, in the inputs' dtype."""
    b, s, h, p = X.shape
    c = s // block
    X = X.reshape(b, c, block, h, p)
    B = B.reshape(b, c, block, -1)
    C = C.reshape(b, c, block, -1)
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)          # b h c l
    A_cs = torch.cumsum(A, dim=-1)
    # 1. within each chunk
    L = torch.exp(segsum(A))                                   # b h c l s
    CB = torch.einsum("bcln,bcsn->bcls", C, B)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, X)
    # 2. each chunk's final state
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)            # b h c l
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, decay_states, X)
    # 3. the states passed between chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cs[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    # 4. each chunk's incoming state to its outputs
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cs))
    return (Y_diag + Y_off).reshape(b, s, h, p)


def mamba(a: Arch, p: Dict[str, torch.Tensor], u: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """One Mamba2 mixer: in-projection, causal depthwise conv, SSD, D
    skip, gate, RMSNorm, out-projection.  u (b, s, d)."""
    b, s, _ = u.shape
    di, N, H, P = a.d_inner, a.ssm_state, a.heads, a.ssm_head_dim
    q = prec.q
    z, xbc, dt = torch.split(q(prec.mm(u, p["in_proj"])), [di, di + 2 * N, H],
                             dim=-1)
    w = p["conv_w"].t()[:, None, :]                            # (ch, 1, K)
    xbc = q(F.conv1d(F.pad(xbc.transpose(1, 2), (a.conv_kernel - 1, 0)), w,
                     bias=p["conv_b"], groups=w.shape[0]).transpose(1, 2))
    x, Bm, Cm = torch.split(q(F.silu(xbc)), [di, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])                         # (b, s, H)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, H, P)
    pad = (-s) % SSD_BLOCK           # zero steps at the end change nothing
    sd = prec.ssd_dtype
    Xd = F.pad(xh * dt[..., None], (0, 0, 0, 0, 0, pad))
    y = ssd(Xd.to(sd), F.pad(dt * A, (0, 0, 0, pad)).to(sd),
            F.pad(Bm, (0, 0, 0, pad)).to(sd),
            F.pad(Cm, (0, 0, 0, pad)).to(sd))[:, :s].float()
    y = q(q((y + p["D"][:, None] * xh).reshape(b, s, di)) * F.silu(z))
    return q(prec.mm(rmsnorm(y, p["norm_scale"], a.norm_eps), p["out_proj"]))


def hidden(a: Arch, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
           prec: Precision, remat: bool = False) -> torch.Tensor:
    """Final-normed hidden states (b, s, d) of ``tokens`` (b, s).  With
    ``remat`` each layer is recomputed in the backward pass."""
    run = ((lambda f, *xs: checkpoint(f, *xs, use_reentrant=False))
           if remat else (lambda f, *xs: f(*xs)))

    def mixer_layer(p, x):
        return x + mamba(a, p, rmsnorm(x, p["ln/scale"], a.norm_eps), prec)

    x = prec.q(W["embed"][tokens])
    for p in _layers(a, W):
        x = prec.q(run(lambda x, p=p: mixer_layer(p, x), x))
    return rmsnorm(x, W["final_norm/scale"], a.norm_eps)


def _head(a: Arch, W: Dict[str, torch.Tensor]) -> torch.Tensor:
    return W["embed"].t() if a.tie_embeddings else W["head"]


def loss_sum(a: Arch, W: Dict[str, torch.Tensor], tokens: torch.Tensor,
             targets: torch.Tensor, prec: Precision,
             remat: bool = True) -> torch.Tensor:
    """Summed next-token cross-entropy of a block of rows."""
    h = hidden(a, W, tokens, prec, remat=remat)
    logits = prec.mm(h, _head(a, W))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


# ----------------------------------------------------------------------
# training
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    """AdamW with decoupled weight decay (Loshchilov and Hutter), the
    gradient clipped to a global norm first, a linear warmup and a
    cosine decay to ``floor`` of the learning rate, and no decay on the
    leaves whose path matches ``no_decay``.  Moments in float32."""
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip_norm: float
    no_decay: str
    warmup_steps: int
    total_steps: int
    floor: float = 0.1

    def lr_at(self, t: int) -> float:
        """The rate of the step that follows ``t`` earlier steps."""
        warm = min(t / max(1, self.warmup_steps), 1.0)
        prog = min(max((t - self.warmup_steps)
                       / max(1, self.total_steps - self.warmup_steps), 0.0),
                   1.0)
        cos = self.floor + (1 - self.floor) * 0.5 * (1 + math.cos(math.pi * prog))
        return self.lr * warm * cos


def train_steps(a: Arch, W: Dict[str, torch.Tensor], dtypes: Dict[str, str],
                batches: List[Tuple[torch.Tensor, torch.Tensor]],
                opt: AdamW, prec: Precision, rows_per_block: int = 1
                ) -> Dict[str, object]:
    """Run ``len(batches)`` AdamW steps from the weights ``W`` (float32,
    updated in place and rounded after each step to the storage dtype
    ``dtypes[path]`` that the configuration states).  Each batch is
    (tokens, targets) of shape (B, S); the loss is the mean over its
    tokens, its gradient summed over blocks of ``rows_per_block`` rows.
    Returns each step's loss and the first step's clipped gradient as
    per-leaf norms."""
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
                            targets[r:r + rows_per_block], prec) / n_tok
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
                g = grads[k] * scale
                m[k].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                v2[k].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                upd = (m[k] / b1c) / ((v2[k] / b2c).sqrt() + opt.eps)
                wd = 0.0 if pat.search(k) else opt.weight_decay
                w.sub_(lr * (upd + wd * w))
                w.copy_(w.to(getattr(torch, dtypes[k])).float())
                w.grad = None
    return {"losses": losses, "first_grad": first_grad}
