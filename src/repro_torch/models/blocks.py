"""Transformer building blocks shared by the model zoo.

The JAX package's ``models/blocks.py`` in PyTorch.  Every block is an
``init_*(cfg, dtype) -> spec`` plus an ``apply_*(params, x, ...)`` plain
function on tensors; a spec is a nested dict of :class:`Leaf`
descriptors (shape, dtype, how to draw it), so a model's parameter tree
is declared once and materialised on any device (``"meta"`` included).
The LM classes hold their tree in an :class:`LMModule`, whose
``state_dict`` keys are the JAX package's parameter paths with ``.`` for
``/`` (layers stacked on a leading ``L`` axis, as its ``jax.vmap(init)``
makes them).

Covers every attention flavour in the assignment: GQA, RoPE and M-RoPE,
QKV bias, attention/logit soft-capping, sliding-window masks (the
window a per-layer int, so gemma2's local/global alternation is one
loop), and KV-cache decode.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..dist.sharding import (batch_heads_placements, batch_only,
                              constrain_attn_qkv, constrain_residual,
                              gather_grad_unless_divides,
                              gather_unless_divides, is_dtensor, local_call,
                              summed_placements)
from ..kernels import route
from ..utils import leaves_with_paths, resolve_device

__all__ = [
    "init_norm", "apply_norm", "init_attention", "apply_attention",
    "init_mlp", "apply_mlp", "init_moe", "apply_moe",
    "rope", "mrope", "make_positions", "softcap",
    "attention_core", "Params",
    "Leaf", "LMModule", "stack_spec", "layer_params", "torch_dtype",
    "masked_ce", "ce_sum", "embed_lookup",
]

Params = Dict[str, Any]

_INIT_STD = 0.02


# ----------------------------------------------------------------------
# Parameter specs and the module that holds them
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, dtype and how ``init`` draws it —
    ``normal`` (mean 0, ``std``), ``zeros``, ``ones`` or ``log_linspace``
    (``log(linspace(1, 16, n))`` along the last axis: Mamba2's A_log)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    fill: str
    std: float = 0.0

    def draw_(self, t: torch.Tensor, generator: torch.Generator) -> None:
        if self.fill == "normal":
            t.normal_(0.0, self.std, generator=generator)
        elif self.fill == "zeros":
            t.zero_()
        elif self.fill == "ones":
            t.fill_(1.0)
        elif self.fill == "log_linspace":
            n = self.shape[-1]
            t.copy_(torch.log(torch.linspace(1.0, 16.0, n,
                                             dtype=torch.float32,
                                             device=t.device)).expand_as(t))
        else:
            raise ValueError(f"unknown fill {self.fill!r}")


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dense_init(shape, dtype, std=_INIT_STD) -> Leaf:
    return Leaf(tuple(shape), dtype, "normal", std)


def stack_spec(spec: Params, lead: Tuple[int, ...]) -> Params:
    """``spec`` with ``lead`` prepended to every leaf's shape (the
    layer-stacked layout ``jax.vmap(init)`` makes)."""
    return {k: (stack_spec(v, lead) if isinstance(v, dict)
                else replace(v, shape=tuple(lead) + v.shape))
            for k, v in spec.items()}


def layer_params(tree: Params, *idx: int) -> Params:
    """The slice ``[idx]`` of every leaf of a stacked tree (views)."""
    return {k: (layer_params(v, *idx) if isinstance(v, dict) else v[idx])
            for k, v in tree.items()}


def unstack_layers(tree: Params) -> List[Params]:
    """A tree stacked on its leading axis as the list of its per-layer
    trees (views), each leaf split by one ``torch.unbind``.  Autograd
    then gathers a leaf's gradient with one ``stack``, as the JAX
    package's scan writes each layer's slice; indexing each layer
    (``layer_params``) would add a zero-filled gradient of the whole
    leaf per layer instead."""
    split = {k: (unstack_layers(v) if isinstance(v, dict)
                 else torch.unbind(v, 0)) for k, v in tree.items()}
    n = len(next(iter(split.values())))
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


class ParamTree(nn.Module):
    """A nested dict of parameters as nested modules: the parameter at
    path ``a/b/c`` is ``state_dict()["a.b.c"]``."""

    def _set_tree(self, tree: Dict[str, Any]) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = ParamTree()
                sub._set_tree(v)
                self.add_module(k, sub)
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=v.is_floating_point()))

    def tree(self) -> Params:
        """The parameters as the JAX package's nested dict."""
        out: Params = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LMModule(ParamTree):
    """Base of the four LM families: declares its tree with
    ``_param_spec()``, allocates it on ``device`` (the card unless asked
    for the CPU; ``"meta"`` for shapes only) and draws it with
    :meth:`init`."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        dev = (torch.device("meta") if str(device) == "meta"
               else resolve_device(device))
        self._spec = dict(leaves_with_paths(self._param_spec()))
        tree: Params = {}
        for path, leaf in self._spec.items():
            *outer, name = path.split("/")
            node = tree
            for key in outer:
                node = node.setdefault(key, {})
            node[name] = torch.empty(leaf.shape, dtype=leaf.dtype,
                                     device=dev)
        self._set_tree(tree)
        self.init(generator)

    def _param_spec(self) -> Params:
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def params(self) -> Params:
        return self.tree()

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """float32 logits of the final-normed hidden states: tied to the
        embedding or through ``head``, soft-capped."""
        cfg = self.cfg
        h = batch_only(apply_norm(params["final_norm"], h, cfg.norm_kind))
        w = params["embed"].T if cfg.tie_embeddings else params["head"]
        return softcap((h @ w.to(h.dtype)).float(), cfg.logit_softcap)

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter, in path order, from ``generator`` (a
        ``torch.Generator`` on the model's device; seed 0 when None) with
        the JAX package's std and out-projection scaling.  Returns self."""
        dev = self.device
        if dev.type == "meta":
            return self
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for path, leaf in self._spec.items():
            leaf.draw_(self.get_parameter(path.replace("/", ".")),
                       generator)
        return self


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  On a DTensor each rank looks up its batch rows
    in its own rows of the table (a vocab-parallel embedding: tokens
    outside them give zeros, summed across the ranks that split the
    vocabulary)."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    row, _ = batch_heads_placements(mesh, tokens.shape[0], ())
    vocab = [i for i, q in enumerate(table.placements)
             if q.is_shard() and q.dim == 0]
    tab_pl = tuple(Shard(0) if i in vocab else Replicate()
                   for i in range(mesh.ndim))
    out_pl = tuple(Partial() if i in vocab else row[i]
                   for i in range(mesh.ndim))
    part = 0
    coord = mesh.get_coordinate()
    for i in vocab:
        part = part * mesh.size(i) + coord[i]

    def body(tab, tok):
        n = tab.shape[0]
        idx = tok.long() - part * n
        ok = (idx >= 0) & (idx < n)
        return tab[torch.clamp(idx, 0, n - 1)] * ok[..., None].to(tab.dtype)

    return local_call(body, mesh, (table, tokens), (tab_pl, row), out_pl)


def ce_sum(logits: torch.Tensor, targets: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Sum of next-token CE over the positions ``mask`` keeps.  On a
    DTensor each rank sums its batch rows over the whole vocabulary."""
    if is_dtensor(logits):
        mesh = logits.device_mesh
        row, _ = batch_heads_placements(mesh, logits.shape[0], ())
        return local_call(ce_sum, mesh, (logits, targets, mask),
                          (row, row, row), summed_placements(row))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum()


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over the positions ``mask`` keeps."""
    return ce_sum(logits, targets, mask) / torch.clamp(mask.sum(), min=1.0)


# ----------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------

def init_norm(cfg: ModelConfig, dtype) -> Params:
    d = cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": Leaf((d,), dtype, "ones"),
                "bias": Leaf((d,), dtype, "zeros")}
    return {"scale": Leaf((d,), dtype, "zeros")}   # rmsnorm stores (scale - 1)


def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    ms = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


# ----------------------------------------------------------------------
# Rotary embeddings (RoPE and M-RoPE)
# ----------------------------------------------------------------------

def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x: torch.Tensor, cos: torch.Tensor,
            sin: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Apply rotary embedding.  x: (B, S, H, hd); positions: (B, S)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * _freqs(half, theta, x.device)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Tuple[int, int, int] = (16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: three position streams (temporal, height,
    width) rotate disjoint head-dim sections.  positions3: (3, B, S);
    ``sections`` are half-dim section sizes (sum = head_dim/2)."""
    half = x.shape[-1] // 2
    secs = list(sections)
    if sum(secs) != half:          # scale sections for reduced configs
        base = half // 3
        secs = [half - 2 * base, base, base]
    # pick which position stream drives each frequency index
    stream = torch.cat([torch.full((s,), i, dtype=torch.long,
                                   device=x.device)
                        for i, s in enumerate(secs)])
    pos = positions3.float().permute(1, 2, 0)[..., stream]   # (B, S, half)
    ang = pos * _freqs(half, theta, x.device)
    return _rotate(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


def make_positions(batch: int, seq: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.long, device=device)[None, :]
            + offset).expand(batch, seq)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

def init_attention(cfg: ModelConfig, dtype) -> Params:
    d, hd = cfg.d_model, cfg.hd()
    H, K = cfg.n_heads, cfg.n_kv_heads
    p: Params = {
        "wq": _dense_init((d, H * hd), dtype),
        "wk": _dense_init((d, K * hd), dtype),
        "wv": _dense_init((d, K * hd), dtype),
        "wo": _dense_init((H * hd, d), dtype,
                          std=_INIT_STD / math.sqrt(2 * max(1, cfg.n_layers))),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((H * hd,), dtype, "zeros")
        p["bk"] = Leaf((K * hd,), dtype, "zeros")
        p["bv"] = Leaf((K * hd,), dtype, "zeros")
    return p


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
               causal: bool) -> torch.Tensor:
    """Additive float32 mask (B, 1, Sq, Skv) from positions: 0 where a
    query sees a key, -1e30 elsewhere.  ``window`` 0 => global."""
    dist = q_pos[:, :, None] - kv_pos[:, None, :]          # (B, Sq, Skv)
    ok = torch.ones_like(dist, dtype=torch.bool)
    if causal:
        ok = ok & (dist >= 0)
    if window > 0:
        ok = ok & (dist < window)
    return torch.where(ok, 0.0, -1e30)[:, None, :, :]


_FUSED_MAX_HD = 256


def _fused_applies(q, k, v, causal, window, attn_cap, fused_ok):
    """Whether a call takes :func:`_attention_fused`: bf16 tensors on the
    card (a trace's fakes hold no data), causal self-attention over plain
    positions with no cache, no window and no soft-cap, hd <= 256."""
    return (fused_ok and causal and not window and not attn_cap
            and route.on_card(q)
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[1] == k.shape[1]
            and q.shape[-1] <= _FUSED_MAX_HD)


def _attention_fused(q, k, v, scale):
    """Causal attention by ``scaled_dot_product_attention`` on the flash
    or cuDNN backend (never the math one), forward and backward; K/V
    heads repeated to the query heads' count."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = q.shape[2] // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale)
    return o.transpose(1, 2)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   attn_cap: float = 0.0, kv_chunk: int = 0,
                   scale: Optional[float] = None,
                   fused_ok: bool = False) -> torch.Tensor:
    """Grouped-query attention core.

    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd); H a multiple of K.  Scores
    and softmax in float32 whatever the model dtype (q is scaled in its
    own dtype first, as the JAX package scales it), by ``scale``
    (default ``1 / sqrt(hd)``).  ``kv_chunk`` > 0 switches to the
    online-softmax streaming form (exact, bounded memory).

    ``fused_ok`` is the caller's leave to take the fused kernel, given
    only where q_pos and kv_pos are both 0..S-1 in every row
    (self-attention with no cache).  Then a causal call on bf16 tensors
    on the card with no window or soft-cap and hd <= 256 runs as the
    fused kernel (:func:`_attention_fused`, memory linear in S, its
    backward on the card too); every other call runs the einsum
    (``kernels/route.py``'s ``attention`` route, which counts both).
    The training losses of the Zamba2 models give it; the dense and MoE
    decoders' do not, since the 40-step loss drop of qwen2-0.5b's
    full-width bf16 drive in ``chip_smoke.py`` (0.05 at least, 0.052 with
    the einsum at its seed) swings with the rounding: 0.03-0.11 over
    three seeds on either path, 0.027 with the fused kernel at that seed,
    though the two paths' first gradients lie equally close to a float32
    model's (cosine 0.99965 each).  On DTensors the body runs on
    each rank's batch rows and heads
    (:func:`~..dist.sharding.batch_heads_placements`), always as the
    einsum.
    """
    if is_dtensor(q) or is_dtensor(k):
        mesh = (q if is_dtensor(q) else k).device_mesh
        row, head = batch_heads_placements(mesh, q.shape[0],
                                           (q.shape[2], k.shape[2]))
        body = functools.partial(attention_core, causal=causal,
                                 window=window, attn_cap=attn_cap,
                                 kv_chunk=kv_chunk, scale=scale)
        return local_call(body, mesh, (q, k, v, q_pos, kv_pos),
                          (head, head, head, row, row), head)
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if _fused_applies(q, k, v, causal, window, attn_cap, fused_ok):
        out = _attention_fused(q, k, v, scale)
        route.count("attention", kernel=True)
        return out
    if route.on_card(q):
        route.count("attention", kernel=False)
    qf = (q * scale).float().reshape(B, Sq, K, G, hd)
    kf = k.float()
    vf = v.float()

    if not kv_chunk or kv_chunk >= k.shape[1]:
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf)
        s = softcap(s, attn_cap)
        bias = _mask_bias(q_pos, kv_pos, window, causal)   # (B,1,Sq,Skv)
        s = s + bias[:, :, None, :, :]
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        return o.reshape(B, Sq, H, hd).to(q.dtype)

    # ---- streaming online-softmax over KV chunks -----------------------
    Skv = k.shape[1]
    n_chunks = (Skv + kv_chunk - 1) // kv_chunk
    pad = n_chunks * kv_chunk - Skv
    kf = F.pad(kf, (0, 0, 0, 0, 0, pad))
    vf = F.pad(vf, (0, 0, 0, 0, 0, pad))
    kvp = F.pad(kv_pos, (0, pad), value=2**30)

    m = torch.full((B, K, G, Sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, G, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, sl])
        s = softcap(s, attn_cap)
        bias = _mask_bias(q_pos, kvp[:, sl], window, causal)  # (B,1,Sq,c)
        s = s + bias[:, :, None, :, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked chunks (max = -inf)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bkgqs,bskd->bkgqd", p, vf[:, sl]))
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]          # (B,K,G,Sq,hd)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return o.to(q.dtype)


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len: Optional[int] = None,
                    causal: bool = True, window: int = 0,
                    kv_chunk: int = 0, fused_ok: bool = False,
                    ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Full attention block (projections + core + output).

    Modes:
      * self-attention over x (training / prefill): kv=None, cache=None;
        ``fused_ok`` lets the core take its fused kernel, given only
        where ``positions`` are 0..S-1 in every row (see
        :func:`attention_core`);
      * cross-attention: kv = (k_pre, v_pre) precomputed encoder K/V;
      * cached decode: ``cache=(k_cache, v_cache)`` with ``cache_len``
        giving the number of valid positions; x is the new token(s).
        The new K/V are written into the cache tensors in place.
    Returns (output, new_cache_or_None).
    """
    B, S, d = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    x = batch_only(x)

    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = gather_unless_divides(q, 2, H).reshape(B, S, H, hd)

    if kv is None:
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        k = gather_unless_divides(k, 2, K).reshape(B, S, K, hd)
        v = gather_unless_divides(v, 2, K).reshape(B, S, K, hd)
        if cfg.mrope and positions.ndim == 3:
            q = mrope(q, positions, cfg.rope_theta)
            k = mrope(k, positions, cfg.rope_theta)
            pos2d = positions[0]
        elif cfg.rope_theta > 0 and cfg.family != "encdec":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            pos2d = positions
        else:
            pos2d = positions if positions.ndim == 2 else positions[0]
    else:
        k, v = kv
        pos2d = positions if positions.ndim == 2 else positions[0]

    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        Smax = k_cache.shape[1]
        start = int(cache_len)
        # insert the new K/V at cache_len, clamped so the update fits
        # (as lax.dynamic_update_slice clamps it)
        at = min(max(start, 0), Smax - S)
        k_cache[:, at:at + S] = k.to(k_cache.dtype)
        v_cache[:, at:at + S] = v.to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        k, v = k_cache, v_cache
        kv_pos = torch.arange(Smax, dtype=torch.long,
                              device=x.device)[None, :].expand(B, Smax)
        # positions beyond cache_len + S are invalid -> mask via huge pos
        kv_pos = torch.where(kv_pos < start + S, kv_pos, 2**30)
    elif kv_positions is not None:
        kv_pos = kv_positions
    else:
        kv_pos = pos2d

    q, k, v = constrain_attn_qkv(q, k, v)
    o = attention_core(q, k, v, pos2d, kv_pos, causal=causal, window=window,
                       attn_cap=cfg.attn_softcap, kv_chunk=kv_chunk,
                       fused_ok=(fused_ok and kv is None
                                        and cache is None))
    # the row-parallel product's partial sums meet the residual stream
    # here (Megatron's all-reduce; a reduce-scatter under sequence
    # parallelism); the identity on one device
    o = gather_grad_unless_divides(o.reshape(B, S, H * hd), 2, H)
    out = constrain_residual(o @ p["wo"])
    return out, new_cache


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, dtype, d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    out_std = _INIT_STD / math.sqrt(2 * max(1, cfg.n_layers))
    if cfg.mlp_kind == "silu_gated":
        return {"w_gate": _dense_init((d, f), dtype),
                "w_up": _dense_init((d, f), dtype),
                "w_down": _dense_init((f, d), dtype, std=out_std)}
    return {"w_up": _dense_init((d, f), dtype),
            "w_down": _dense_init((f, d), dtype, std=out_std)}


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = batch_only(x)
    if cfg.mlp_kind == "silu_gated":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if cfg.mlp_kind == "sq_relu":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    return constrain_residual(h @ p["w_down"])


# ----------------------------------------------------------------------
# Mixture of Experts
# ----------------------------------------------------------------------

def init_moe(cfg: ModelConfig, dtype) -> Params:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_ff()
    out_std = _INIT_STD / math.sqrt(2 * max(1, cfg.n_layers))
    p: Params = {
        "router": _dense_init((d, E), torch.float32),
        "w_gate": _dense_init((E, d, f), dtype),
        "w_up": _dense_init((E, d, f), dtype),
        "w_down": _dense_init((E, f, d), dtype, std=out_std),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_gate": _dense_init((d, fs), dtype),
                       "w_up": _dense_init((d, fs), dtype),
                       "w_down": _dense_init((fs, d), dtype, std=out_std)}
    return p


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice top-k MoE with fixed expert capacity.

    Static-shape dispatch: each (token, k) slot computes its rank within
    its expert from a stable argsort; slots past the capacity
    ``C = ceil(T k cf / E)`` are dropped.  Expert compute is a batched
    matmul (E, C, d) x (E, d, f).  Returns (y, aux_loss).
    """
    if is_dtensor(x):
        return _moe_rows(p, cfg, x)
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(math.ceil(T * k * cfg.capacity_factor / E)))
    xt = x.reshape(T, d)
    dev = x.device

    logits = xt.float() @ p["router"]                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, k, dim=-1)                 # (T, k)
    gate = (gate / gate.sum(dim=-1, keepdim=True)).to(x.dtype)

    flat_e = eidx.reshape(-1)                                 # (T*k,)
    slots = torch.arange(T * k, dtype=torch.long, device=dev)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.empty_like(slots)
    pos[order] = slots - start[sorted_e]

    # scatter each kept slot's token into its expert's row; a slot past
    # the capacity is dropped by writing it to a spare column C, which
    # is cut off (JAX's mode="drop", without a host sync on the card)
    table = torch.full((E, C + 1), T, dtype=torch.long, device=dev)
    table[flat_e, torch.clamp(pos, max=C)] = slots // k
    table = table[:, :C]                                      # T = sentinel

    x_ext = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    xe = x_ext[table]                                         # (E, C, d)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
         * torch.einsum("ecd,edf->ecf", xe, p["w_up"]))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"])         # (E, C, d)

    # combine: gather each slot's expert output; dropped slots -> 0
    ye_ext = torch.cat([ye, ye.new_zeros((E, 1, d))], dim=1)  # (E, C+1, d)
    safe_pos = torch.clamp(pos, max=C)
    kept = (pos < C)[:, None].to(ye.dtype)
    y_slot = ye_ext[flat_e, safe_pos] * kept                  # (T*k, d)
    y = (y_slot.reshape(T, k, d) * gate[..., None]).sum(dim=1)

    if cfg.n_shared_experts:
        sp = p["shared"]
        y = y + (F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_up"])) @ sp["w_down"]

    # Switch-style load-balancing auxiliary loss
    density = F.one_hot(eidx, E).float().mean(dim=(0, 1))
    router_mean = probs.mean(dim=0)
    aux = E * (density * router_mean).sum()
    return y.reshape(B, S, d), aux


def _moe_rows(p: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` on a DTensor: each rank routes its own batch
    rows over every expert (the expert weights gathered to it), with the
    capacity of its rows; the aux loss is the mean over ranks."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    row, _ = batch_heads_placements(mesh, x.shape[0], ())
    rep = (Replicate(),) * mesh.ndim
    leaves = leaves_with_paths(p)
    paths = [path for path, _ in leaves]

    def body(x, *ws):
        return apply_moe(_unflatten(paths, ws), cfg, x)

    aux_pl = tuple(Partial("avg") if q.is_shard() else Replicate()
                   for q in row)
    return local_call(body, mesh, (x, *(w for _, w in leaves)),
                      (row,) + (rep,) * len(leaves), (row, aux_pl))


def _unflatten(paths, leaves) -> Params:
    """The nested dict of ``'a/b'`` paths and their leaves."""
    out: Params = {}
    for path, leaf in zip(paths, leaves):
        *outer, name = path.split("/")
        node = out
        for key in outer:
            node = node.setdefault(key, {})
        node[name] = leaf
    return out
