"""Zamba2 in its published form [arXiv:2411.15242; transformers'
``models/zamba2/modeling_zamba2.py``]: a Mamba2 backbone in which
``cfg.hybrid_layer_ids`` are hybrid layers.  At the j-th of them, shared
block ``j % num_mem_blocks`` runs on the concatenation [h, h0] of the
residual stream and the embeddings:

    t = RMSNorm(cat([h, h0]))                       # 2 * d_model wide
    a = softmax(rope(t Wq) rope(t Wk)^T / sqrt(hd / 2) + causal) (t Wv) Wo
    u = RMSNorm(a)
    g, up = split(u Wgu + (u A_j) B_j)              # per-site LoRA adapter
    t = ((gelu(g) * up) Wdown) L_j                  # per-site linear

with no residual of its own; its output enters the Mamba layer before
that layer's pre-norm, and the layer's residual skips it:
``h = h + Mamba(RMSNorm(h + t))``.  Every other layer is the plain
``h = h + Mamba(RMSNorm(h))``.  Every norm takes ``cfg.norm_eps``.

Parameters: ``layers`` stacked on the layer, ``shared`` on the block,
``sites`` on the hybrid layer.  Under remat a hybrid layer (block, site
linear and Mamba layer) is one checkpointed unit.  Training takes the
loss of :class:`~.ssm_lm.MambaLM`; prefill and decode keep a K/V cache
of (B, len, K, hd) per site beside the Mamba states.

While a ``torch.profiler`` records, a site's shared block with its
linear runs inside the range ``zamba.shared`` and its attention core
inside ``zamba.attn`` (forward, recompute and backward).

Built on the card, the model lets the caching allocator grow its
segments in place (:func:`grow_segments`), which its training step at
8 x 4,096 tokens needs on an 80 GB H100.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..core.obs.ranges import device_range
from ..train.remat import maybe_remat
from ..utils import resolve_device
from .blocks import (_INIT_STD, Leaf, LMModule, Params, _dense_init,
                     apply_norm, attention_core, embed_lookup, make_positions,
                     rope, softcap, stack_spec, unstack_layers)
from .ssm import init_mamba, mamba_sequence, mamba_step
from .ssm_lm import MambaLM, layer_state, store_states

__all__ = ["Zamba2LM", "shared_block", "grow_segments"]


def grow_segments(device) -> None:
    """Let the card's caching allocator grow its segments in place (the
    ``expandable_segments`` setting of ``PYTORCH_CUDA_ALLOC_CONF``), for
    the whole process; nothing off the card.  With fixed segments a
    training step of the published form at 8 x 4,096 tokens ran out of
    memory on an 80 GB H100: its float32 logits (4.2 GB) found no free
    block among the layers' freed temporaries, with 28 GB reserved but
    unallocated."""
    if str(device) != "meta" and resolve_device(device).type == "cuda":
        setting = getattr(torch._C, "_accelerator_setAllocatorSettings",
                          torch.cuda.memory._set_allocator_settings)
        setting("expandable_segments:True")


def _norm(d: int, dtype) -> Params:
    return {"scale": Leaf((d,), dtype, "zeros")}     # stores scale - 1


@device_range("zamba.attn")
def _core(q, k, v, q_pos, kv_pos, scale, fused_ok):
    return attention_core(q, k, v, q_pos, kv_pos, causal=True, scale=scale,
                          fused_ok=fused_ok)


def _attention(p: Params, cfg, t: torch.Tensor, positions: torch.Tensor,
               cache, cache_len: int) -> torch.Tensor:
    """The shared attention on ``t`` (B, S, 2 d): without ``cache``
    causal self-attention; with one, the new K/V written at
    ``cache_len`` and the queries attending to the cache's first
    ``cache_len + S`` positions."""
    B, S, _ = t.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd()
    q = rope((t @ p["wq"]).reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope((t @ p["wk"]).reshape(B, S, K, hd), positions, cfg.rope_theta)
    v = (t @ p["wv"]).reshape(B, S, K, hd)
    scale = 1.0 / math.sqrt(hd / 2)
    if cache is None:
        o = _core(q, k, v, positions, positions, scale, True)
    else:
        k_cache, v_cache = cache
        end = cache_len + S
        k_cache[:, cache_len:end] = k
        v_cache[:, cache_len:end] = v
        o = _core(q, k_cache[:, :end], v_cache[:, :end], positions,
                  make_positions(B, end, device=t.device), scale, False)
    return o.reshape(B, S, H * hd) @ p["wo"]


@device_range("zamba.shared")
def shared_block(bp: Params, sp: Params, cfg, h: torch.Tensor,
                 h0: torch.Tensor, positions: torch.Tensor, cache=None,
                 cache_len: int = 0) -> torch.Tensor:
    """Shared block ``bp`` at the site ``sp`` (its adapter and linear):
    what the site adds to the next Mamba layer's input."""
    eps = cfg.norm_eps
    t = apply_norm(bp["attn_norm"], torch.cat([h, h0], dim=-1), "rmsnorm",
                   eps)
    a = _attention(bp["attn"], cfg, t, positions, cache, cache_len)
    u = apply_norm(bp["mlp_norm"], a, "rmsnorm", eps)
    gu = u @ bp["mlp"]["w_gate_up"] + (u @ sp["adapter_a"]) @ sp["adapter_b"]
    g, up = gu.chunk(2, dim=-1)
    t = (F.gelu(g) * up) @ bp["mlp"]["w_down"]
    return t @ sp["linear"]


class Zamba2LM(MambaLM):
    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        if cfg.family != "zamba2":
            raise ValueError(cfg.family)
        ids = tuple(cfg.hybrid_layer_ids)
        if sorted(set(ids)) != list(ids) or not 0 <= ids[0] <= ids[-1] \
                < cfg.n_layers:
            raise ValueError(f"hybrid_layer_ids {ids} for {cfg.n_layers} "
                             f"layers")
        grow_segments(device)
        LMModule.__init__(self, cfg, device, generator)

    # ------------------------------------------------------------------
    def _param_spec(self) -> Params:
        cfg, dt = self.cfg, self.dtype
        d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
        width, kv = cfg.n_heads * cfg.hd(), cfg.n_kv_heads * cfg.hd()
        out_std = _INIT_STD / math.sqrt(2 * cfg.n_layers)
        layer = {"ln": _norm(d, dt), "mamba": init_mamba(cfg, dt)}
        block = {
            "attn_norm": _norm(2 * d, dt),
            "attn": {"wq": _dense_init((2 * d, width), dt),
                     "wk": _dense_init((2 * d, kv), dt),
                     "wv": _dense_init((2 * d, kv), dt),
                     "wo": _dense_init((width, d), dt, std=out_std)},
            "mlp_norm": _norm(d, dt),
            "mlp": {"w_gate_up": _dense_init((d, 2 * f), dt),
                    "w_down": _dense_init((f, d), dt, std=out_std)},
        }
        site = {"adapter_a": _dense_init((d, r), dt),
                "adapter_b": _dense_init((r, 2 * f), dt),
                "linear": _dense_init((d, d), dt)}
        return {
            "embed": _dense_init((cfg.vocab, d), dt),
            "final_norm": _norm(d, dt),
            "layers": stack_spec(layer, (cfg.n_layers,)),
            "shared": stack_spec(block, (cfg.num_mem_blocks,)),
            "sites": stack_spec(site, (cfg.n_sites(),)),
        }

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        h = apply_norm(params["final_norm"], h, "rmsnorm", self.cfg.norm_eps)
        return softcap((h @ params["embed"].T).float(),
                       self.cfg.logit_softcap)

    # ------------------------------------------------------------------
    def _forward(self, params, x, states, *, caches=None, cache_len=0,
                 step=False):
        """Every layer from ``states`` (stacked on L; an SSM state of None
        is a fresh start) on the embeddings ``x``; returns the hidden
        states and each Mamba layer's new state.  With ``caches`` each
        site's K/V are written into its cache (in place)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        B, S, _ = x.shape
        positions = make_positions(B, S, offset=cache_len, device=x.device)
        mixer = mamba_step if step else mamba_sequence
        site_of = {i: j for j, i in enumerate(cfg.hybrid_layer_ids)}

        def plain_layer(lp, h, st):
            y, st_new = mixer(lp["mamba"], cfg,
                              apply_norm(lp["ln"], h, "rmsnorm", eps), st,
                              norm_eps=eps)
            return h + y, st_new

        def hybrid_layer(bp, sp, lp, h, h0, st, cache):
            t = shared_block(bp, sp, cfg, h, h0, positions, cache, cache_len)
            y, st_new = mixer(lp["mamba"], cfg,
                              apply_norm(lp["ln"], h + t, "rmsnorm", eps),
                              st, norm_eps=eps)
            return h + y, st_new

        plain_layer = maybe_remat(plain_layer)
        hybrid_layer = maybe_remat(hybrid_layer)
        layers = unstack_layers(params["layers"])
        blocks = unstack_layers(params["shared"])
        sites = unstack_layers(params["sites"])
        h, new_states = x, []
        for i, lp in enumerate(layers):
            st = layer_state(states, i)
            j = site_of.get(i)
            if j is None:
                h, st_new = plain_layer(lp, h, st)
            else:
                cache = (None if caches is None
                         else (caches["k"][j], caches["v"][j]))
                h, st_new = hybrid_layer(blocks[j % cfg.num_mem_blocks],
                                         sites[j], lp, h, x, st, cache)
            new_states.append(st_new)
        return h, new_states

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        shape = (cfg.n_sites(), batch, max_len, cfg.n_kv_heads, cfg.hd())
        return dict(self._stacked_states(batch),
                    k=torch.zeros(shape, dtype=self.dtype, device=self.device),
                    v=torch.zeros(shape, dtype=self.dtype, device=self.device),
                    len=0)

    @torch.no_grad()
    def prefill(self, batch, max_len: Optional[int] = None):
        params = self.params()
        tokens = batch["tokens"]
        B, S = tokens.shape
        cache = self.init_cache(B, max_len or S)
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        h, new_states = self._forward(params, x, dict(cache, ssm=None),
                                      caches=cache)
        for i, st in enumerate(new_states):
            store_states(cache, i, st)
        cache["len"] = S
        return self._logits(params, h[:, -1:, :])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens, cache):
        """One decode step.  tokens: (B, 1).  The cache's tensors are
        updated in place; the returned dict holds them with ``len`` + 1."""
        params = self.params()
        pos = int(cache["len"])
        x = embed_lookup(params["embed"], tokens).to(self.dtype)
        h, new_states = self._forward(params, x, cache, caches=cache,
                                      cache_len=pos, step=True)
        for i, st in enumerate(new_states):
            store_states(cache, i, st)
        return self._logits(params, h)[:, 0], dict(cache, len=pos + 1)
